"""The comparison that decides ``correct``: what the window's entry
produced, against the plain reference at the same sizes, and the numbers
it gives, each beside its limit (``benchmark/limits/<cell>.json``).

- Images: the sampled pixels (drawn from the seed) of the images the
  window read back: every request of a progressive window folds into one
  image, all of whose frames the reference traces again and folds with
  the same weights; of a window of converged images, the last one and one
  drawn from the seed.  ``image_rel_l1`` = sum |program - reference| /
  sum |reference| over those pixels and channels, the worst image.
- A fit: the window's last whole fit, both of its records included,
  against the reference's (``reference.fit``) from the same start, which
  records anew at the same steps: the largest relative gap of a step's
  loss over all the steps (``loss_gap``); the gap between the norms of the
  first gradient (``grad_gap``), of the parameters' change after the third
  step (``change_gap``) and of the recovered albedo's change after the
  last step (``final_gap``), each over the reference's norm.

A number that is not finite fails.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from benchmark.reference import fit as ref_fit
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer

# frames the reference traces at once when it folds a window's image
FRAMES_PER_BLOCK = 256


def sample_pixels(seed: int, width: int, height: int, n: int):
    """(ys, xs): ``n`` distinct pixels drawn from the seed."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(width * height, size=min(n, width * height),
                      replace=False)
    return flat // width, flat % width


def reference_scene(config: dict, root: str, device, dt, chunks=False):
    if config["kind"] == "triangles":
        tris = ref_scene.triangles(config, root)
        return tracer.Triangles(
            tris, device, dt,
            ref_scene.morton_chunks(tris) if chunks else None)
    return tracer.Spheres(ref_scene.spheres(config), device, dt)


def _rel_l1(prog, ref) -> float:
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(prog - ref).sum() / np.abs(ref).sum())


def reference_images(config, traffic, rec, requests, pixels, root, device,
                     dt=torch.float32) -> dict:
    """request index -> (P, 3) reference image at the sampled pixels."""
    scene = reference_scene(config, root, device, dt)
    cam = ref_scene.camera_row(ref_scene.look_at(config["camera"]))
    ys, xs = (torch.as_tensor(v, device=device) for v in pixels)
    kw = dict(height=traffic["height"], width=traffic["width"],
              spp=traffic.get("spp", 1), bounces=config["bounces"], dt=dt)
    t0, step, f = rec["time0"], rec["time_step"], rec["frames_per_request"]
    out = {}
    for i in requests:
        if rec["reset"]:
            first, n = rec["first_frame"][i], f
        else:
            first, n = 0, rec["frames"]
        cols = []
        for lo in range(first, first + n, FRAMES_PER_BLOCK):
            k = range(lo, min(first + n, lo + FRAMES_PER_BLOCK))
            times = [(t0 + step * j) & tracer.MASK for j in k]
            cols.append(tracer.render(scene, cam, xs, ys, times, **kw))
        out[i] = tracer.ema(torch.cat(cols)).float().cpu().numpy()
    return out


def compared_requests(rec: dict, seed: int) -> list:
    """The requests whose images are compared."""
    last = rec["requests"] - 1
    if not rec["reset"] or last < 1:
        return [last]
    drawn = int(np.random.default_rng(seed + 1).integers(0, last))
    return [drawn, last]


def check_render(config, traffic, rec, seed, pixels, root, device,
                 program_images=None) -> dict:
    """{"image_rel_l1": worst relative L1 over the compared images}.
    program_images: what is judged, by request (the window's by default;
    the control puts the reference at a lower precision there)."""
    req = compared_requests(rec, seed)
    ref = reference_images(config, traffic, rec, req, pixels, root, device)
    prog = program_images or rec["images"]
    return {"image_rel_l1": max(_rel_l1(prog[i], ref[i]) for i in req)}


def fit_start(config: dict, traffic: dict) -> np.ndarray:
    """The fit's starting albedo table: the configuration's, with the
    traffic's wrong rows."""
    albedo = np.stack([ref_scene.material(m["material"])[0]
                       for m in config["meshes"]]).astype(np.float32)
    for row, rgb in traffic["wrong_albedo"].items():
        albedo[int(row)] = np.asarray(rgb, np.float32)
    return albedo


def reference_fit(config, traffic, time, root, device, dt=torch.float32,
                  counts=None, rows=None):
    """(losses, first gradient, parameters after step 3, parameters after
    the last step) of the reference's whole fit.  ``rows``: the loss over
    the first so many pixels only (a fault that leaves part of the batch
    out); ``counts`` collects the first record's work."""
    scene = reference_scene(config, root, device, dt,
                            chunks=counts is not None)
    cam = ref_scene.camera_row(ref_scene.look_at(config["camera"]))
    kw = dict(width=traffic["width"], height=traffic["height"],
              bounces=config["bounces"], time=time, dt=dt)
    target, _, _ = ref_fit.record(scene, cam, **kw)
    first = [counts]

    def record(albedo):
        scene.albedo = albedo.detach().to(dt)
        _, mats, dy = ref_fit.record(scene, cam, counts=first.pop()
                                     if first else None, **kw)
        n = dy.shape[0] if rows is None else rows
        return mats[:, :n], dy[:n]

    albedo0 = torch.as_tensor(fit_start(config, traffic),
                              device=device).to(dt)
    return ref_fit.fit(albedo0, record, target,
                       learning_rate=traffic["learning_rate"],
                       steps=traffic["steps"],
                       rerecord_every=traffic["rerecord_every"])


def _gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def fit_numbers(prog, ref, albedo0) -> dict:
    """The fit's four numbers from the program's (losses, first gradient,
    parameters after step 3, after the last step) and the reference's."""
    losses, g, p3, pn = prog
    r_losses, r_g, r_p3, r_pn = ref
    a0 = torch.as_tensor(albedo0, dtype=torch.float64)
    norm = lambda x: float(torch.linalg.vector_norm(
        torch.as_tensor(x).double().cpu()))
    change = lambda p: norm(torch.as_tensor(p).double().cpu() - a0)
    return {
        "loss_gap": (max(_gap(a, b) for a, b in zip(losses, r_losses))
                     if len(losses) == len(r_losses) else math.inf),
        "grad_gap": _gap(norm(g), norm(r_g)),
        "change_gap": _gap(change(p3), change(r_p3)),
        "final_gap": _gap(change(pn), change(r_pn)),
    }


def check_fit(config, traffic, rec, time, root, device, counts=None,
              program=None) -> dict:
    """The fit's numbers of the window's last fit (or of ``program``, a
    reference at a lower precision put in its place)."""
    last = rec["last_fit"]
    prog = program or (last["losses"], last["grad1"][0], last["p3"][0],
                       last["final"])
    ref = reference_fit(config, traffic, time, root, device, counts=counts)
    return fit_numbers(prog, ref, fit_start(config, traffic))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def load_limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]
