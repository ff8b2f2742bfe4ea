"""BASELINE config 5, camera clause, in the port: pose and albedo recovery
on Suzanne at 1920x1080 — counterpart of ``tools/exp_config5_pose.py``.

    python -m rt_torch.config5 [--size 1920x1080] [--soft-scale 4]
        [--fine-scale 2] [--soft-steps 240] [--fine-steps 150]
        [--ultra-steps 80] [--polish-steps 24] [--spp 4] [--lr 4e-3]
        [--taus 0.02,0.008,0.003,0.0012] [--dtheta 2] [--dphi 1]
        [--dfov 0.02] [--dradius 0] [--device cuda]

1. target: the exact render at the TRUE pose through the kernels, at
   ``--spp`` samples (the raygen kernel, then the bounce kernel from bounce
   0), and a same-seed 1-sample observation (the fused first kernel, then
   the bounce kernel) for the material fit;
2. perturbation: orbit-camera increments (``--dtheta``/``--dphi`` degrees,
   ``--dfov`` radians, optionally ``--dradius``) and material 0's albedo
   set to (0.55, 0.25, 0.35);
3. soft pose stages: annealed recovery in orbit coordinates on the
   triangle surrogate (``grad.soft_tris``) with the image-gradient loss,
   ``grad_pool=2`` and rays through the full-resolution sample positions:
   at 1/``--soft-scale`` of the size (chunk 128), at 1/``--fine-scale``
   (chunk 64), and at the full size (chunk 32);
4. polish: ``fit_replay`` of the albedos at the full size, at the
   recovered pose, against the 1-sample observation with an
   edge-downweighted loss (the whole-frame recorder: Suzanne has fewer
   than 8192 triangles).

Prints the pose errors before and after (theta, phi in degrees, fov in
radians, the eye's angle), the albedo error per material, the seconds of
each stage, and last one JSON line with all of them.  ``run`` returns that
dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time as time_mod

import numpy as np
import torch

from rt_torch.grad.params import host_camera, look_at
from rt_torch.grad.soft_tris import OrbitParams, downsample, recover_orbit_tris
from rt_torch.grad.train import fit_replay
from rt_torch.kernels import dispatch, tris_kernel
from rt_torch.scene import scenes

LOOK_TARGET = (0.0, 0.0, -4.5)     # the Suzanne scene's camera target
BAD_ALBEDO = (0.55, 0.25, 0.35)    # material 0's corrupted albedo
TIME = 1000


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", default="1920x1080")
    p.add_argument("--soft-scale", type=int, default=4)
    p.add_argument("--dtheta", type=float, default=2.0, help="degrees")
    p.add_argument("--dphi", type=float, default=1.0, help="degrees")
    p.add_argument("--dfov", type=float, default=0.02, help="radians")
    p.add_argument("--dradius", type=float, default=0.0,
                   help="radius perturbation (scene units); nonzero adds "
                        "'radius' to the optimised fields")
    p.add_argument("--soft-steps", type=int, default=240)
    p.add_argument("--fine-scale", type=int, default=2,
                   help="second soft stage at this downsample factor "
                        "(0 disables)")
    p.add_argument("--fine-steps", type=int, default=150)
    p.add_argument("--ultra-steps", type=int, default=80,
                   help="full-size soft refinement steps (0 disables)")
    p.add_argument("--polish-steps", type=int, default=24)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--taus", default="0.02,0.008,0.003,0.0012")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def eye_angle_deg(eye_a, eye_b, target) -> float:
    va = np.asarray(eye_a, np.float64) - target
    vb = np.asarray(eye_b, np.float64) - target
    c = np.dot(va, vb) / (np.linalg.norm(va) * np.linalg.norm(vb))
    return float(np.rad2deg(np.arccos(np.clip(c, -1.0, 1.0))))


def expected_launches(bounces: int, spp: int, polish_steps: int,
                      rerecord_every: int) -> dict:
    """Kernel launches of one run on a small mesh (the wave path's
    ``chunk_oct`` schedule: a sort every 2 bounces, none before the last
    launch): the spp > 1 target is one raygen and, per sample, the bounce
    kernel's launches from bounce 0; the 1-sample one the fused first
    kernel and the launches from bounce 1; the polish one whole-frame
    record every ``rerecord_every`` steps and one replay kernel a step."""
    per = lambda start: len(tris_kernel.bounce_schedule(bounces, 2, True,
                                                        start))
    out = {"wave_raygen": 0, "wave_first": 1, "wave_bounce": per(1),
           "tris_record": -(-polish_steps // rerecord_every),
           "replay_loss": polish_steps}
    if spp > 1:
        out["wave_raygen"] = 1
        out["wave_bounce"] += spp * per(0)
    else:
        out["wave_first"] += 1
        out["wave_bounce"] += per(1)
    return out


def edge_weight(target, h: int, w: int):
    """(h, w) 0/1 loss weight of the polish: 0 on a 4x4 block next to a
    step above 0.06 in the 4x-pooled target (a ~1 px pose residual
    concentrates the mismatch in silhouette bands; interiors alone
    identify an albedo)."""
    tp = downsample(target, 4)
    ex = torch.abs(tp[:, 1:] - tp[:, :-1]).amax(dim=-1)
    ey = torch.abs(tp[1:] - tp[:-1]).amax(dim=-1)
    e = torch.zeros(tp.shape[:2], dtype=torch.float32, device=tp.device)
    e[:, 1:] = torch.maximum(e[:, 1:], ex)
    e[:, :-1] = torch.maximum(e[:, :-1], ex)
    e[1:] = torch.maximum(e[1:], ey)
    e[:-1] = torch.maximum(e[:-1], ey)
    smooth = (e < 0.06).to(torch.float32)
    return smooth.repeat_interleave(4, 0).repeat_interleave(4, 1)[:h, :w]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    dev = args.device
    w, h = (int(v) for v in args.size.lower().split("x"))
    sd = scenes.scene_suzanne(w, h, device=dev)
    cfg = dataclasses.replace(sd.config, samples_per_frame=args.spp)
    cfg1 = dataclasses.replace(cfg, samples_per_frame=1)
    look_target = np.array(LOOK_TARGET, np.float32)
    true_eye = np.asarray(sd.camera.eye[:3], np.float32)
    fl, blur = float(sd.camera.focal_length), float(sd.camera.focal_blur)
    true_op = OrbitParams.from_eye(true_eye, look_target,
                                   float(sd.camera.fov), device=dev)
    seconds = {}

    # 1. the exact target at the true pose, and the 1-sample observation
    t0 = time_mod.perf_counter()
    with torch.no_grad():
        target = dispatch.render_color(sd.scene, sd.camera, cfg, TIME, dev)
        target1 = dispatch.render_color(sd.scene, sd.camera, cfg1, TIME, dev)
    _sync(dev)
    seconds["target"] = time_mod.perf_counter() - t0
    print(f"target renders: {seconds['target']:.1f}s", flush=True)

    # 2. perturbed pose (orbit increments) and albedo
    init_op = OrbitParams.create(
        float(true_op.radius) + args.dradius,
        float(true_op.theta) + np.deg2rad(args.dtheta),
        float(true_op.phi) + np.deg2rad(args.dphi),
        float(true_op.fov) + args.dfov, device=dev)
    fields = ("theta", "phi", "fov") + (("radius",) if args.dradius else ())
    true_alb = sd.scene.mat_albedo
    bad_alb = true_alb.clone()
    bad_alb[0] = bad_alb.new_tensor(BAD_ALBEDO)
    bad_scene = sd.scene._replace(mat_albedo=bad_alb)

    def op_errors(op):
        dt = abs(float(op.theta) - float(true_op.theta))
        dp = abs(float(op.phi) - float(true_op.phi))
        df = abs(float(op.fov) - float(true_op.fov))
        dr = abs(float(op.radius) - float(true_op.radius))
        eye = op.to_camera_params(look_target, fl, blur).eye
        ang = eye_angle_deg(eye.detach().cpu().numpy(), true_eye,
                            look_target)
        return dict(theta_deg=float(np.rad2deg(dt)),
                    phi_deg=float(np.rad2deg(dp)), fov_rad=df,
                    radius=dr, eye_angle_deg=ang)

    e0 = op_errors(init_op)
    err_alb0 = float(torch.abs(bad_alb - true_alb).max())
    print(f"perturbation: dtheta {e0['theta_deg']:.3f} deg, dphi "
          f"{e0['phi_deg']:.3f} deg, dfov {e0['fov_rad']:.4f} rad, dradius "
          f"{e0['radius']:.3f}, eye angle {e0['eye_angle_deg']:.3f} deg, "
          f"albedo {err_alb0:.3f}", flush=True)

    # 3. soft pose stages: coarse, fine, full size
    taus = tuple(float(v) for v in args.taus.split(","))
    common = dict(focal_length=fl, focal_blur=blur, optimize_fields=fields,
                  loss_mode="grad", grad_pool=2, full_res=(h, w))
    stages = [("soft", args.soft_scale, args.soft_steps, args.lr, taus, 128)]
    if args.fine_scale:
        stages.append(("fine", args.fine_scale, args.fine_steps,
                       args.lr * 0.4, (0.0025, 0.001, 0.0005), 64))
    if args.ultra_steps:
        stages.append(("ultra", 1, args.ultra_steps, args.lr * 0.15,
                       (0.001, 0.0004), 32))
    rec_op, losses = init_op, []
    for name, f, steps, lr, stage_taus, chunk in stages:
        if not steps:
            continue
        t0 = time_mod.perf_counter()
        stage_cfg = dataclasses.replace(cfg, width=w // f, height=h // f)
        stage_target = downsample(target, f) if f > 1 else target
        rec_op, stage_losses = recover_orbit_tris(
            bad_scene, stage_cfg, stage_target, rec_op, look_target,
            steps=steps, learning_rate=lr, taus=stage_taus, chunk=chunk,
            log_every=max(1, steps // (len(stage_taus) * 2)), **common)
        _sync(dev)
        seconds[name] = time_mod.perf_counter() - t0
        losses += stage_losses
        print(f"{name} stage at {w // f}x{h // f}: {seconds[name]:.1f}s, "
              f"{len(stage_losses)} steps", flush=True)

    e1 = op_errors(rec_op)
    ratio = lambda a, b: a / max(b, 1e-9)
    print(f"soft stages ({sum(seconds.get(s[0], 0.0) for s in stages):.1f}s"
          f", {len(losses)} steps, loss {losses[0]:.3e} -> "
          f"{losses[-1]:.3e}):", flush=True)
    for k, unit in (("theta_deg", "deg"), ("phi_deg", "deg"),
                    ("fov_rad", "rad"), ("eye_angle_deg", "deg")):
        print(f"  {k}: {e0[k]:.4f} -> {e1[k]:.5f} {unit} "
              f"({ratio(e0[k], e1[k]):.1f}x)", flush=True)

    # 4. replay polish of the albedos at the full size, recovered pose
    lw = edge_weight(target, h, w)
    print(f"polish edge mask keeps {float(lw.mean()):.3f} of pixels",
          flush=True)
    with torch.no_grad():
        rec_camera = host_camera(look_at(rec_op.to_camera_params(
            look_target, fl, blur)))
    rerecord_every = 8
    t0 = time_mod.perf_counter()
    params, plosses = fit_replay(
        bad_scene, rec_camera, cfg1, target1, steps=args.polish_steps,
        rerecord_every=rerecord_every, learning_rate=5e-2, loss_weight=lw,
        device=dev)
    _sync(dev)
    seconds["polish"] = time_mod.perf_counter() - t0
    fin_alb = params["scene"].mat_albedo
    err_alb1 = float(torch.abs(fin_alb - true_alb).max())
    per_mat = torch.abs(fin_alb - true_alb).amax(dim=1).tolist()
    print("  per-material albedo err: "
          + " ".join(f"{v:.4f}" for v in per_mat), flush=True)
    print(f"replay polish ({seconds['polish']:.1f}s, {args.polish_steps} "
          f"steps at {w}x{h}, loss {plosses[0]:.3e} -> {plosses[-1]:.3e}):",
          flush=True)
    print(f"  albedo max err: {err_alb0:.3f} -> {err_alb1:.4f} "
          f"({ratio(err_alb0, err_alb1):.1f}x)", flush=True)

    pose_ok = all(e1[k] <= e0[k] / 10
                  for k in ("theta_deg", "phi_deg", "fov_rad"))
    all_losses = losses + plosses
    return dict(
        size=[w, h], spp=args.spp, triangles=sd.scene.m,
        bounces=cfg.bounces,
        steps=dict(soft=args.soft_steps, fine=args.fine_steps,
                   ultra=args.ultra_steps, polish=args.polish_steps),
        before=e0, after=e1,
        reduction={k: ratio(e0[k], e1[k])
                   for k in ("theta_deg", "phi_deg", "fov_rad",
                             "eye_angle_deg")},
        albedo_err_before=err_alb0, albedo_err_after=err_alb1,
        albedo_reduction=ratio(err_alb0, err_alb1),
        albedo_err_per_material=per_mat,
        soft_loss_first=losses[0], soft_loss_last=losses[-1],
        polish_loss_first=plosses[0], polish_loss_last=plosses[-1],
        losses_finite=all(math.isfinite(v) for v in all_losses),
        all_three_10x=pose_ok, seconds=seconds,
        expected_launches=expected_launches(cfg.bounces, args.spp,
                                            args.polish_steps,
                                            rerecord_every))


def main(argv=None) -> int:
    result = run(parse_args(argv))
    print(f"config5 camera clause: theta+phi+fov all >=10x reduced: "
          f"{result['all_three_10x']}; albedo "
          f"{result['albedo_reduction']:.1f}x", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
