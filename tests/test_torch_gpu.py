"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; skipped where ``torch.cuda.is_available()`` is false.  This
file imports only ``torch`` and ``rt_torch``, so on a machine with a card it
runs without the JAX package's test harness:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import pytest
import torch

from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes as tscenes

TIME = 1000


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_bitwise():
    """On a card: K2 and K3 launched through their wrappers against the
    plain versions on the same CUDA tensors.  Tolerance: none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_suzanne(128, 128, device="cuda")
    kw = tdispatch.wave_params(sd.scene, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    order = ttk.chunk_order(packed.centroid,
                            torch.from_numpy(cam_row[0, 0:3].copy()).cuda())
    times = torch.tensor([TIME], dtype=torch.int32, device="cuda")
    args = dict(height=128, width=128, height_pad=128, width_pad=128, th=th,
                tw=tw, normalize_defocus_dir=True)
    before = dict(ttk.LAUNCHES)
    k = ttk.wave_first(packed, order, cam_row, times, 0, flags, **args)
    p = ttk.wave_first_plain(packed, order, cam_row, times, 0, flags, **args)
    assert ttk.LAUNCHES["wave_first"] == before["wave_first"] + 1
    for a, b in zip(k, p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    n_tiles = 128 * 128 // (th * tw)
    mo = k[0][0:3].reshape(3, n_tiles, th * tw).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    ins = [(k[0][0:9].clone(), k[1].clone(), k[2].clone()) for _ in range(2)]
    kw_ = ttk.wave_bounce(packed, tile_order, *ins[0], flags, n_bounces=2,
                          th=th, tw=tw)
    pw_ = ttk.wave_bounce_plain(packed, tile_order, *ins[1], flags,
                                n_bounces=2, th=th, tw=tw)
    assert ttk.LAUNCHES["wave_bounce"] == before["wave_bounce"] + 1
    for a, b in zip((*ins[0], kw_), (*ins[1], pw_)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
