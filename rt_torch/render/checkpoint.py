"""Checkpoint and resume for progressive renders and inverse-rendering runs
— counterpart of ``rt/render/checkpoint.py``.

A progressive render is resumable by construction: pausing and resuming
needs only {image, frame_count, time}.  ``save_render_state`` writes them
to one ``.npz`` with the JAX package's keys (``image`` f32 (H, W, 3),
``frame_count``, ``time`` u32), so a checkpoint written by either package
loads in the other.

``save_pytree`` / ``load_pytree`` cover a training run: nested dicts,
lists, tuples and NamedTuples of tensors, arrays and Python numbers, a
``torch.optim`` state dict among them.  Leaves are saved in flatten order
(dict keys sorted, ``None`` holds no leaf); the structure comes back from
an example tree, as in the JAX package.  Every write goes to a temporary
file first and then replaces the target, so an interrupted write leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rt_torch.render.renderer import RenderState


def _atomic_savez(path: str, **payload) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float, complex, str))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flatten order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"not a tree node or leaf: {type(tree)}")


def tree_unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` (in flatten order) in place of
    its leaves."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}          # the caller's key order
        values = [rebuild(v) for v in node]
        if hasattr(node, "_fields"):                  # NamedTuple
            return type(node)(*values)
        return type(node)(values)

    out = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the example tree holds")
    return out


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(value: np.ndarray, like):
    """A loaded array as the kind of leaf ``like`` is: a tensor on its
    device with its dtype, or a Python number or string."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(device=like.device,
                                                    dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(value, like.dtype).reshape(np.shape(like))
    return type(like)(value.item())


def save_pytree(path: str, tree) -> None:
    """Write the leaves of ``tree`` to one ``.npz`` (``leaf_0``, ...)."""
    _atomic_savez(path, **{f"leaf_{i}": _to_numpy(x)
                           for i, x in enumerate(tree_leaves(tree))})


def load_pytree(path: str, like):
    """Leaves saved by ``save_pytree`` back into the structure of ``like``;
    each leaf takes the kind, device and dtype of ``like``'s leaf."""
    examples = tree_leaves(like)
    with np.load(path) as z:
        if len(z.files) != len(examples):
            raise ValueError(f"{path} holds {len(z.files)} leaves, the "
                             f"example tree {len(examples)}")
        leaves = [_like(z[f"leaf_{i}"], x) for i, x in enumerate(examples)]
    return tree_unflatten(like, leaves)


def save_render_state(path: str, state: RenderState, time: int) -> None:
    """Persist a paused progressive render (image, frame_count, time)."""
    _atomic_savez(path, image=state.image.detach().cpu().numpy(),
                  frame_count=np.uint32(state.frame_count),
                  time=np.uint32(time))


def load_render_state(path: str, device="cuda"):
    """-> (RenderState on ``device``, time).  Resume a ProgressiveRenderer
    by assigning ``.state`` and calling ``.set_time(time)``."""
    with np.load(path) as z:
        image = torch.from_numpy(np.asarray(z["image"], np.float32)).to(
            device)
        state = RenderState(image=image, frame_count=int(z["frame_count"]))
        time = int(z["time"])
    return state, time
