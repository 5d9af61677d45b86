"""The weights-and-state bridge between the JAX package and this one.

Both packages keep cell states as the same nested dicts, so a state made
by the JAX package, turned into numpy arrays (``jax.tree.map(np.asarray,
...)``), maps leaf for leaf onto this package's state.  bfloat16 crosses
as its bit pattern: numpy has no native bfloat16, so a bf16 leaf arrives
as an ``ml_dtypes`` array and becomes a ``torch.bfloat16`` tensor with
the same bits; going back, ``tree_to_numpy`` hands bf16 out as ``uint16``
words.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.executor import resolve_device
from .models.config import ModelConfig
from .tree import tree_flatten, tree_map, tree_paths, tree_unflatten


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    c = np.ascontiguousarray(a).reshape(a.shape)  # ascontiguousarray makes a 0-d array 1-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(c.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(c.copy()).to(device)


def states_from_numpy(tree, device="cuda"):
    """numpy tree (whole program states, or any part) -> tensor tree on
    ``device``, bf16 bits preserved."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def tree_to_numpy(tree):
    """tensor tree -> numpy tree on the host; bf16 leaves become their
    ``uint16`` bit patterns (numpy cannot hold bf16 without ml_dtypes)."""

    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return tree_map(conv, tree)


#: parameter leaves the models keep in f32 whatever the compute dtype
#: (the Mamba2 decay, step bias and skip, and the MoE router, as in the
#: JAX package)
F32_PARAMS = ("a_log", "dt_bias", "d_skip", "router")


def params_from_numpy(cfg: ModelConfig, tree, device="cuda") -> dict:
    """The JAX params tree (numpy leaves) as this package's params, every
    floating leaf in ``cfg.compute_dtype`` except ``F32_PARAMS``, which
    stay f32.  Checks the tree has the layout this package's model reads."""
    params = states_from_numpy(tree, device)
    want = {"embed", "final_norm", "segments"} | (set() if cfg.tie_embeddings else {"lm_head"})
    if cfg.mtp:
        want |= {"mtp_proj", "mtp_norm"}
    if cfg.shared_attn_every and cfg.mixer_type == "mamba2":
        want |= {"shared_attn"}
    if set(params) != want:
        raise ValueError(f"params keys {sorted(params)} != {sorted(want)}")
    d, V, K = cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    shapes = {"embed": (K, V, d) if K > 1 else (V, d)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (K, d, V) if K > 1 else (d, V)
    for key, want_shape in shapes.items():
        if tuple(params[key].shape) != want_shape:
            raise ValueError(f"{key} shape {tuple(params[key].shape)} != {want_shape}")
    paths = tree_paths(params)
    leaves, treedef = tree_flatten(params)
    dt = cfg.compute_dtype
    out = [
        t if not t.is_floating_point() else t.float() if path[-1] in F32_PARAMS else t.to(dt)
        for path, t in zip(paths, leaves)
    ]
    return tree_unflatten(treedef, out)
