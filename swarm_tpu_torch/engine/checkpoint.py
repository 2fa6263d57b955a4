"""Checkpoint / resume of the port's state trees (swarm_tpu/engine/
checkpoint.py): a checkpoint is one flat .npz of the tree's leaves.

Keys are the JAX package's key paths (`jax.tree_util.keystr`: `.field`
for a NamedTuple field, `['k']` for a dict key, `[i]` for a sequence
index), so a checkpoint of a `ServerState` or `MapState` written by either
package loads into the other, and a layout change fails loudly on load
rather than misassigning leaves. A bfloat16 leaf is stored as its 16-bit
pattern (numpy dtype `V2`), the bytes the JAX package writes for it.

The port's `SimState` carries no PRNG key (noise comes from the caller's
`torch.Generator`): a JAX checkpoint's `.key` leaf is ignored on load, and
`save_pytree(..., generator=g)` stores the generator's state instead (leaf
`generator`, restored by `load_generator`), so a resumed rollout draws
what the uninterrupted one would have drawn.
"""

from __future__ import annotations

import numpy as np
import torch

GENERATOR_KEY = "generator"


def _paths(tree, prefix=""):
    """[(key path, leaf)] in the JAX package's flattening order."""
    if hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _paths(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}[{i}]")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves replaced from the iterator."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        v = leaf.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(leaf)


def _dtype_of(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype("V2")
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _to_leaf(arr: np.ndarray, tmpl):
    if not isinstance(tmpl, torch.Tensor):
        return arr
    if tmpl.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.reshape(tmpl.shape).to(tmpl.device)


def save_pytree(path: str, tree, generator: torch.Generator = None) -> str:
    """Write a tree of tensors (NamedTuples, dicts, sequences) to one .npz;
    with `generator`, its state too."""
    data = {k: _to_numpy(v) for k, v in _paths(tree)}
    if generator is not None:
        data[GENERATOR_KEY] = generator.get_state().numpy()
    np.savez_compressed(path, **data)
    return path


def load_generator(path: str, generator: torch.Generator) -> torch.Generator:
    """Restore `generator` from the state `save_pytree` stored."""
    data = np.load(path)
    if GENERATOR_KEY not in data.files:
        raise ValueError(f"{path} holds no generator state")
    generator.set_state(torch.from_numpy(data[GENERATOR_KEY].copy()))
    return generator


# Schema migrations for checkpoints written by older engine layouts, keyed
# by the key-path SUFFIX of the affected leaf (the JAX package's table):
#   - "zero": leaf added after the checkpoint was written; filled with
#     zeros (correct for accumulators starting fresh);
#   - "neg_ones": filled with -1;
#   - "template": the freshly initialised template leaf;
#   - a callable (old_array, template_array) -> new_array.
def _migrate_total_writes(old, tmpl):
    """r1 scalar float32 counter -> r2 (hi, lo) int32 pair."""
    if old.shape == tmpl.shape:
        return old
    total = int(old)                      # r1 counter was float32 scalar
    radix = 1 << 30
    return np.asarray([total // radix, total % radix], np.int32)


def _migrate_lm_scan(old, tmpl):
    """lm_scan capacity follows closure_scanmatch ([L, 1] placeholder vs
    [L, R]): crossing configs keeps what fits and zero-fills the rest."""
    if old.shape == tmpl.shape:
        return old
    out = np.zeros(tmpl.shape, tmpl.dtype)
    r = min(old.shape[1], tmpl.shape[1])
    n = min(old.shape[0], tmpl.shape[0])
    out[:n, :r] = old[:n, :r]
    return out


_MIGRATIONS = {
    ".srv.total_writes": _migrate_total_writes,
    ".srv.merge_dx": "zero",
    ".srv.merge_dy": "zero",
    ".srv.merge_dyaw": "zero",
    ".srv.anchor": "zero",
    ".v2v_total": "zero",
    # scan-matched closure measurements (SlamConfig.closure_scanmatch)
    ".srv.closure.lm_yaw": "zero",
    ".srv.closure.lm_scan": _migrate_lm_scan,
    ".srv.closure.cl_mx": "zero",
    ".srv.closure.cl_my": "zero",
    ".srv.closure.cl_mth": "zero",
    # -1 = "unmeasured edge" sentinel, not zero
    ".srv.closure.cl_fit": "neg_ones",
    # merge-recovery escalation counter (SlamConfig.merge_recover_after)
    ".srv.merge_fail": "zero",
    # online yaw-rate-bias estimator (SlamConfig.merge_bias_alpha)
    ".srv.merge_yaw_rate": "zero",
    ".srv.merge_dist_mark": "zero",
    # online frame tracker (SlamConfig.merge_frame_gain)
    **{f".srv.frame.{f}": "zero"
       for f in ("theta", "scale_dev", "rate", "px", "py", "ax", "ay",
                 "lx", "ly", "qy", "nacc", "dacc", "sacc", "gskip")},
    # proximity-pair rendezvous cooldown: fresh init is "fire immediately"
    ".srv.closure.last_pair_node": "template",
}


def load_pytree(path: str, template, migrate: bool = True):
    """Load into the structure of `template` (shapes and dtypes validated),
    each leaf on its template leaf's device.

    migrate=True applies the known schema shims (_MIGRATIONS) for leaves
    an older checkpoint lacks or stores in a superseded layout; anything
    outside the registry fails loudly. Leaves the template lacks (a JAX
    `SimState`'s `.key`, the generator state) are not read."""
    data = np.load(path)
    pairs = _paths(template)

    def shim_for(k):
        if not migrate:
            return None
        for suffix, m in _MIGRATIONS.items():
            if k.endswith(suffix):
                return m
        return None

    missing = [k for k, _ in pairs
               if k not in data.files and shim_for(k) is None]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}")
    leaves = []
    for k, tmpl in pairs:
        t = _to_numpy(tmpl)
        shim = shim_for(k)
        if k not in data.files:
            if shim == "template":
                leaves.append(_to_leaf(np.array(t, copy=True), tmpl))
                continue
            fill = -1 if shim == "neg_ones" else 0
            leaves.append(_to_leaf(np.full(t.shape, fill, t.dtype), tmpl))
            continue
        arr = data[k]
        if (arr.shape != t.shape or arr.dtype != t.dtype) and \
                callable(shim):
            arr = shim(arr, t)
        if arr.shape != t.shape:
            raise ValueError(f"leaf {k}: checkpoint shape {arr.shape} != "
                             f"state shape {t.shape}")
        if arr.dtype != _dtype_of(tmpl):
            # a silent astype() could lose precision across dtype changes
            raise ValueError(f"leaf {k}: checkpoint dtype {arr.dtype} != "
                             f"state dtype {t.dtype}")
        leaves.append(_to_leaf(arr, tmpl))
    return _rebuild(template, iter(leaves))
