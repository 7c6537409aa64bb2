"""Gather utilities: blocked 1-D lookups and one-hot two-index lookups.

  * `gather1d` looks up a 1-D operand through (len/64, 64) row blocks
    (or width-2 rows) instead of 1-element rows;
  * for two-index lookups table[row, col], a row gather followed by a
    ONE-HOT multiply-reduce over the minor axis replaces a per-element
    minor-axis gather.  XLA fuses the one-hot select into the row-gather
    consumer, so the (len(row), W) intermediate never materializes.

These forms were chosen by measurement on the system's earlier
accelerator; whether each still pays on the GPU against a plain x[idx]
is an open question (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather1d(x: jax.Array, idx: jax.Array) -> jax.Array:
    """x[idx] for 1-D x via a blocked row lookup.

    When len(x) is a multiple of 64 (every padded node/edge axis is),
    uses the BLOCKED form: reshape x to (len(x)/64, 64) and look up
    (idx // 64, idx % 64) with `table_lookup` — the row gather touches
    64x fewer distinct rows and XLA fuses the one-hot select into the
    consumer.  Falls back to width-2 row packing otherwise.

    Contract: out-of-range idx (either sign) CLAMPS to the nearest
    endpoint, exactly like the plain x[idx] gather (the clamp fuses into
    the index arithmetic).  Without it the blocked form's floor-div/mod block arithmetic would return an
    ARBITRARY in-range element for bad idx — a silent wrong-label hazard
    pinned by tests/test_aux.py::test_gather1d_oob_contract.
    """
    return gather1d_blocked(x, idx)


def gather1d_blocked(x: jax.Array, idx: jax.Array, width: int = 64) -> jax.Array:
    """Blocked row-gather form of gather1d (see gather1d docstring)."""
    return gather1d_unchecked(jnp.clip(idx, 0, x.shape[0] - 1), x, width)


def gather1d_unchecked(idx: jax.Array, x: jax.Array,
                       width: int = 64) -> jax.Array:
    """gather1d WITHOUT the endpoint clamp — out-of-range idx reads an
    ARBITRARY in-range element.  Only for call sites whose indices are
    in-range BY CONSTRUCTION and hot enough to care (the FastSV round
    loop: labels start at identity, hooks only write existing node ids,
    src/dst pad with 0 — graph/cca.py).  The argument order is flipped
    vs gather1d on purpose so a mechanical swap-in is impossible without
    reading this contract."""
    if x.shape[0] % width:
        return jnp.stack([x, x], axis=-1)[idx, 0]
    return table_lookup(x.reshape(-1, width), idx // width, idx % width)


def onehot_select(rows: jax.Array, col: jax.Array) -> jax.Array:
    """rows[..., col] per row via one-hot multiply-reduce (no minor-axis
    dynamic gather).  rows: (..., W); col: (...) int.

    Out-of-range contract: any col outside [0, W) — including negative
    values — yields 0 (False for bool rows), NOT a clamped element like
    take_along_axis would return.  Callers passing padded index arrays
    (slot fills of 0/-1) rely on this zero-fill semantics."""
    w = rows.shape[-1]
    oh = col[..., None] == jnp.arange(w, dtype=col.dtype)
    if rows.dtype == jnp.bool_:
        return jnp.any(rows & oh, axis=-1)
    # pin the accumulator dtype: under x64 jnp.sum promotes int32 -> int64,
    # which breaks while_loop carry typing at gather1d call sites
    return jnp.sum(jnp.where(oh, rows, 0), axis=-1, dtype=rows.dtype)


def table_lookup(table: jax.Array, row: jax.Array, col: jax.Array) -> jax.Array:
    """table[row, col] via row gather + one-hot multiply-reduce.

    Inherits onehot_select's contract: col outside [0, W) yields 0/False,
    not a clamped element.  row is NOT range-checked (it indexes a real
    gather) — callers must clamp/fill row themselves."""
    return onehot_select(table[row], col)


def compact_rows(keep: jax.Array, x: jax.Array, width: int):
    """Per row, the entries of x whose keep flag is set, moved to the front
    in their order, in `width` columns, zeros behind them.

    keep: (R, K) bool; x: (R, K, W).  Returns ((R, width, W), (R, width)
    bool validity).  A stable sort of the flags orders each row and one
    row gather moves the entries, so every output is exactly one input
    value (a one-hot contraction would round through TF32 on a GPU and
    turn a 0 * inf into NaN)."""
    order = jnp.argsort(~keep, axis=1, stable=True)[:, :width]
    valid = (jnp.arange(width)[None, :]
             < jnp.minimum(jnp.sum(keep, axis=1), width)[:, None])
    out = jnp.take_along_axis(x, order[:, :, None], axis=1)
    return jnp.where(valid[:, :, None], out, jnp.zeros((), x.dtype)), valid
