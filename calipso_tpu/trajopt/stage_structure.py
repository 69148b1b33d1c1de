"""Static stage-structure metadata for the block-tridiagonal (Riccati) KKT
backend: per-stage column blocks of the interleaved [x1,u1,...,xT] layout
and row spans of the constraint blocks, with gather/scatter index tables
between flat vectors and padded (T, d_max) block form."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import jax.numpy as jnp


class EqSpan(NamedTuple):
    row_start: int
    num_rows: int
    stage: int
    two_stage: bool  # dynamics rows couple stages (stage, stage+1)
    next_width: int  # nx_{t+1} for two-stage spans


class ConeSpan(NamedTuple):
    row_start: int
    num_rows: int
    stage: int


class StageStructure:
    def __init__(
        self,
        col_starts: List[int],
        col_dims: List[int],
        eq_spans: List[EqSpan],
        cone_spans: List[ConeSpan],
        has_general: bool,
        num_general: int = 0,
        general_stages: Tuple[int, ...] = (),
    ):
        self.col_starts = col_starts
        self.col_dims = col_dims
        self.eq_spans = eq_spans
        self.cone_spans = cone_spans
        self.has_general = has_general
        # general-equality rows are the LAST num_general rows of the flat
        # equality block (transcription ordering: dynamics, per-stage
        # equality, general -- reference indices.jl); the structured
        # backends treat them as a low-rank Schur-complement border.
        # general_stages = the stages whose variables the general rows
        # touch, detected at construction by random-point Jacobian probes
        # (the reference fixes sparsity the same way, solver.jl:88-119).
        self.num_general = int(num_general)
        self.general_stages = tuple(int(t) for t in general_stages)
        self.horizon = len(col_dims)
        self.dmax = max(col_dims)
        n = col_starts[-1] + col_dims[-1]
        self.num_variables = n

        T, dmax = self.horizon, self.dmax
        blk_idx = np.full((T, dmax), n, dtype=np.int64)  # sentinel -> 0 pad
        inv_t = np.zeros(n, dtype=np.int64)
        inv_o = np.zeros(n, dtype=np.int64)
        for t, (cs, d) in enumerate(zip(col_starts, col_dims)):
            blk_idx[t, :d] = np.arange(cs, cs + d)
            inv_t[cs : cs + d] = t
            inv_o[cs : cs + d] = np.arange(d)
        self.blk_idx = blk_idx
        self.inv_t = inv_t
        self.inv_o = inv_o

    def to_blocks(self, v):
        """(n,) flat -> (T, dmax) padded with zeros."""
        vpad = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
        return vpad[self.blk_idx]

    def from_blocks(self, V):
        """(T, dmax) -> (n,) flat."""
        return V[self.inv_t, self.inv_o]

    def densify(self, D, O):
        """Stage-block tridiagonal (D (T,dmax,dmax), O (T-1,dmax,dmax)) ->
        dense symmetric (n, n). Placement is T static dynamic-update-slice
        writes (stage column ranges are contiguous and disjoint), NOT an
        elementwise scatter -- XLA lowers these natively, while an
        elementwise scatter serializes its updates."""
        import jax.lax as lax

        n = self.num_variables
        out = jnp.zeros((n, n), D.dtype)
        for t in range(self.horizon):
            cs, d = self.col_starts[t], self.col_dims[t]
            out = lax.dynamic_update_slice(out, D[t, :d, :d], (cs, cs))
        for t in range(self.horizon - 1):
            cs0, d0 = self.col_starts[t], self.col_dims[t]
            cs1, d1 = self.col_starts[t + 1], self.col_dims[t + 1]
            blk = O[t, :d1, :d0]
            out = lax.dynamic_update_slice(out, blk, (cs1, cs0))
            out = lax.dynamic_update_slice(out, blk.T, (cs0, cs1))
        return out

    def band_matvec(self, D, O, v):
        """y = S v for the stage-block tridiagonal S given as (D, O) and a
        flat (n,) vector v: three batched (T, dmax, dmax) x (T, dmax)
        matvecs, no dense S."""
        Vb = self.to_blocks(v)  # (T, dmax)
        out = jnp.einsum("tab,tb->ta", D, Vb)
        if self.horizon > 1:
            out = out.at[1:].add(jnp.einsum("tab,tb->ta", O, Vb[:-1]))
            out = out.at[:-1].add(jnp.einsum("tab,ta->tb", O, Vb[1:]))
        return self.from_blocks(out)
