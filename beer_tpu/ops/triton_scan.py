"""HMM scaled forward and backward-smoothing passes as Pallas kernels
for the GPU (Pallas through Triton).

The plain route (:func:`beer_tpu.ops.semiring_scan._scaled_pass` and
``_smoothing_scan``) runs the T-step recursion as a ``lax.scan``: every
step is its own loop iteration of several small launches around one
(B, S) @ (S, S) product, so the pass is bound by launch latency, not by
FLOPs or bytes.  Here the whole T-loop runs inside one program per tile
of utterances.  Utterances are independent, so batch tiles map onto
SMs with nothing carried between programs.

Layout (batch-major, the layout of the plain route):

* the state axis is padded to ``n_chunks * chunk`` and held as a Python
  list of ``(bb, chunk)`` tiles, so every product is a list of small
  ``pl.dot`` calls whose operands fit a block's shared memory (a padded
  (256, 256) float32 matrix would not);
* padded states have zero init/final mass, zero emission and zero
  transition rows/columns, so they never reach a normalizer;
* the transition matrix is read from global memory every step (it stays
  in L1/L2), α̂ is stored to HBM and read back by the smoothing kernel.

Products run at ``PRECISION``: exact float32 FMA (Triton's ``ieee``
input precision), never at the TF32 default.  On an H100 that also beat
TF32x3 tensor-core products (PERF.md), because one program's product is
only (8, 64) @ (64, 64).

The passes compute exactly the plain route's outputs;
:mod:`beer_tpu.ops.semiring_scan` wraps them in ``jax.custom_vjp`` with
the plain scan as the backward, so gradients through log Z (the sequence
VAE's encoder) keep working.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PRECISION = jax.lax.DotAlgorithmPreset.F32_F32_F32
# Tile sizes measured on an H100 (PERF.md): 8 utterances per program
# (64 programs at B=512) and 64-state chunks; 16 rows or 128-state chunks
# spill or overflow shared memory.
BATCH_TILE = 8
# widest state chunk (a power of two, >= 16: Triton's minimum dot width)
MAX_CHUNK = 64
NUM_WARPS = 4
NUM_STAGES = 2


def use_kernel(trans: jnp.ndarray, dtype) -> bool:
    """The kernel route: a GPU backend, one shared (S, S) transition
    matrix and float32 data.  Per-utterance (B, S, S) transitions and
    float64 keep the plain scan."""
    return (
        jax.default_backend() == "gpu"
        and trans.ndim == 2
        and jnp.dtype(dtype) == jnp.float32
    )


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def chunking(s: int) -> tuple:
    """(chunk, n_chunks): the state axis as ``n_chunks`` tiles of
    ``chunk`` states (a power of two between 16 and ``MAX_CHUNK``)."""
    chunk = min(max(16, _pow2(s)), MAX_CHUNK)
    return chunk, -(-s // chunk)


def _interpret() -> bool:
    # A kernel runs compiled on the GPU; elsewhere only the Pallas
    # interpreter can run it (the tests force the route there).
    return jax.default_backend() != "gpu"


def _dot(a, b):
    return pl.dot(a, b, precision=PRECISION)


def _matvec(vec, t_ref, chunk, n_c):
    """[Σ_k vec_k @ T[k, j] for each column chunk j] with T read from
    global memory tile by tile."""
    out = []
    for j in range(n_c):
        cols = pl.ds(j * chunk, chunk)
        acc = _dot(vec[0], t_ref[pl.ds(0, chunk), cols])
        for k in range(1, n_c):
            acc += _dot(vec[k], t_ref[pl.ds(k * chunk, chunk), cols])
        out.append(acc)
    return out


def _rowsum(tiles):
    total = tiles[0].sum(-1)
    for x in tiles[1:]:
        total += x.sum(-1)
    return total


def _forward_kernel(e_ref, t_ref, init_ref, m_ref, a_ref, lc_ref, *,
                    t_len, bb, chunk, n_c):
    rows = pl.ds(pl.program_id(0) * bb, bb)
    tiny = jnp.finfo(jnp.float32).tiny

    def cols(k):
        return pl.ds(k * chunk, chunk)

    prob = [init_ref[rows, cols(k)] * e_ref[rows, 0, cols(k)]
            for k in range(n_c)]
    norm = jnp.maximum(_rowsum(prob), tiny)
    prob = [p / norm[:, None] for p in prob]
    logc = jnp.log(norm)
    for k in range(n_c):
        a_ref[rows, 0, cols(k)] = prob[k]
    lc_ref[rows, 0] = logc

    def step(t, carry):
        prob, logc = carry
        keep = m_ref[rows, t] > 0
        raw = _matvec(prob, t_ref, chunk, n_c)
        raw = [r * e_ref[rows, t, cols(k)] for k, r in enumerate(raw)]
        norm = jnp.maximum(_rowsum(raw), tiny)
        prob = [jnp.where(keep[:, None], r / norm[:, None], p)
                for r, p in zip(raw, prob)]
        logc = jnp.where(keep, logc + jnp.log(norm), logc)
        for k in range(n_c):
            a_ref[rows, t, cols(k)] = prob[k]
        lc_ref[rows, t] = logc
        return prob, logc

    jax.lax.fori_loop(1, t_len, step, (prob, logc))


def _smoothing_kernel(e_ref, tt_ref, final_ref, m_ref, a_ref,
                      g_ref, w_ref, ws_ref, pn_ref, *,
                      t_len, bb, chunk, n_c):
    rows = pl.ds(pl.program_id(0) * bb, bb)
    tiny = jnp.finfo(jnp.float32).tiny

    def cols(k):
        return pl.ds(k * chunk, chunk)

    final = [final_ref[rows, cols(k)] for k in range(n_c)]
    fsum = jnp.maximum(_rowsum(final), tiny)
    v0 = [f / fsum[:, None] for f in final]

    def step(i, v_hat):
        t = t_len - 1 - i
        m_t = m_ref[rows, t]
        m_next = jnp.where(
            t + 1 < t_len, m_ref[rows, jnp.minimum(t + 1, t_len - 1)], 0.0)
        is_last = (m_t * (1.0 - m_next) > 0)[:, None]
        u1 = _matvec(v_hat, tt_ref, chunk, n_c)
        u1 = [jnp.where(is_last, f, u) for f, u in zip(final, u1)]
        nu = jnp.maximum(_rowsum(u1), tiny)
        ab = [a_ref[rows, t, cols(k)] * (u / nu[:, None])
              for k, u in enumerate(u1)]
        pn = _rowsum(ab)
        scale = (m_t / jnp.maximum(pn, tiny))[:, None]
        v = [e_ref[rows, t, cols(k)] * u for k, u in enumerate(u1)]
        sv = jnp.maximum(_rowsum(v), tiny)
        keep = (m_t > 0)[:, None]
        new = []
        for k in range(n_c):
            w = v[k] / sv[:, None]
            g_ref[rows, t, cols(k)] = ab[k] * scale
            w_ref[rows, t, cols(k)] = w
            new.append(jnp.where(keep, w, v_hat[k]))
        ws_ref[rows, t] = sv / nu
        pn_ref[rows, t] = pn
        return new

    jax.lax.fori_loop(0, t_len, step, v0)


def _pad(x, b_pad, s_pad, s_axes):
    widths = [(0, 0)] * x.ndim
    widths[0] = (0, b_pad)
    for ax in s_axes:
        widths[ax] = (0, s_pad)
    return jnp.pad(x, widths)


def _geometry(e_llh):
    """(B, T, S, rows per program, chunk, n_chunks, batch pad, state pad)."""
    b, t_len, s = e_llh.shape
    bb = BATCH_TILE
    chunk, n_c = chunking(s)
    return b, t_len, s, bb, chunk, n_c, -(-b // bb) * bb - b, chunk * n_c - s


def _call(kernel, out_shapes, grid, args, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shapes,
        grid=grid,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=_interpret(),
        name=name,
    )(*args)


def forward_pass(e_llh, trans, init_vec, mask):
    """Scaled forward pass; returns (α̂ (B, T, S), log-scales (B, T)),
    equal to ``_scaled_pass(..., reverse=False)[:2]``."""
    b, t_len, s, bb, chunk, n_c, bp, sp = _geometry(e_llh)
    f32 = jnp.float32
    args = (
        _pad(e_llh.astype(f32), bp, sp, (2,)),
        _pad(trans.astype(f32), 0, sp, (0, 1)),
        _pad(init_vec.astype(f32), bp, sp, (1,)),
        _pad(mask.astype(f32), bp, 0, ()),
    )
    bt, st = b + bp, s + sp
    kernel = functools.partial(
        _forward_kernel, t_len=t_len, bb=bb, chunk=chunk, n_c=n_c)
    probs, logcs = _call(
        kernel,
        (jax.ShapeDtypeStruct((bt, t_len, st), f32),
         jax.ShapeDtypeStruct((bt, t_len), f32)),
        (bt // bb,), args, "hmm_forward_scan")
    return probs[:b, :, :s], logcs[:b]


def smoothing_pass(e_llh, trans, final_vec, mask, a_probs):
    """Fused backward + smoothing pass; returns (γ, w, wsum, pnorm),
    equal to ``_smoothing_scan``."""
    b, t_len, s, bb, chunk, n_c, bp, sp = _geometry(e_llh)
    f32 = jnp.float32
    args = (
        _pad(e_llh.astype(f32), bp, sp, (2,)),
        _pad(trans.astype(f32).T, 0, sp, (0, 1)),
        _pad(final_vec.astype(f32), bp, sp, (1,)),
        _pad(mask.astype(f32), bp, 0, ()),
        _pad(a_probs.astype(f32), bp, sp, (2,)),
    )
    bt, st = b + bp, s + sp
    kernel = functools.partial(
        _smoothing_kernel, t_len=t_len, bb=bb, chunk=chunk, n_c=n_c)
    seq = jax.ShapeDtypeStruct((bt, t_len, st), f32)
    frame = jax.ShapeDtypeStruct((bt, t_len), f32)
    gamma, w, wsum, pnorm = _call(
        kernel, (seq, seq, frame, frame), (bt // bb,), args,
        "hmm_smoothing_scan")
    return gamma[:b, :, :s], w[:b, :, :s], wsum[:b], pnorm[:b]
