"""Pitch collapse of many panel lanes as one Pallas kernel on the Triton route.

The render program's collapse (``render/dispatch._collapse_lanes``) sums
each lane's cube over the pitch bins its category keeps, with NaNs as zero
and rows past the file's length set to NaN -- the masked ``nansum`` of
:func:`configurable_spectrograms_tpu.ops.spectrogram.collapse_cube`, which
stays the plain reference.  On a GPU this kernel does it instead:

* one block per (lane, time tile, energy tile); a loop over the pitch bins
  inside the block takes the place of the reduction axis;
* each lane reads its cube straight out of the deduplicated stack by index,
  so no (lanes, T, A, E) gather is materialized;
* a pitch bin the lane's mask drops is never read (the mask gates the
  load), so a category panel moves only its own bins' bytes;
* pitch bins are added in order, as numpy's ``nansum`` over that axis does.

It is compiled for the GPU only (``backend="triton"``); the CPU tests run
it with ``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Rows of the time axis per block, and energy bins per block (a power of
#: two, masked down to the real width).
T_TILE = 32
E_TILE = 128

#: Offsets into the flattened stack are int32.
_MAX_ELEMENTS = 2**31 - 1


def applies(stack_shape: tuple[int, ...]) -> bool:
    """Whether the render program collapses with this kernel.

    On a GPU, for stacks whose flat offsets fit in int32; everywhere else
    the program keeps XLA's collapse.
    """
    n = 1
    for d in stack_shape:
        n *= int(d)
    return jax.default_backend() == "gpu" and n <= _MAX_ELEMENTS


def _kernel(u_ref, pm_ref, tv_ref, cubes_ref, o_ref, *, Tp, Ap, Ep):
    lane = pl.program_id(0)
    rows = pl.program_id(1) * T_TILE + jnp.arange(T_TILE, dtype=jnp.int32)
    cols = pl.program_id(2) * E_TILE + jnp.arange(E_TILE, dtype=jnp.int32)
    inside = (rows < Tp)[:, None] & (cols < Ep)[None, :]
    u = plgpu.load(u_ref.at[lane])
    base = (u * Tp + rows[:, None]) * (Ap * Ep) + cols[None, :]

    def add_bin(a, acc):
        keep = plgpu.load(pm_ref.at[lane * Ap + a]) != 0
        x = plgpu.load(cubes_ref.at[base + a * Ep], mask=inside & keep, other=0.0)
        return acc + jnp.where(jnp.isnan(x), 0.0, x)

    acc = jax.lax.fori_loop(0, Ap, add_bin, jnp.zeros((T_TILE, E_TILE), jnp.float32))
    tv = plgpu.load(tv_ref.at[lane])
    acc = jnp.where(rows[:, None] < tv, acc, jnp.nan)
    plgpu.store(o_ref.at[(lane * Tp + rows[:, None]) * Ep + cols[None, :]], acc, mask=inside)


def collapse_lanes(cubes: jax.Array, u: jax.Array, pitch_masks: jax.Array,
                   t_valids: jax.Array, interpret: bool = False) -> jax.Array:
    """(U, T, A, E) stack -> (lanes, T, E): lane ``j`` collapses ``cubes[u[j]]``.

    ``pitch_masks`` is (lanes, A) bool and ``t_valids`` (lanes,) int; the
    result equals ``vmap(collapse_cube)(cubes[u], pitch_masks, t_valids)``.
    """
    _, Tp, Ap, Ep = cubes.shape
    lanes = u.shape[0]
    out = pl.pallas_call(
        functools.partial(_kernel, Tp=Tp, Ap=Ap, Ep=Ep),
        out_shape=jax.ShapeDtypeStruct((lanes * Tp * Ep,), jnp.float32),
        grid=(lanes, pl.cdiv(Tp, T_TILE), pl.cdiv(Ep, E_TILE)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="collapse_lanes",
    )(
        u.astype(jnp.int32),
        pitch_masks.astype(jnp.int32).reshape(-1),
        t_valids.astype(jnp.int32),
        cubes.astype(jnp.float32).reshape(-1),
    )
    return out.reshape(lanes, Tp, Ep)
