"""f32-exact contraction helpers.

On an NVIDIA GPU since Ampere (the H100 included), XLA may run an f32
matrix product or einsum on the tensor cores in TF32 at DEFAULT precision:
each operand keeps a 10-bit mantissa (~3 decimal digits, about 5e-4
relative per product).  For the small geometry contractions (3x3 rotation
chains, 2x3 Jacobian chains) and the normal-equation / Schur / CG
accumulations, that error does not average out — it moves the LM fixed
point and the accept/reject decisions away from the f32 result the CPU and
the f64 oracle define.

Every contraction whose result feeds the optimizer state goes through
these helpers, which pin HIGHEST (full f32).  A contraction where TF32
rounding is acceptable may use plain einsum deliberately — say why at
the call site.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def einsum(subscripts: str, *operands, **kw):
    """``jnp.einsum`` pinned to f32-exact (HIGHEST) precision."""
    kw.setdefault("precision", HIGHEST)
    return jnp.einsum(subscripts, *operands, **kw)


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched ``a @ b`` pinned to f32-exact precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def matvec(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Batched ``A @ x`` for [..., m, n] @ [..., n] pinned to f32-exact."""
    return jnp.einsum("...ij,...j->...i", A, x, precision=HIGHEST)
