"""Complex contraction helpers.

Every complex einsum in the framework routes through :func:`ceinsum`, which
expands (A+iB)(C+iD) into four real contractions with fp32 accumulation at
HIGHEST precision: on a GPU the default float32 matmul rounds its operands
to TF32, which moved the MVDR output 9.3e-4 (rel-L2, F=257, M=8) from a
float64 oracle against 5.1e-6 at HIGHEST (H100, PERF.md), and these
contractions are a tiny share of any step.  Elementwise complex
arithmetic (mul, abs, exp, fft) is left to XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ceinsum(subscripts: str, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """jnp.einsum for two complex operands via real decomposition.

    Handles real/complex mixes too; conjugate an operand at the call site
    (conj is elementwise and cheap)."""
    a_c = jnp.iscomplexobj(a)
    b_c = jnp.iscomplexobj(b)
    def e(x, y):
        return jnp.einsum(subscripts, x, y, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)

    if not (a_c or b_c):
        return e(a, b)

    ar = jnp.real(a) if a_c else a
    ai = jnp.imag(a) if a_c else None
    br = jnp.real(b) if b_c else b
    bi = jnp.imag(b) if b_c else None

    rr = e(ar, br)
    if a_c and b_c:
        re = rr - e(ai, bi)
        im = e(ar, bi) + e(ai, br)
    elif a_c:
        re = rr
        im = e(ai, br)
    else:
        re = rr
        im = e(ar, bi)
    return jax.lax.complex(re, im)
