"""Streaming / collective spatial-covariance accumulation for long-form
continuous speech separation (CSS).

The reference handles long utterances by re-STFT'ing the concatenated
full-utterance estimate and computing one SCM over all frames on the host
(tester.py:426-441).  For on-device long-form processing we instead keep a
*running* SCM: per-block partial sums combined exactly (they are sums over
disjoint frame sets), optionally reduced across devices with psum when
blocks are sharded over the mesh (SURVEY.md §2.10 item 4, BASELINE.json
config 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from misonet_tpu.ops.complex_utils import ceinsum


def scm_partial(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unnormalized SCM partial sum for one block.

    x: complex [..., C, T, F] -> (sum [..., F, C, C], frames T as weight)."""
    s = ceinsum("...ctf,...dtf->...fcd", x, jnp.conj(x))
    t = jnp.asarray(x.shape[-2], jnp.float32)
    return s, t


def streaming_scm_update(
    acc: tuple[jnp.ndarray, jnp.ndarray], block: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fold one block into a running (sum, count) SCM accumulator.
    Use with lax.scan over blocks for streaming CSS."""
    s, t = scm_partial(block)
    return acc[0] + s, acc[1] + t


def scm_finalize(acc: tuple[jnp.ndarray, jnp.ndarray]) -> jnp.ndarray:
    """(sum, count) -> time-averaged Hermitian SCM [..., F, C, C]."""
    s, t = acc
    r = s / t
    return 0.5 * (r + jnp.conj(jnp.swapaxes(r, -1, -2)))


def chunked_scm(blocks: jnp.ndarray, axis_name: str | None = None) -> jnp.ndarray:
    """SCM over a stack of blocks [N, C, T, F] (concatenated in time),
    equal to the SCM of the concatenation.  When ``axis_name`` is given the
    partial sums are additionally psum-reduced over that mesh axis, so
    blocks may be sharded across devices (collective accumulation)."""
    s = ceinsum("nctf,ndtf->fcd", blocks, jnp.conj(blocks))
    t = jnp.asarray(blocks.shape[0] * blocks.shape[2], jnp.float32)
    if axis_name is not None:
        s = jax.lax.psum(s, axis_name)
        t = jax.lax.psum(t, axis_name)
    r = s / t
    return 0.5 * (r + jnp.conj(jnp.swapaxes(r, -1, -2)))
