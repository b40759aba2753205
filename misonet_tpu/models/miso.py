"""The MISO separation / enhancement networks.

One parameterized U-Net/TCN (``MISONet``) covers all three reference models —
they differ only in input channel count and output speaker count
(reference model.py: MISO_1 :8-163, MISO_2 :166-278, MISO_3 :282-395):

  * MISO1 (separation):   input = C-mic mixture            -> 2 speakers
  * MISO2 (joint enh.):   input = mixture + 2xMISO1 + 2xBF -> 2 speakers
  * MISO3 (per-spk enh.): input = mixture + 1xMISO1 + 1xBF -> 1 speaker

API: complex spectrogram in, complex spectrogram out, exactly like the
reference's ``forward(complex STFT) -> complex STFT`` (model.py:76-111).
Internally complex is handled as stacked real channels in the same
(all-real, all-imag) order as the reference (model.py:80,:105-106), laid
out NHWC ([B, T, F, C]) instead of torch's NCHW.

Architecture (reference model.py:40-73 + NN_BSS.yml:120-123):

  encoder   7 blocks; freq ladder 129->127->63->31->15->7->3->1,
            channels [2*Cin, 24, 32, 32, 32, 32, 64, 128];
            blocks 0-4 carry DenseBlocks, block 0 has no ELU/IN on its conv
  TCN       2 repeats x 7 dilated temporal blocks at [B, T, 128]
  decoder   mirrors the encoder with skip concatenation (channels double),
            DenseBlocks on blocks 2-6, final transposed conv bare
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from misonet_tpu.config import ModelConfig
from misonet_tpu.models.blocks import (
    ConvBlock,
    ConvTranspose2dTorch,
    DeconvBlock,
    DenseBlock,
    TemporalConvNet,
)


@dataclasses.dataclass(frozen=True)
class MISONet:
    """U-Net + TCN complex spectral mapping network.

    Input:  complex64 [B, C_in, T, F]   (F = 129 for the 8 kHz config)
    Output: complex64 [B, num_spks, T, F]

    ``init(key, mixture) -> {"params": tree}``; ``apply(variables,
    mixture)`` takes what ``init`` returned.  ``sp_mesh`` (a
    jax.sharding.Mesh) routes the TCN through the sequence-parallel path
    when ``cfg.sequence_parallel`` is set."""

    cfg: ModelConfig
    num_spks: int = 2
    sp_mesh: object = None

    def _blocks(self, in_ch: int) -> dict:
        """name -> (block, input channels), in forward order.  ``in_ch`` is
        the stacked real channel count (2 x complex input channels)."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        nb = cfg.num_bottleneck
        en = list(cfg.en_channels)
        de = list(cfg.de_channels) + [2 * self.num_spks]
        if len(en) != nb or len(de) != nb + 1:
            raise ValueError(f"channel plan does not match {nb} levels: {cfg}")

        blocks, ch = {}, in_ch
        for i in range(nb):
            freq_stride = 1 if i in (0, nb - 1) else 2
            blocks[f"enc{i}"] = (
                ConvBlock(en[i], strides=(1, freq_stride), act_norm=i != 0,
                          dtype=dtype),
                ch,
            )
            ch = en[i]
            if i < 5:
                blocks[f"enc{i}_dense"] = (DenseBlock(ch, ch, dtype=dtype), ch)
        blocks["tcn"] = (self._tcn(), ch)
        ch = cfg.tcn_channels
        for i in range(nb):
            ch += en[nb - 1 - i]                    # skip concatenation
            if i >= 2:
                blocks[f"dec{i}_dense"] = (
                    DenseBlock(ch // 2, ch, dtype=dtype), ch
                )
            if i == nb - 1:
                dec = ConvTranspose2dTorch(de[i + 1], strides=(1, 1),
                                           dtype=dtype)
            else:
                dec = DeconvBlock(de[i + 1], strides=(1, 1 if i == 0 else 2),
                                  dtype=dtype)
            blocks[f"dec{i}"] = (dec, ch)
            ch = de[i + 1]
        return blocks

    def _tcn(self):
        cfg = self.cfg
        if cfg.sequence_parallel and self.sp_mesh is not None:
            from misonet_tpu.parallel.tcn_sp import TemporalConvNetSP

            return TemporalConvNetSP(
                repeats=cfg.tcn_repeats, blocks=cfg.tcn_blocks,
                features=cfg.tcn_channels, norm_type=cfg.norm_type,
                mesh=self.sp_mesh,
            )
        return TemporalConvNet(
            repeats=cfg.tcn_repeats, blocks=cfg.tcn_blocks,
            features=cfg.tcn_channels, norm_type=cfg.norm_type,
            dtype=cfg.compute_dtype,
        )

    def init(self, key, mixture) -> dict:
        """Block i from key i.  Blocks of one configuration (e.g. the
        encoder's equal DenseBlocks) are drawn in one vmap over their keys:
        the same values, from a smaller program to compile."""
        blocks = self._blocks(2 * mixture.shape[1])
        keys = dict(zip(blocks, jax.random.split(key, len(blocks))))
        groups: dict = {}
        for name, spec in blocks.items():
            groups.setdefault(spec, []).append(name)
        params = {}
        for (blk, in_ch), names in groups.items():
            if len(names) == 1:
                params[names[0]] = blk.init(keys[names[0]], in_ch)
                continue
            stacked = jax.vmap(lambda k, blk=blk, c=in_ch: blk.init(k, c))(
                jnp.stack([keys[n] for n in names]))
            for i, name in enumerate(names):
                params[name] = jax.tree.map(lambda a, i=i: a[i], stacked)
        return {"params": {name: params[name] for name in blocks}}

    def apply(self, variables: dict, mixture: jnp.ndarray) -> jnp.ndarray:
        if mixture.ndim != 4:
            raise ValueError(f"expected [B, C, T, F], got {mixture.shape}")
        params = variables["params"]
        blocks = self._blocks(2 * mixture.shape[1])
        nb = self.cfg.num_bottleneck

        def run(name, x):
            return blocks[name][0].apply(params[name], x)

        # Complex -> stacked real channels (channel-major, like the input),
        # then NHWC.
        x = jnp.concatenate([mixture.real, mixture.imag], axis=1)
        x = x.transpose(0, 2, 3, 1).astype(self.cfg.compute_dtype)

        skips = []
        for i in range(nb):
            x = run(f"enc{i}", x)
            if f"enc{i}_dense" in blocks:
                x = run(f"enc{i}_dense", x)
            skips.append(x)

        # TCN bottleneck ([B, T, 1, C] -> [B, T, C])
        if x.shape[2] != 1:
            raise ValueError(
                f"bottleneck frequency axis must reduce to 1, got "
                f"{x.shape[2]} (F={mixture.shape[3]} does not fit the "
                f"{nb}-level plan)"
            )
        x = run("tcn", x[:, :, 0, :])[:, :, None, :]

        for i in range(nb):
            x = jnp.concatenate([x, skips[nb - 1 - i]], axis=-1)
            if f"dec{i}_dense" in blocks:
                x = run(f"dec{i}_dense", x)
            x = run(f"dec{i}", x)

        # NHWC -> NCHW, stacked real -> complex (model.py:103-111).
        x = x.transpose(0, 3, 1, 2).astype(jnp.float32)
        real, imag = jnp.split(x, 2, axis=1)
        return jax.lax.complex(real, imag)


def make_miso1(cfg: ModelConfig, num_spks: int = 2, sp_mesh=None) -> MISONet:
    """Separation net: C-mic complex mixture -> num_spks sources at the
    reference mic (reference model.py:8-111, run.py:65-68).  ``sp_mesh``
    activates the sequence-parallel TCN when cfg.sequence_parallel."""
    return MISONet(cfg=cfg, num_spks=num_spks, sp_mesh=sp_mesh)


def make_miso2(cfg: ModelConfig, num_spks: int = 2, sp_mesh=None) -> MISONet:
    """Joint enhancement net over mixture + per-speaker MISO1 + BF stacks
    (input channels C + 2*num_spks; reference model.py:166-278)."""
    return MISONet(cfg=cfg, num_spks=num_spks, sp_mesh=sp_mesh)


def make_miso3(cfg: ModelConfig, sp_mesh=None) -> MISONet:
    """Per-speaker enhancement net over mixture + 1 MISO1 + 1 BF channel
    (input channels C + 2; reference model.py:282-395, run.py:127)."""
    return MISONet(cfg=cfg, num_spks=1, sp_mesh=sp_mesh)


def enhance_input(
    mixture: jnp.ndarray, miso1: jnp.ndarray, bf: jnp.ndarray
) -> jnp.ndarray:
    """Stack the enhancement-net conditioning channels: mixture [B, C, T, F]
    + MISO1 estimates [B, S, T, F] + beamformed estimates [B, S, T, F]
    -> [B, C+2S, T, F] (reference model.py:233-247, :350-364).

    NOTE the reference's trainer/tester actually pass (mix, BF, MISO1) into
    forward(mix, MISO1, BF) — the two conditioning blocks are swapped
    relative to the parameter names, consistently at both train and test
    time (SURVEY.md §2.4).  Semantically the net just sees two conditioning
    channels, so we define the canonical order (MISO1 then BF) and use it
    consistently everywhere."""
    return jnp.concatenate([mixture, miso1, bf], axis=1)
