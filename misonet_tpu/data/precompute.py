"""Precompute MISO1 / beamformer outputs for enhancement training.

The reference supports two enhancement-training data modes: compute MISO1 +
MVDR inside the DataLoader per item, or load outputs precomputed by a
test-mode pass (``load_MISO1_Output`` / ``load_MVDR_Output`` flags,
NN_BSS.yml:171-172; save path via Tester save_flag, SMS_WSJ.py:47-54;
loading at data.py:133-145, :190-199).

This module is the save side, on device and batched: run the frozen-MISO1
full-array decode + MVDR over a shard directory and write companion
``<shard>.feat.npz`` files holding the ref-channel MISO1 and beamformed
complex spectrograms.  ``ShardDataset`` picks the companions up via
``with_features=True`` and ``EnhanceTrainer`` can then skip its feature
step.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.beamforming.mvdr import mvdr_beamform
from misonet_tpu.config import DatasetConfig, StftConfig
from misonet_tpu.inference.separate import make_full_array_decode
from misonet_tpu.ops.stft import stft_scaled


def precompute_enhance_features(
    miso1_model,
    miso1_params,
    shard_dir: str | Path,
    stft_cfg: StftConfig,
    ds_cfg: DatasetConfig,
    batch_size: int = 8,
    host_index: int = 0,
    host_count: int = 1,
) -> int:
    """Write <shard>.feat.npz companions (miso1 [S,T,F], bf [S,T,F]
    complex64) for every shard.  Returns the number of files written."""
    from misonet_tpu.data.dataset import ShardDataset

    ds = ShardDataset(shard_dir, ds_cfg.num_spks, host_index, host_count)
    decode = make_full_array_decode(
        miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
    )

    @jax.jit
    def features(mix_wave):
        mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
        full = decode(miso1_params, mix)
        bf = jax.vmap(
            lambda s: mvdr_beamform(s, mix, ref_ch=ds_cfg.ref_ch),
            in_axes=1,
            out_axes=1,
        )(full)
        return full[:, :, ds_cfg.ref_ch], bf

    written = 0
    for start in range(0, len(ds) - batch_size + 1, batch_size):
        idxs = list(range(start, start + batch_size))
        mix = np.stack([ds[i]["mix"] for i in idxs])
        miso1, bf = features(jnp.asarray(mix))
        miso1, bf = np.asarray(miso1), np.asarray(bf)
        for j, i in enumerate(idxs):
            out = ds.files[i].with_suffix(".feat.npz")
            np.savez(out, miso1=miso1[j], bf=bf[j])
            written += 1
    # tail (partial batch) one by one
    for i in range(len(ds) - (len(ds) % batch_size), len(ds)):
        mix = ds[i]["mix"][None]
        miso1, bf = features(jnp.asarray(mix))
        out = ds.files[i].with_suffix(".feat.npz")
        np.savez(out, miso1=np.asarray(miso1)[0], bf=np.asarray(bf)[0])
        written += 1
    return written
