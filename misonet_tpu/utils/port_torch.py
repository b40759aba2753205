"""Weight porting: reference PyTorch MISO state_dicts -> misonet_tpu params.

Enables (a) numerical parity testing of the architecture (same weights in,
same spectrogram out) and (b) migrating any checkpoint trained with the
reference implementation (reference model.py module structure; layout
mapping NCHW/OIHW -> NHWC/HWIO).

Mapping summary (torch name -> parameter-tree path):
  encoders.{i}.0.{conv2d|net.0}.*        -> enc{i}/Conv_0
  encoders.{i}.1.conv{n}.0.*             -> enc{i}_dense/conv{n}/Conv_0
  TCN.temporal_conv_net.{r}.{x}.net.{2|5}.net.*
                                         -> tcn/repeat{r}_block{x}/
                                            DepthwiseSeparableConv_{0|1}/...
  decoders.{i}.{...}                     -> dec{i}(_dense)/...

Weight layout conversions:
  Conv2d            [O,I,kh,kw]  -> [kh,kw,I,O]
  ConvTranspose2d   [I,O,kh,kw]  -> [kh,kw,I,O]   (both store the true-
                                    convolution kernel; no spatial flip)
  Conv1d depthwise  [C,1,k]      -> [k,1,C]
  Conv1d pointwise  [O,I,1]      -> [1,I,O]
  PReLU             [1]          -> scalar
  gLN gamma/beta    [1,C,1]      -> [1,1,C]
"""

from __future__ import annotations

import numpy as np


def _conv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _deconv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1))


def port_miso_state_dict(
    state_dict: dict[str, np.ndarray],
    num_bottleneck: int = 7,
    tcn_repeats: int = 2,
    tcn_blocks: int = 7,
) -> dict:
    """Convert a reference MISO_{1,2,3} torch state_dict (tensors already as
    numpy arrays) into a params dict for models.MISONet."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: dict = {}

    # --- encoders -----------------------------------------------------
    for i in range(num_bottleneck):
        conv_key = (
            f"encoders.{i}.0.conv2d" if i == 0 else f"encoders.{i}.0.net.0"
        )
        params[f"enc{i}"] = {
            "Conv_0": {
                "kernel": _conv2d(sd[f"{conv_key}.weight"]),
                "bias": sd[f"{conv_key}.bias"],
            }
        }
        if i < 5:
            dense = {}
            for n in range(1, 6):
                base = f"encoders.{i}.1.conv{n}.0"
                dense[f"conv{n}_kernel"] = _conv2d(sd[f"{base}.weight"])
                dense[f"conv{n}_bias"] = sd[f"{base}.bias"]
            params[f"enc{i}_dense"] = dense

    # --- TCN ----------------------------------------------------------
    tcn: dict = {}
    for r in range(tcn_repeats):
        for x in range(tcn_blocks):
            tb: dict = {}
            for j, net_idx in enumerate((2, 5)):
                base = f"TCN.temporal_conv_net.{r}.{x}.net.{net_idx}.net"
                tb[f"DepthwiseSeparableConv_{j}"] = {
                    "depthwise": {
                        "kernel": np.ascontiguousarray(
                            sd[f"{base}.0.weight"].transpose(2, 1, 0)
                        )
                    },
                    "PReLU_0": {"alpha": sd[f"{base}.1.weight"].reshape(())},
                    "GlobalLayerNorm_0": {
                        "gamma": sd[f"{base}.2.gamma"].transpose(0, 2, 1),
                        "beta": sd[f"{base}.2.beta"].transpose(0, 2, 1),
                    },
                    "pointwise": {
                        "kernel": np.ascontiguousarray(
                            sd[f"{base}.3.weight"].transpose(2, 1, 0)
                        )
                    },
                }
            tcn[f"repeat{r}_block{x}"] = tb
    params["tcn"] = tcn

    # --- decoders -----------------------------------------------------
    for i in range(num_bottleneck):
        if i >= 2:
            dense = {}
            for n in range(1, 6):
                base = f"decoders.{i}.0.conv{n}.0"
                dense[f"conv{n}_kernel"] = _conv2d(sd[f"{base}.weight"])
                dense[f"conv{n}_bias"] = sd[f"{base}.bias"]
            params[f"dec{i}_dense"] = dense
            deconv_key = (
                f"decoders.{i}.1.deconv2d"
                if i == num_bottleneck - 1
                else f"decoders.{i}.1.net.0"
            )
        else:
            deconv_key = f"decoders.{i}.0.net.0"
        kernel = _deconv2d(sd[f"{deconv_key}.weight"])
        bias = sd[f"{deconv_key}.bias"]
        if i == num_bottleneck - 1:
            params[f"dec{i}"] = {"kernel": kernel, "bias": bias}
        else:
            params[f"dec{i}"] = {
                "ConvTranspose2dTorch_0": {"kernel": kernel, "bias": bias}
            }

    return {"params": params}
