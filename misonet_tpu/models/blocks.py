"""Building blocks for the MISO U-Net/TCN models, in plain JAX.

Functional equivalents of the reference's torch modules (reference
model.py:401-632).  Each block is a frozen dataclass holding its static
configuration, with

* ``init(key, in_ch) -> dict`` — float32 parameters for ``in_ch`` input
  channels (kernels ``lecun_normal``, biases zero, PReLU 0.25), and
* ``apply(params, x)`` — a pure function of the parameters and the input.

Parameter names and shapes follow the module tree the checkpoints were
written with (``enc0/Conv_0/kernel``, ``enc0_dense/conv1_kernel``,
``tcn/repeat0_block0/DepthwiseSeparableConv_0/...``; the full tree is
pinned by tests/fixtures/flax_param_tree.json).

* NHWC layouts ([B, T, F, C]);
* conv compute in the configured dtype (bfloat16 or float32), parameters
  stored in float32;
* all normalization statistics computed in float32;
* ConvTranspose implemented as the gradient-of-conv (lhs-dilated
  conv_general_dilated) with torch's output-size convention
  ``out = (in-1)*stride - 2*pad + kernel`` so the encoder/decoder frequency
  ladder (129 -> 127 -> 63 -> 31 -> 15 -> 7 -> 3 -> 1 and back) matches the
  reference exactly (model.py:40-73).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

EPS_GLN = 1e-8   # reference model.py:6
EPS_IN = 1e-5    # torch InstanceNorm default (model.py:413)

_lecun = jax.nn.initializers.lecun_normal()


def _kernel(key, shape) -> jnp.ndarray:
    return _lecun(key, shape, jnp.float32)


def _conv(x, kernel, dtype, dims="NHWC", **kw) -> jnp.ndarray:
    """conv_general_dilated with operands cast to the compute dtype.  No
    explicit preferred_element_type: bf16 operands still accumulate in
    fp32, and an explicit f32 output breaks the conv's transpose rule
    under AD (f32 cotangent vs bf16 kernel)."""
    spatial = dims[1:-1]
    return jax.lax.conv_general_dilated(
        x.astype(dtype),
        kernel.astype(dtype),
        dimension_numbers=(dims, spatial + "IO", dims),
        **kw,
    )


# --------------------------------------------------------------------------
# normalizations
# --------------------------------------------------------------------------


def instance_norm(x: jnp.ndarray, eps: float = EPS_IN) -> jnp.ndarray:
    """Per-channel normalization over all spatial axes, no affine — matches
    torch nn.InstanceNorm1d/2d(affine=False) (reference model.py:413,:579).
    Input [B, *spatial, C]; stats in fp32 regardless of compute dtype."""
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.astype(jnp.float32)
    mean = x32.mean(axes, keepdims=True)
    var = x32.var(axes, keepdims=True)
    return ((x32 - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


def _affine_init(shape):
    return {"gamma": jnp.ones(shape, jnp.float32),
            "beta": jnp.zeros(shape, jnp.float32)}


@dataclasses.dataclass(frozen=True)
class Norm:
    """Norm dispatch matching the reference's chose_norm (model.py:570-581):

    * ``IN``  InstanceNorm, no parameters (the configured default,
      NN_BSS.yml:123);
    * ``gLN`` over (time, channel) with [1, 1, C] affine (model.py:609-632);
    * ``cLN`` over the channel axis per (batch, time) (model.py:583-605);
    * ``BN``  over (batch, spatial) per channel with [C] affine, batch
      statistics only (model.py:581; no running averages, which matches
      the reference's train-mode-dominated pipeline)."""

    kind: str

    _NAMES = {"IN": "InstanceNorm", "gLN": "GlobalLayerNorm",
              "cLN": "ChannelwiseLayerNorm", "BN": "SimpleBatchNorm"}

    def __post_init__(self):
        if self.kind not in self._NAMES:
            raise ValueError(f"unsupported norm_type: {self.kind}")

    @property
    def name(self) -> str:
        """Module-name stem of this norm in the parameter tree."""
        return self._NAMES[self.kind]

    def init(self, key, in_ch: int) -> dict:
        del key
        if self.kind == "IN":
            return {}
        if self.kind == "BN":
            return _affine_init((in_ch,))
        return _affine_init((1, 1, in_ch))

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        if self.kind == "IN":
            return instance_norm(x)
        x32 = x.astype(jnp.float32)
        gamma, beta = params["gamma"], params["beta"]
        if self.kind == "gLN":
            mean = x32.mean((1, 2), keepdims=True)
            var = ((x32 - mean) ** 2).mean((1, 2), keepdims=True)
            out = gamma * (x32 - mean) / jnp.sqrt(var + EPS_GLN) + beta
        elif self.kind == "cLN":
            mean = x32.mean(-1, keepdims=True)
            var = x32.var(-1, keepdims=True)
            out = gamma * (x32 - mean) / jnp.sqrt(var + EPS_GLN) + beta
        else:  # BN
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(axes, keepdims=True)
            var = x32.var(axes, keepdims=True)
            out = gamma * (x32 - mean) * jax.lax.rsqrt(var + EPS_IN) + beta
        return out.astype(x.dtype)


def prelu(alpha: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Single-parameter PReLU, torch default init 0.25 (model.py:558)."""
    return jnp.where(x >= 0, x, alpha.astype(x.dtype) * x)


# --------------------------------------------------------------------------
# U-Net blocks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv2d:
    """Conv2d with bias; NHWC input, HWIO kernel."""

    features: int
    kernel_size: tuple[int, int] = (3, 3)
    strides: tuple[int, int] = (1, 1)
    padding: tuple[tuple[int, int], tuple[int, int]] = ((1, 1), (0, 0))
    dtype: str = "float32"

    def init(self, key, in_ch: int) -> dict:
        return {
            "kernel": _kernel(key, (*self.kernel_size, in_ch, self.features)),
            "bias": jnp.zeros((self.features,), jnp.float32),
        }

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        out = _conv(x, params["kernel"], self.dtype,
                    window_strides=self.strides, padding=self.padding)
        return out + params["bias"].astype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ConvTranspose2dTorch:
    """2-D transposed convolution with torch ConvTranspose2d geometry
    (reference model.py:418-433): out = (in-1)*stride - 2*pad + kernel.

    Implemented as the gradient of a strided conv: lhs-dilate the input by
    ``strides`` and run a VALID conv with the spatially-flipped kernel padded
    by (k-1-p) per side.  Input/output are NHWC."""

    features: int
    kernel_size: tuple[int, int] = (3, 3)
    strides: tuple[int, int] = (1, 2)
    padding: tuple[int, int] = (1, 0)
    dtype: str = "float32"

    def init(self, key, in_ch: int) -> dict:
        return Conv2d(self.features, self.kernel_size).init(key, in_ch)

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        out = _conv(
            x, jnp.flip(params["kernel"], (0, 1)), self.dtype,
            window_strides=(1, 1),
            padding=[(kh - 1 - ph, kh - 1 - ph), (kw - 1 - pw, kw - 1 - pw)],
            lhs_dilation=self.strides,
        )
        return out + params["bias"].astype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    """Conv2d (+ optional ELU + InstanceNorm) — reference Conv2d_
    (model.py:408-416) / init_Conv2d_ (:401-406).  NHWC; time axis padded
    SAME-1, frequency axis VALID (reference padding=(1,0))."""

    features: int
    strides: tuple[int, int] = (1, 1)
    act_norm: bool = True
    dtype: str = "float32"

    def init(self, key, in_ch: int) -> dict:
        conv = Conv2d(self.features, strides=self.strides)
        return {"Conv_0": conv.init(key, in_ch)}

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        conv = Conv2d(self.features, strides=self.strides, dtype=self.dtype)
        x = conv.apply(params["Conv_0"], x)
        if self.act_norm:
            x = instance_norm(jax.nn.elu(x))
        return x


@dataclasses.dataclass(frozen=True)
class DeconvBlock:
    """ConvTranspose2d (+ optional ELU + InstanceNorm) — reference DeConv2d_
    (model.py:425-433) / last_Deconv2d_ (:418-423)."""

    features: int
    strides: tuple[int, int] = (1, 2)
    act_norm: bool = True
    dtype: str = "float32"

    def _deconv(self) -> ConvTranspose2dTorch:
        return ConvTranspose2dTorch(
            self.features, strides=self.strides, dtype=self.dtype
        )

    def init(self, key, in_ch: int) -> dict:
        return {"ConvTranspose2dTorch_0": self._deconv().init(key, in_ch)}

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        x = self._deconv().apply(params["ConvTranspose2dTorch_0"], x)
        if self.act_norm:
            x = instance_norm(jax.nn.elu(x))
        return x


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    """5-layer DenseNet block: each layer Conv2d(3x3, SAME) + ELU +
    InstanceNorm on the concatenation of the input and all previous
    outputs; growth g1, final width g2 (reference model.py:437-482).

    Evaluated grouped by input tensor rather than by layer.  By linearity
    of convolution, layer i's conv over concat(x, y0..y_{i-1}) is a sum of
    per-tensor convs, so each tensor, once produced, is convolved a single
    time with the stacked kernel slices of every later layer that reads
    it: 5 convs of output width [4*g1+g2, 3*g1+g2, ..., g2] over inputs of
    width [in_ch, g1, ..., g1], instead of 5 convs of width g1 over ever
    wider concatenations.  Same parameters, same math up to summation
    order; on an H100 the grouped form runs the MISO1 forward 17% faster
    than the per-layer form (PERF.md)."""

    g1: int
    g2: int
    dtype: str = "float32"

    def _widths(self, in_ch: int) -> tuple[list[int], list[int]]:
        return ([in_ch + i * self.g1 for i in range(5)],
                [self.g1] * 4 + [self.g2])

    def init(self, key, in_ch: int) -> dict:
        in_chs, widths = self._widths(in_ch)
        keys = jax.random.split(key, 5)
        params = {}
        for i in range(5):
            params[f"conv{i + 1}_kernel"] = _kernel(
                keys[i], (3, 3, in_chs[i], widths[i])
            )
            params[f"conv{i + 1}_bias"] = jnp.zeros((widths[i],), jnp.float32)
        return params

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        in_ch = x.shape[-1]
        _, widths = self._widths(in_ch)

        def rows(i: int, j: int) -> jnp.ndarray:
            """Input-channel slice of layer i's kernel that reads tensor j
            (j = 0 is the block input, j >= 1 the output of layer j-1)."""
            start = 0 if j == 0 else in_ch + (j - 1) * self.g1
            width = in_ch if j == 0 else self.g1
            return params[f"conv{i + 1}_kernel"][:, :, start:start + width]

        tensor = x.astype(self.dtype)
        preact: list[jnp.ndarray | None] = [None] * 5
        for j in range(5):
            # the newly available tensor against all layers that consume it
            stacked = jnp.concatenate([rows(i, j) for i in range(j, 5)], -1)
            out = _conv(tensor, stacked, self.dtype,
                        window_strides=(1, 1), padding=((1, 1), (1, 1)))
            off = 0
            for i in range(j, 5):
                piece = out[..., off:off + widths[i]]
                preact[i] = piece if preact[i] is None else preact[i] + piece
                off += widths[i]
            # layer j's inputs are complete: activate it
            y = preact[j] + params[f"conv{j + 1}_bias"].astype(self.dtype)
            tensor = instance_norm(jax.nn.elu(y))
        return tensor


# --------------------------------------------------------------------------
# TCN bottleneck
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DepthwiseSeparableConv:
    """Dilated depthwise Conv1d (no bias) -> PReLU -> norm -> pointwise
    Conv1d (no bias) — reference model.py:553-567.  Input [B, T, C]."""

    features: int
    dilation: int
    norm_type: str = "gLN"
    dtype: str = "float32"

    def init(self, key, in_ch: int) -> dict:
        k_dw, k_pw = jax.random.split(key)
        norm = Norm(self.norm_type)
        params = {
            "depthwise": {"kernel": _kernel(k_dw, (3, 1, in_ch))},
            "PReLU_0": {"alpha": jnp.full((), 0.25, jnp.float32)},
            "pointwise": {"kernel": _kernel(k_pw, (1, in_ch, self.features))},
        }
        if self.norm_type != "IN":
            params[f"{norm.name}_0"] = norm.init(None, in_ch)
        return params

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        d = self.dilation
        x = _conv(x, params["depthwise"]["kernel"], self.dtype, dims="NWC",
                  window_strides=(1,), padding=((d, d),), rhs_dilation=(d,),
                  feature_group_count=x.shape[-1])
        x = prelu(params["PReLU_0"]["alpha"], x)
        norm = Norm(self.norm_type)
        x = norm.apply(params.get(f"{norm.name}_0", {}), x)
        return _conv(x, params["pointwise"]["kernel"], self.dtype, dims="NWC",
                     window_strides=(1,), padding=((0, 0),))


@dataclasses.dataclass(frozen=True)
class TemporalBlock:
    """norm -> ELU -> DSConv -> norm -> ELU -> DSConv with residual add —
    reference model.py:517-550.  The DSConvs' internal norm is hard-coded
    gLN there (model.py:533,537) while the outer norms follow the config;
    we reproduce that."""

    features: int
    dilation: int
    norm_type: str = "IN"
    dtype: str = "float32"

    def _dsconv(self) -> DepthwiseSeparableConv:
        return DepthwiseSeparableConv(
            self.features, self.dilation, norm_type="gLN", dtype=self.dtype
        )

    def init(self, key, in_ch: int) -> dict:
        k0, k1 = jax.random.split(key)
        norm = Norm(self.norm_type)
        params = {
            "DepthwiseSeparableConv_0": self._dsconv().init(k0, in_ch),
            "DepthwiseSeparableConv_1": self._dsconv().init(k1, self.features),
        }
        if self.norm_type != "IN":
            params[f"{norm.name}_0"] = norm.init(None, in_ch)
            params[f"{norm.name}_1"] = norm.init(None, self.features)
        return params

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        norm, ds = Norm(self.norm_type), self._dsconv()
        y = x
        for j in range(2):
            y = jax.nn.elu(norm.apply(params.get(f"{norm.name}_{j}", {}), y))
            y = ds.apply(params[f"DepthwiseSeparableConv_{j}"], y)
        return y + x


@dataclasses.dataclass(frozen=True)
class TemporalConvNet:
    """Conv-TasNet-style TCN: R repeats of X blocks with dilations
    2^0..2^(X-1) — reference model.py:486-515 (R=2, X=7, 128 channels at
    the bottleneck).  Non-causal: padding keeps length (SURVEY.md §2.1).
    Input [B, T, C]."""

    repeats: int = 2
    blocks: int = 7
    features: int = 128
    norm_type: str = "IN"
    dtype: str = "float32"

    def _blocks(self):
        for r in range(self.repeats):
            for b in range(self.blocks):
                yield f"repeat{r}_block{b}", TemporalBlock(
                    self.features, 2**b, self.norm_type, self.dtype
                )

    def init(self, key, in_ch: int) -> dict:
        """Block i from key i.  A block's parameters do not depend on its
        dilation, so blocks 1.. are drawn in one vmap over their keys: the
        same values as block-by-block, from a program a fraction the size
        (the init otherwise compiles one set of RNG kernels per block)."""
        names = [name for name, _ in self._blocks()]
        keys = jax.random.split(key, len(names))
        blk = TemporalBlock(self.features, 1, self.norm_type, self.dtype)
        params = {names[0]: blk.init(keys[0], in_ch)}
        if len(names) > 1:
            rest = jax.vmap(lambda k: blk.init(k, self.features))(keys[1:])
            for i, name in enumerate(names[1:]):
                params[name] = jax.tree.map(lambda a, i=i: a[i], rest)
        return params

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        for name, blk in self._blocks():
            x = blk.apply(params[name], x)
        return x
