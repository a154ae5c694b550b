"""The factorized-attention U-Net trunk and BASE
(``mdvit_tpu/models/base.py``: ``FATEncoderDecoder``, ``BASE``).

Stem (two ConvBN + hardswish to H/4) → four encoder stages (a DWConvBN patch
embed and an ``MHSAStage`` each) → bridge at H/32 (512 → 1024) → four
transformer decoding blocks back to H/4. Options, as in the JAX module:

* ``adapt="Sup"``: the Sup domain gate in every attention block;
* ``dsn``: per-domain BatchNorms and LayerNorms everywhere on the trunk;
* ``bn_domain_stats``: train-mode BN moments per domain (else joint);
* ``adapter``: ``"DASE"`` (a ``DomainAttention`` after each encoder stage,
  replacing the stream, and after each decoder block) or ``"USE"`` (an
  ``SEBlock`` on each skip copy, the bridge output and after each decoder
  block).

Submodule names follow the original torch MDViT: ``stem.{0,1}``,
``patch_embed_stages.i.patch_conv``, ``mhsa_stages.i``, ``bridge.{0,1,3,4}``,
``decoder{1..4}``; the DSN tree has ``stem_1``, ``stem_2``,
``bridge_conv1``, ``bridge_norms1``, ``bridge_conv2``, ``bridge_norms2``
and per-domain ``bns.{d}`` / ``norm1s.{d}`` / ``norm2s.{d}``; the adapters
keep the JAX names ``enc_adapter{i}``, ``dec_adapter{i}``,
``bridge_adapter``.

``train`` and the domain one-hot reach every BatchNorm (stem, patch embeds,
bridge, ``conv_after``); ``drop_rate`` and ``drop_path_rate`` reach every
block, as in the JAX module.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.adapters import DomainAttention, SEBlock
from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.decoders import UnetDecodingBlockTransformer
from mdvit_tpu_torch.ops.layers import Conv2d, ConvBN, DWConvBN
from mdvit_tpu_torch.ops.norm import NormSpec, make_bn
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.mesh import spatial_mean


def split_seg(seg: Any) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """(logits, aux logits or None) of a model's ``seg`` output: MDViT gives
    a ``(logits, aux)`` tuple, BASE and the comparators the logits alone
    (``steps.py:191-194``), TransFuse its three deep-supervision maps
    ``(map_x, map_1, map_2)``, of which eval and serving take map_2
    (``steps.py:310-314``, ``scripts/predict.py:103-104``)."""
    if isinstance(seg, tuple):
        return (seg[2], None) if len(seg) == 3 else seg
    return seg, None


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, norm: NormSpec = NormSpec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_conv = DWConvBN(in_ch, out_ch, 3, stride, dw_groups_on="in",
                                   norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        return self.patch_conv(x, domain_onehot, train)


class FATEncoderDecoder(nn.Module):
    # the row-changing ops from the input to the bridge grid
    # (parallel/context.py): the two stride-2 stems and the strided patch
    # embeds of stages 2 to 4, 3×3 with SAME padding (⌈R/2⌉ rows)
    row_chain = (("same", 2),) * 5

    def __init__(self, num_layers: Sequence[int] = (2, 2, 2, 2),
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8),
                 num_domains: int = 4, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, adapt: str | None = None,
                 dsn: bool = False, bn_domain_stats: bool = True,
                 adapter: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if adapter not in (None, "DASE", "USE"):
            raise ValueError(f"unknown adapter {adapter!r}")
        dims = tuple(embed_dims)
        spec = NormSpec(num_domains, dsn, bn_domain_stats)
        sup = adapt == "Sup"
        self.dsn, self.adapter = dsn, adapter
        self.embed_dims, self.compute_dtype = dims, dtype
        stems = [ConvBN(3, dims[0] // 2, 3, 2, 1, norm=spec, dtype=dtype),  # RGB in
                 ConvBN(dims[0] // 2, dims[0], 3, 2, 1, norm=spec, dtype=dtype)]
        if dsn:
            self.stem_1, self.stem_2 = stems
        else:
            self.stem = nn.ModuleList(stems)
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbed(dims[max(i - 1, 0)], dims[i], 1 if i == 0 else 2, spec, dtype)
            for i in range(4))

        def stage(i: int) -> MHSAStage:
            return MHSAStage(dims[i], num_layers[i], num_heads[i], mlp_ratios[i],
                             num_domains, drop_rate, drop_path_rate, sup, dsn,
                             dtype=dtype)

        self.mhsa_stages = nn.ModuleList(stage(i) for i in range(4))
        convs = [Conv2d(dims[3], dims[3], 3, 1, 1, dtype=dtype),
                 Conv2d(dims[3], dims[3] * 2, 3, 1, 1, dtype=dtype)]
        bns = [make_bn(dims[3], spec), make_bn(dims[3] * 2, spec)]
        if dsn:
            self.bridge_conv1, self.bridge_conv2 = convs
            self.bridge_norms1, self.bridge_norms2 = bns
        else:
            self.bridge = nn.Sequential(convs[0], bns[0], nn.ReLU(),
                                        convs[1], bns[1], nn.ReLU())
        in_chs = (dims[3] * 2,) + dims[:0:-1]  # 1024, 512, 320, 128
        for n in range(1, 5):
            self.add_module(f"decoder{n}", UnetDecodingBlockTransformer(
                in_chs[n - 1], dims[4 - n], stage(4 - n), norm=spec, dtype=dtype))
        if adapter is not None:
            # base_sota_adapt.py:346-351, 524-528
            make = ((lambda c: DomainAttention(c, 16, dtype=dtype)) if adapter == "DASE"
                    else (lambda c: SEBlock(c, 8, dtype=dtype)))
            for i in range(4):
                self.add_module(f"enc_adapter{i}", make(dims[i]))
            for i in range(4):
                self.add_module(f"dec_adapter{i}", make(dims[3 - i]))
            if adapter == "USE":
                self.bridge_adapter = SEBlock(dims[3] * 2, 8, dtype=dtype)

    def _stems(self) -> List[ConvBN]:
        return [self.stem_1, self.stem_2] if self.dsn else list(self.stem)

    def _bridge(self) -> Tuple[nn.Module, nn.Module, nn.Module, nn.Module]:
        if self.dsn:
            return (self.bridge_conv1, self.bridge_norms1, self.bridge_conv2,
                    self.bridge_norms2)
        conv1, bn1, _, conv2, bn2, _ = self.bridge
        return conv1, bn1, conv2, bn2

    def forward_features(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                         train: bool = False, gen: torch.Generator | None = None,
                         out_seg: bool = True):
        """(encoder_outs, bridge_out, decoder_feat), NHWC; the decoder
        feature is at H/4. Without ``out_seg`` the bridge and the decoders
        are skipped and both are None (``base.py:448-450``)."""
        for conv_bn in self._stems():
            x = conv_bn(x, domain_onehot, train)
        encoder_outs = []
        for i, (embed, stage) in enumerate(zip(self.patch_embed_stages, self.mhsa_stages)):
            x = embed(x, domain_onehot, train)
            size = (x.shape[1], x.shape[2])
            x = stage(x.flatten(1, 2), size, domain_onehot, train, gen).unflatten(1, size)
            if self.adapter == "DASE":  # replaces the stream (base_sota_adapt.py:421-423)
                x = getattr(self, f"enc_adapter{i}")(x)
                encoder_outs.append(x)
            elif self.adapter == "USE":  # adapts the skip copy only (:598-599)
                encoder_outs.append(getattr(self, f"enc_adapter{i}")(x))
            else:
                encoder_outs.append(x)
        if not out_seg:
            return encoder_outs, None, None
        conv1, bn1, conv2, bn2 = self._bridge()
        out = F.relu(bn1(conv1(encoder_outs[3]), domain_onehot, train))
        out = F.relu(bn2(conv2(out), domain_onehot, train))
        if self.adapter == "USE":
            out = self.bridge_adapter(out)
        bridge_out = out
        for n in range(1, 5):
            out = getattr(self, f"decoder{n}")(out, encoder_outs[4 - n], domain_onehot,
                                               train, gen)
            if self.adapter is not None:
                out = getattr(self, f"dec_adapter{n - 1}")(out)
        return encoder_outs, bridge_out, out


class BASE(FATEncoderDecoder):
    """BASE, BASE+Sup, BASE_DSN, BASE_DASE and BASE_USE (``base.py:185-236``):
    the trunk plus a 1×1 ``finalconv`` head, no debranch."""

    # what has no row-sharded form (parallel/context.py): nothing
    context_parallel_gap: str | None = None

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        self.finalconv = nn.Sequential(Conv2d(self.embed_dims[0], 1, 1,
                                              dtype=self.compute_dtype))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                train: bool = False, out_feat: bool = True, out_seg: bool = True,
                aux_mode: str = "none", gen: torch.Generator | None = None
                ) -> dict[str, Any]:
        """``{"seg": logits (B, H, W, 1), "feat": (B, C₄)}``, ``feat`` the
        spatial mean of stage 4 (None without ``out_feat``), ``seg`` None
        without ``out_seg``. BASE has no debranch, so ``aux_mode`` can only
        be ``"none"``."""
        if aux_mode != "none":
            raise ValueError(f"BASE has no debranch: aux_mode {aux_mode!r}")
        encoder_outs, _, dec = self.forward_features(x, domain_onehot, train, gen,
                                                     out_seg)
        feat = spatial_mean(encoder_outs[3]) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        # the 1×1 finalconv commutes with the upsample: conv at H/4, resize 1 channel
        logits = resize_bilinear(self.finalconv(dec), (x.shape[1], x.shape[2]))
        return {"seg": logits, "feat": feat}
