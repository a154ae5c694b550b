"""MDViT (``mdvit_tpu/models/mdvit.py``): the factorized-attention U-Net
(Sup gate by default, per-domain norms with ``dsn``), a 1×1 ``finalconv``
head and one debranch a domain, ``debranch{1..D}`` (reference names), of
the kind ``decoder_name`` names:

* ``"MLPFM"`` (the flagship): ``MLPDecoderFM`` over the four encoder
  scales and the H/4 decoder feature;
* ``"MLP"``: ``MLPDecoder`` over the four encoder scales;
* ``"DeepLabV3"``: ``DeepLabV3Decoder`` (ASPP) over the H/32 scale;
* ``"Transformer"`` (MDViTᵀ): ``TransformerDebranch``, a whole transformer
  decoder over the encoder scales and the bridge output.

Aux modes:

* ``"none"`` (serving): ``{"seg": (logits, None), "feat": ...}``;
* ``"grouped"`` (the MKD train step): the batch is D equal domain-contiguous
  groups; each debranch runs on its own domain's group only, so only its BN
  stats move, and the aux logits are re-stacked to (D·B, H, W, 1). Under
  data parallelism the batch is a rank's rows of the global one
  (``parallel.mesh.current_shard``): each row goes to its global domain's
  debranch, every debranch runs on every rank (on no rows, where the rank
  holds none of its domain), so the BatchNorms' collectives line up, and
  its dropout counters are the rows' places in their domain's group (JAX
  vmaps the debranches with split dropout streams);
* ``"select"`` (eval of mixed-domain batches): every debranch runs on the
  whole batch in eval mode and each sample's one-hot picks its output;
* ``"features"`` (the eval step): the debranches are skipped and the output
  carries ``aux_features``; the caller applies ``debranch_module(d)``, the
  one debranch of a single-domain batch's domain.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from mdvit_tpu_torch.models.base import FATEncoderDecoder
from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.decoders import (DeepLabV3Decoder, MLPDecoder, MLPDecoderFM,
                                             UnetDecodingBlockTransformer)
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.mesh import current_shard, domain_slices, sharded

DECODERS = ("MLPFM", "MLP", "DeepLabV3", "Transformer")


class TransformerDebranch(nn.Module):
    """The MDViTᵀ debranch (``mdvit.py:TransformerDebranch``): four transformer
    decoding blocks ``decoder{1..4}`` from the bridge output back to H/4,
    with plain stages (no Sup gate, shared norms), then a 1×1 ``finalconv``
    and the resize. The attention blocks run kernels A, B and C on the
    debranch's own group of samples."""

    def __init__(self, img_size: int, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8), drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = tuple(embed_dims)
        in_chs = (dims[3] * 2,) + dims[:0:-1]
        for n in range(1, 5):
            i = 4 - n
            stage = MHSAStage(dims[i], num_layers[i], num_heads[i], mlp_ratios[i], 1,
                              drop_rate, drop_path_rate, sup=False, dsn=False, dtype=dtype)
            self.add_module(f"decoder{n}", UnetDecodingBlockTransformer(
                in_chs[n - 1], dims[i], stage, dtype=dtype))
        self.finalconv = Conv2d(dims[0], 1, 1, dtype=dtype)
        self.img_size = (img_size, img_size)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """features: [s0, s1, s2, s3, bridge output]."""
        out = features[-1]
        for n in range(1, 5):
            out = getattr(self, f"decoder{n}")(out, features[4 - n], None, train, gen)
        return resize_bilinear(self.finalconv(out), self.img_size)


class MDViT(FATEncoderDecoder):
    def __init__(self, img_size: int = 256,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8),
                 num_domains: int = 4, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, adapt: str | None = "Sup",
                 dsn: bool = False, decoder_name: str = "MLPFM",
                 bn_domain_stats: bool = True, dtype: torch.dtype = torch.float32):
        if decoder_name not in DECODERS:
            raise ValueError(f"unknown decoder_name {decoder_name!r}; have {DECODERS}")
        super().__init__(num_layers, embed_dims, mlp_ratios, num_heads, num_domains,
                         drop_rate, drop_path_rate, adapt=adapt, dsn=dsn,
                         bn_domain_stats=bn_domain_stats, dtype=dtype)
        self.num_domains = num_domains
        self.decoder_name = decoder_name
        dims = self.embed_dims
        size = (img_size, img_size)
        self.finalconv = nn.Sequential(Conv2d(dims[0], 1, 1, dtype=dtype))
        for d in range(1, num_domains + 1):
            if decoder_name == "MLPFM":
                branch = MLPDecoderFM(dims, dims[0], img_size=size, dtype=dtype)
            elif decoder_name == "MLP":
                branch = MLPDecoder(dims, img_size=size, dtype=dtype)
            elif decoder_name == "DeepLabV3":
                branch = DeepLabV3Decoder(dims[3], img_size=size, dtype=dtype)
            else:
                branch = TransformerDebranch(img_size, dims, num_layers, mlp_ratios,
                                             num_heads, drop_rate, drop_path_rate, dtype)
            self.add_module(f"debranch{d}", branch)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                train: bool = False, out_feat: bool = False, aux_mode: str = "none",
                gen: torch.Generator | None = None, out_seg: bool = True) -> dict[str, Any]:
        """x (B, H, W, 3) normalised images, domain_onehot (B, D); ``gen``
        drives dropout and stochastic depth when ``train``.

        Returns ``{"seg": (logits (B, H, W, 1), aux logits or None),
        "feat": (B, C₄) or None}``; ``feat`` is the spatial mean of stage 4
        when ``out_feat``. Without ``out_seg`` only the encoder runs and
        ``seg`` is None (``mdvit.py:152-155``)."""
        if aux_mode not in ("none", "grouped", "select", "features"):
            raise ValueError(f"unknown aux_mode {aux_mode!r}")
        encoder_outs, bridge_out, dec = self.forward_features(x, domain_onehot, train, gen,
                                                              out_seg)
        feat = encoder_outs[3].mean(dim=(1, 2)) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        # the 1×1 finalconv commutes with the upsample: conv at H/4, resize 1 channel
        logits = resize_bilinear(self.finalconv(dec), (x.shape[1], x.shape[2]))
        # what each debranch reads (mdvit.py:163-168)
        if self.decoder_name == "Transformer":
            features = [*encoder_outs, bridge_out]
        elif self.decoder_name == "MLPFM":
            features = [*encoder_outs, dec]
        else:
            features = list(encoder_outs)
        d = self.num_domains
        aux = None
        if aux_mode == "grouped":
            shard, b = current_shard(), x.shape[0]
            total = shard.total or b
            if total % d:
                raise ValueError(f"grouped aux_mode needs batch ({total}) divisible "
                                 f"by num_domains ({d}), domain-contiguous")
            per, outs, start = total // d, [], 0
            for i, (lo, hi) in enumerate(domain_slices(shard.row0, b, d, per)):
                part = [f[start:start + hi - lo] for f in features]
                start += hi - lo
                with sharded(shard._replace(row0=lo, total=per)):
                    outs.append(self.debranch_module(i)(part, train, gen))
            aux = torch.cat(outs)
        elif aux_mode == "select":
            outs = torch.stack([self.debranch_module(i)(features, False)
                                for i in range(d)])  # (D, B, H, W, 1)
            aux = torch.einsum("dbhwc,bd->bhwc", outs, domain_onehot.to(outs.dtype))
        elif aux_mode == "features":
            return {"seg": (logits, None), "feat": feat, "aux_features": features}
        return {"seg": (logits, aux), "feat": feat}

    def debranch_module(self, domain: int) -> nn.Module:
        """The debranch of ``domain`` (0-based), for a single-domain batch
        (reference dispatch, ``mdvit.py:714-724``)."""
        return getattr(self, f"debranch{domain + 1}")
