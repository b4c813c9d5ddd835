"""Conditional flow-matching super-resolution denoiser (stage 1).

Counterpart of the JAX package's ``models/flow_model.py``: embeds cell
geometry (eta/cosphi/sinphi), calorimeter layer, proxy energy and the noisy
per-cell state, each conditioned on the timestep embedding; pools a
masked-mean global conditioning vector; runs a transformer stack over the
cell set; skip-concatenates the conditional features; optional final adaLN
modulation; and predicts a per-cell scalar velocity.  The stack is the DiT
(``type: DiT``) or the GPT-2 + Normformer encoder (``type:
GPT-2+Normformer``, models/transformer.py; padding masks only, and the fused
prologue and remat do not apply to it).  ``etaphi_emb.fourier_features: K``
appends sin and cos of eta and of the phi angle at the octaves 2^k pi,
k < K, to the geometry input, in fp32.  A segment-packed batch (``batch["seg"]``) carries
several events per row: the pooled context becomes per segment (and per cell
for the Dense concat paths), and attention stays within a segment.

``dtype`` is the compute dtype (Flax ``dtype=``): every module but the
geometry embedder casts its weights to it at use, so fp32 parameters train
under bf16 compute.  ``remat`` recomputes each DiT layer in the backward.

Parallelism (DiT only, as in the JAX package; the parallel entry points are
in parallel/sp.py and parallel/tp.py): with ``sp_group`` the cell axis
arrives sharded over that process group — the pooled context sums over it
and attention gathers (``sp_mode='gather'``) or rotates (``'ring'``) the
keys; with ``tp_group`` the DiT layers hold head and MLP shards.  Packed
batches are refused under ``sp_group``.

Config layout is identical to the ``flow_model`` YAML block; parameter names
are the reference checkpoint's (see tools/convert.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.flash_packed import SEG_ALIGN
from ..ops.masked import masked_mean, segment_mean, segment_onehot
from .dense import Dense, LayerNorm, cast
from .dit import DiTEncoder, adaln_modulation, modulate, scatter_segments
from .embed import TimestepEmbedder
from .transformer import TransformerEncoder

N_CALO_LAYERS = 3  # ECAL layers kept after the layer<3 cut


class FlowModel(nn.Module):
    def __init__(self, config: dict, attn_impl: str = "auto", fused_prologue: bool = False, dtype=None,
                 remat: bool = False, sp_group=None, sp_mode: str = "gather", tp_group=None):
        """config: the ``flow_model`` config block."""
        super().__init__()
        self.compute_dtype = dtype
        cfg = self.config = config
        self.n_fourier = int(cfg["etaphi_emb"].get("fourier_features", 0) or 0)
        tcfg = cfg["transformer"]
        if tcfg["type"] not in ("DiT", "GPT-2+Normformer"):
            raise ValueError(f"unknown transformer type {tcfg['type']!r}")
        if tcfg["type"] != "DiT" and (sp_group is not None or tp_group is not None):
            raise NotImplementedError("sequence and tensor parallelism require the DiT transformer")
        self.sp_group = sp_group
        C = int(cfg["time_embedding_size"])
        h_dim = int(cfg["h_dim"])

        self.time_step_embedder = TimestepEmbedder(C, dtype=dtype)
        emb_dim = int(cfg["layer_emb"]["emb_dim"])
        self.layer_emb_table = nn.Embedding(N_CALO_LAYERS, emb_dim)
        self.layer_emb_net = Dense.from_config(
            dict(cfg["layer_emb"]["dense_config"], context_size=C), input_size=emb_dim, dtype=dtype
        )
        # geometry embedder: no compute dtype, its weights stay fp32 under a
        # bf16 model (models/precision.py) and it is fed fp32 inputs, so it
        # computes in full fp32 (TF32 off) — bf16 inputs would quantize
        # normalized eta below the HR subcell half-pitch, the SR task's whole
        # signal.
        self.etaphi_emb_net = Dense.from_config(dict(cfg["etaphi_emb"], context_size=C),
                                                input_size=3 + 4 * self.n_fourier)
        self.proxy_emb_net = Dense.from_config(dict(cfg["e_proxy_emb"], context_size=C), input_size=1, dtype=dtype)
        self.noisy_input_emb_net = Dense.from_config(
            dict(cfg["noisy_input_emb"], context_size=C), input_size=1, dtype=dtype
        )

        cond_dim = (
            cfg["etaphi_emb"]["output_size"]
            + cfg["layer_emb"]["dense_config"]["output_size"]
            + cfg["e_proxy_emb"]["output_size"]
            + 1
        )
        ctx = C + cond_dim  # [time_emb ‖ pooled conditional features]
        self.feat_0_mlp = Dense.from_config(
            dict(cfg["feat_0_mlp"], context_size=ctx),
            input_size=cond_dim + cfg["noisy_input_emb"]["output_size"],
            dtype=dtype,
        )
        if int(cfg["feat_0_mlp"]["output_size"]) != h_dim:
            raise ValueError("feat_0_mlp.output_size must equal h_dim")
        self.normformer = tcfg["type"] == "GPT-2+Normformer"
        if self.normformer:
            self.transformer = TransformerEncoder(
                embed_dim=h_dim,
                num_layers=tcfg["num_transformer_layers"],
                num_heads=tcfg["num_heads"],
                dense_config=dict(tcfg["dense_config"]),
                attn_impl=attn_impl,
                dtype=dtype,
            )
        else:
            self.transformer = DiTEncoder(
                embed_dim=h_dim,
                num_layers=tcfg["num_transformer_layers"],
                num_heads=tcfg["num_heads"],
                context_size=ctx,
                dense_config=dict(tcfg["dense_config"]),
                attn_impl=attn_impl,
                fused_prologue=fused_prologue,
                dtype=dtype,
                remat=remat,
                sp_group=sp_group,
                sp_mode=sp_mode,
                tp_group=tp_group,
            )
        feat_dim = h_dim + cond_dim
        self.final_modulation = bool(cfg.get("final_modulation", False))
        if self.final_modulation:
            self.v_t_adaLN_modulation = adaln_modulation(ctx, 2 * feat_dim, dtype=dtype)
            self.norm_v_t = LayerNorm(feat_dim, dtype=dtype)
        self.v_t_pred_net = Dense.from_config(
            dict(cfg["v_t_pred"], context_size=ctx), input_size=feat_dim, dtype=dtype
        )

    @property
    def dtype(self):
        """Compute dtype of the dense stack (the geometry embedder aside)."""
        return self.feat_0_mlp.linears[0].dtype

    def load_reference_state_dict(self, state_dict, strict: bool = True):
        """Load a reference-layout ``state_dict`` (keys ``net.*`` as in the
        Lightning checkpoints and tools/convert.py, or already stripped);
        tensors are cast to each parameter's current dtype."""
        sd = {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}
        return self.load_state_dict(sd, strict=strict)

    def forward(self, batch, noisy_input, time_step):
        """batch: dict with (B,N,1) float features ``eta,cosphi,sinphi,e_proxy``,
        (B,N,1) int ``layer`` and (B,N) bool ``q_mask`` (True==valid), and
        for a packed batch ``seg`` (B,N) int (-1 = padding).
        noisy_input: (B,N,1); time_step: (B,). Returns v_t (B,N,1)."""
        time_emb = self.time_step_embedder(time_step)

        eta, cosphi, sinphi = batch["eta"], batch["cosphi"], batch["sinphi"]
        layer, e_proxy, q_mask = batch["layer"], batch["e_proxy"], batch["q_mask"]

        # gather in the table's dtype, then cast: the backward then sums the
        # per-cell cotangents into the table in fp32, not in bf16
        layer_tab = cast(self.layer_emb_table.weight[layer.squeeze(-1).long()], self.compute_dtype)
        layer_emb = self.layer_emb_net(layer_tab, context=time_emb)

        geo = torch.cat([eta, cosphi, sinphi], dim=-1).float()
        if self.n_fourier:
            freqs = (2.0 ** torch.arange(self.n_fourier, dtype=torch.float32, device=geo.device)) * math.pi
            phi_ang = torch.atan2(sinphi.float(), cosphi.float())
            ang = torch.cat([eta.float() * freqs, phi_ang * freqs], dim=-1)  # (..., 2K)
            geo = torch.cat([geo, torch.sin(ang), torch.cos(ang)], dim=-1)
        etaphi_emb = self.etaphi_emb_net(geo, context=time_emb.float()).to(self.dtype)

        e_proxy_emb = self.proxy_emb_net(e_proxy, context=time_emb)

        # mixed dtypes promote (fp32 e_proxy wins over bf16 embeddings)
        cond_feat = torch.cat([etaphi_emb, layer_emb, e_proxy_emb, e_proxy], dim=-1)
        seg = batch.get("seg")
        if seg is not None and self.normformer:
            raise NotImplementedError("segment packing requires the DiT transformer")
        if seg is not None:
            n_seg = seg.shape[1] // SEG_ALIGN  # the packer aligns events to this
            seg_onehot = segment_onehot(seg, n_seg, cond_feat.dtype)  # (B, S, E)
            cond_seg = segment_mean(cond_feat, seg_onehot)  # (B, E, C)
        else:
            cond_feat_global = masked_mean(cond_feat, q_mask, axis=1, group=self.sp_group)

        noisy_input_emb = self.noisy_input_emb_net(noisy_input, context=time_emb)

        # context = [time_emb ‖ pooled conditional features]
        if seg is not None:
            # per segment for the modulation nets, scattered per cell for the
            # Dense concat paths
            B, E = seg_onehot.shape[0], seg_onehot.shape[2]
            context_seg = torch.cat([time_emb[:, None, :].expand(B, E, time_emb.shape[-1]), cond_seg], dim=-1)
            context = scatter_segments(seg_onehot, context_seg, seg)
            seg_kw = dict(context_seg=context_seg, seg_onehot=seg_onehot, segment_ids=seg)
        else:
            context_seg = None
            context = torch.cat([time_emb, cond_feat_global], dim=-1)
            seg_kw = {}

        feat_0 = torch.cat([cond_feat, noisy_input_emb], dim=-1)
        feat = self.feat_0_mlp(feat_0, context=context)

        if self.normformer:
            feat = self.transformer(feat, valid=q_mask, context=context)
        else:
            feat = self.transformer(feat, q_valid=q_mask, context=context, **seg_kw)

        # final skip connection with the conditional features
        feat = torch.cat([feat, cond_feat], dim=-1)

        if self.final_modulation:
            mod = self.v_t_adaLN_modulation(context_seg if context_seg is not None else context)
            if context_seg is not None:
                mod = scatter_segments(seg_onehot, mod, seg)
            v_t_shift, v_t_scale = mod.chunk(2, dim=-1)
            feat = modulate(self.norm_v_t(feat), v_t_shift, v_t_scale)

        return self.v_t_pred_net(feat, context=context)
