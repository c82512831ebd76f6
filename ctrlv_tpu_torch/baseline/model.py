"""AR bbox predictor LM: an encoder-decoder transformer, in f32.

Counterpart of ``ctrlv_tpu/baseline/model.py``: a state MLP over
(bbox4 ++ type) plus tokenized-action embeddings (two corner tokens, concat
and linear), agent-id and sinusoidal timestep embeddings, existence masking,
an encoder over the conditioning frames (the first K, and the last) with
optional image-context tokens appended, a post-LN decoder under the
block-causal mask with cross-attention to the encoder, and an MLP head to 2
action tokens x vocab (or the coords-token and coords-regression variants,
and the optional existence head). ``loss`` is the JAX package's.

Parameter names are the JAX module's after ``convert.py``: ``encoder.0``,
``decoder.1.cross_attn_q``, ``embed_action`` (an ``nn.Embedding``), the
LayerNorms ``norm1..3`` and ``embedding_layer_norm`` with flax's default
eps of 1e-6.

Masking follows the JAX layer exactly: a masked logit is filled with -1e9
(never -inf), so a query whose every key is masked gets uniform weights
where -inf would give NaN; and the key padding is taken as the JAX layer
takes it, ``~key_pad`` marking the keys that stay (ROADMAP §3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm
from .actions import discretize_actions, discretize_coords
from .config import BaselineConfig


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    pos = torch.arange(max_len, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((max_len, dim), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def block_causal_mask(num_timesteps: int, num_agents: int, device=None) -> torch.Tensor:
    """(T*N, T*N) bool: token (t, a) attends to every token with t' <= t."""
    t_of = torch.arange(num_timesteps * num_agents, device=device) // num_agents
    return t_of[None, :] <= t_of[:, None]


class MLPLayer(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class TransformerLayer(nn.Module):
    """Post-LN layer: attn -> add & norm -> [cross -> add & norm] -> relu FF
    -> add & norm."""

    def __init__(self, hidden: int, heads: int, ffn: int, cross: bool = False):
        super().__init__()
        self.heads = heads
        names = ("self_attn", "cross_attn") if cross else ("self_attn",)
        for name in names:
            for proj in ("q", "k", "v", "o"):
                setattr(self, f"{name}_{proj}", nn.Linear(hidden, hidden))
        self.norm1 = LayerNorm(hidden, 1e-6)
        self.norm2 = LayerNorm(hidden, 1e-6) if cross else None
        self.norm3 = LayerNorm(hidden, 1e-6)
        self.linear1 = nn.Linear(hidden, ffn)
        self.linear2 = nn.Linear(ffn, hidden)

    def mha(self, q, kv, mask, name: str):
        b, sq, c = q.shape
        hd = c // self.heads
        qq = getattr(self, f"{name}_q")(q).reshape(b, sq, self.heads, hd)
        kk = getattr(self, f"{name}_k")(kv).reshape(b, kv.shape[1], self.heads, hd)
        vv = getattr(self, f"{name}_v")(kv).reshape(b, kv.shape[1], self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qq, kk) / math.sqrt(hd)
        if mask is not None:
            logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vv).reshape(b, sq, c)
        return getattr(self, f"{name}_o")(out)

    def forward(self, x, attn_mask=None, key_pad=None, memory=None, mem_pad=None):
        mask = None if attn_mask is None else attn_mask[None, None]
        if key_pad is not None:
            kp = (~key_pad)[:, None, None, :]
            mask = kp if mask is None else (mask & kp)
        x = self.norm1(x + self.mha(x, x, mask, "self_attn"))
        if self.norm2 is not None:
            cmask = None if mem_pad is None else (~mem_pad)[:, None, None, :]
            x = self.norm2(x + self.mha(x, memory, cmask, "cross_attn"))
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm3(x + h)


class BboxPredictorLM(nn.Module):
    def __init__(self, cfg: BaselineConfig = BaselineConfig()):
        super().__init__()
        self.cfg = cfg
        hidden, n, vocab = cfg.hidden_dim, cfg.max_num_agents, cfg.vocabulary_size
        self.embed_state = MLPLayer(cfg.state_dim + 1, hidden, hidden)
        self.embed_action = nn.Embedding(vocab, hidden)
        self.embed_action_combine = nn.Linear((4 if cfg.pred_coords else 2) * hidden, hidden)
        self.embed_agent_id = nn.Embedding(n, hidden)
        self.encoder = nn.ModuleList(
            TransformerLayer(hidden, cfg.num_heads, cfg.dim_feedforward)
            for _ in range(cfg.num_encoder_layers))
        self.embedding_layer_norm = LayerNorm(hidden, 1e-6)
        self.decoder = nn.ModuleList(
            TransformerLayer(hidden, cfg.num_heads, cfg.dim_feedforward, cross=True)
            for _ in range(cfg.num_decoder_layers))
        if cfg.pred_coords and cfg.regression:
            self.predict_coords = MLPLayer(hidden, hidden, 4)
        else:
            self.predict_actions = MLPLayer(hidden, hidden, vocab * (4 if cfg.pred_coords else 2))
        if cfg.existence_head:
            self.predict_existence = MLPLayer(hidden, hidden, 1)

    def forward(
        self,
        data: Dict[str, torch.Tensor],
        image_tokens: Optional[torch.Tensor] = None,  # (B, M, hidden) context
        actions_override: Optional[torch.Tensor] = None,  # tokens for rollout
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        hidden = cfg.hidden_dim
        n = cfg.max_num_agents
        bboxes = data["bboxes"][:, :, :n]
        type_ids = data["type_ids"][:, :, :n]
        existence = data["existence"][:, :, :n].float()
        b, t = bboxes.shape[:2]
        device = bboxes.device

        if cfg.last_frame_traj:
            x1, y1, x2, y2 = (bboxes[:, -1, :, i] for i in range(4))
            cx = (torch.maximum(x1, x2) + torch.minimum(x1, x2)) / 2
            cy = (torch.maximum(y1, y2) + torch.minimum(y1, y2)) / 2
            last = torch.stack([cx, cy, torch.zeros_like(cx), torch.zeros_like(cy)], -1)
            bboxes = torch.cat([bboxes[:, :-1], last[:, None]], dim=1)

        # --- embeddings ------------------------------------------------
        state_emb = self.embed_state(torch.cat([bboxes, type_ids], dim=-1))
        if actions_override is not None:
            tokens = actions_override.to(torch.int32)
        elif cfg.pred_coords:
            tokens = discretize_coords(data["coords"][:, :, :n], cfg.vocabulary_size)
        else:
            tokens = discretize_actions(
                data["actions"][:, :, :n], cfg.dir_disc, cfg.norm_disc).to(torch.int32)
        a_emb = torch.cat([self.embed_action(tokens[..., i].long())
                           for i in range(tokens.shape[-1])], dim=-1)
        action_emb = self.embed_action_combine(a_emb)
        id_emb = self.embed_agent_id.weight[None, None]
        pe = sinusoidal_positions(cfg.num_timesteps, hidden, device)[None, :t, None]
        emb = state_emb + action_emb + id_emb + pe

        if cfg.only_keep_initial_agents:
            init_exist = existence[:, 0:1]
            if cfg.always_predict_initial_agents:
                existence = init_exist.expand(existence.shape)
            else:
                existence = existence * init_exist
        emb = emb * existence

        # valid batches: at least one live agent at every timestep
        valid_batch = torch.all(existence[..., 0].sum(dim=2) > 0, dim=1)

        # --- encoder over conditioning frames --------------------------
        k = cfg.initial_frames_condition_num
        cond_emb, cond_exist = emb[:, :k], existence[:, :k]
        if cfg.condition_last_frame:
            cond_emb = torch.cat([cond_emb, emb[:, -1:]], dim=1)
            cond_exist = torch.cat([cond_exist, existence[:, -1:]], dim=1)
        cond_emb = cond_emb.reshape(b, -1, hidden)
        cond_valid = cond_exist.reshape(b, -1) > 0  # True = attendable
        if image_tokens is not None:
            cond_emb = torch.cat([cond_emb, image_tokens.to(cond_emb.dtype)], dim=1)
            cond_valid = torch.cat(
                [cond_valid, torch.ones(image_tokens.shape[:2], dtype=torch.bool,
                                        device=device)], dim=1)

        enc = cond_emb
        for layer in self.encoder:
            enc = layer(enc, key_pad=cond_valid)
        n_cond = cond_exist.reshape(b, -1).shape[1]
        enc = torch.cat([enc[:, :n_cond] * cond_exist.reshape(b, -1, 1), enc[:, n_cond:]], dim=1)

        # --- decoder over the full token sequence ----------------------
        dec_in = emb if cfg.use_state_embeddings else (action_emb + id_emb + pe) * existence
        dec = self.embedding_layer_norm(dec_in.reshape(b, t * n, hidden))
        tgt_valid = existence[..., 0].reshape(b, t * n) > 0
        causal = block_causal_mask(t, n, device)
        for layer in self.decoder:
            dec = layer(dec, attn_mask=causal, key_pad=tgt_valid, memory=enc, mem_pad=cond_valid)

        out = dict(actions_tokenized=tokens, existence=existence, valid_batch=valid_batch)
        if cfg.pred_coords and cfg.regression:
            out["coord_preds"] = self.predict_coords(dec).reshape(b, t, n, 4)
            out["coords"] = data["coords"][:, :, :n]
        else:
            num_outputs = 4 if cfg.pred_coords else 2
            out["action_preds"] = self.predict_actions(dec).reshape(
                b, t, n, num_outputs, cfg.vocabulary_size)
        if cfg.existence_head:
            out["existence_preds"] = self.predict_existence(dec).reshape(b, t, n)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def loss(cfg: BaselineConfig, outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Shifted CE over action tokens (or coord MSE for the regression
        variant) masked by existence and batch validity."""

        def existence_bce(exist):
            ep = outputs["existence_preds"][:, :-1].float()
            bce = torch.clamp(ep, min=0) - ep * exist + torch.log1p(torch.exp(-ep.abs()))
            return cfg.existence_loss_weight * bce.mean()

        exist = outputs["existence"][:, 1:, :, 0]
        valid = outputs["valid_batch"].float()[:, None, None]
        with_existence = cfg.existence_head and "existence_preds" in outputs
        if "coord_preds" in outputs:
            pred = outputs["coord_preds"][:, :-1].float()
            target = outputs["coords"][:, 1:].float()
            mask = (exist * valid)[..., None]
            loss = ((pred - target) ** 2 * mask).sum() / torch.clamp(mask.sum() * 4, min=1.0)
            loss = loss * cfg.coords_loss_weight
            return loss + existence_bce(exist) if with_existence else loss
        preds = outputs["action_preds"][:, :-1]  # predict t+1 from <= t
        targets = outputs["actions_tokenized"][:, 1:].long()
        logp = torch.log_softmax(preds.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = exist[..., None] * valid[..., None]
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + existence_bce(exist) if with_existence else loss
