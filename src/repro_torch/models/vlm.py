"""InternVL2-style VLM: stubbed ViT frontend + InternLM2 (llama-arch) backbone.

Twin of ``repro.models.vlm``. The vision tower is a stub: the batch
provides already-projected patch embeddings (B, n_vis_tokens, d_model) —
InternViT + the MLP projector's output. They are prepended to the text
embeddings as a causal prefix; the loss is masked to text positions.
Decode is ``DenseLM``'s, unchanged: like the reference, the model has no
call that puts a visual prefix into the cache. Over a ``model`` axis the
lookup and the loss are ``DenseLM``'s vocab-parallel ones (internvl2-2b's
odd vocab of 92553 keeps ``embed`` and ``unembed`` whole over it); over a
``data`` axis the prefix path gathers ``embed`` once, as ``hidden`` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import DenseLM


class InternVLM(DenseLM):
    def hidden_mm(self, params, tokens, vis_embed):
        """Final-normed hidden states (B, Nv + S, D) of the visual prefix
        followed by the tokens (looked up without ``embed_scale``, as the
        reference's ``_lookup``), at positions 0..Nv+S-1."""
        cfg = self.cfg
        params = self._zero_top(params)
        xt = self._lookup(params["embed"], tokens)
        x = torch.cat([vis_embed.to(cfg.dtype), xt.to(cfg.dtype)], dim=1)
        return self._backbone(params, x)

    def logits_mm(self, params, tokens, vis_embed):
        params = self._zero_top(params)
        return self._unembed(params, self.hidden_mm(params, tokens, vis_embed))

    def loss(self, params, batch):
        tokens = batch["tokens"]
        vis = batch["vis_embed"]
        Nv = vis.shape[1]
        params = self._zero_top(params)
        h = self.hidden_mm(params, tokens[:, :-1], vis)
        # text-only loss: positions [Nv-1, Nv+S-2) predict tokens[:, 1:]
        h_text = h[:, Nv - 1 : -1] if Nv > 0 else h
        return self._xent(params, h_text[:, : tokens.shape[1] - 1], tokens[:, 1:])
