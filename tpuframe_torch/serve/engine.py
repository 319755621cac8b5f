"""Prefill/decode engine over :class:`TransformerLM` (counterpart of
``tpuframe/serve/engine.py``).

  prefill  one prompt, batch 1, padded to its bucket: causal attention
           over the padded prompt (the training forward's math, through
           the flash kernel when ``attn_impl="pallas"``) plus the KV write
           into a fresh single-slot cache; the first token is the greedy
           argmax at ``length - 1``.
  insert   copies a prefilled single-slot cache into one slot of the
           shared decode cache.
  decode   one step over every slot at once: ring KV write at each
           slot's own index, query-length-1 attention, greedy argmax.
           Lengths advance for every slot; inactive slots decode garbage
           the scheduler ignores.

PyTorch runs eagerly, so there is no ahead-of-time program table: the
shapes are still the closed set of buckets, and the decode cache,
lengths and tokens are updated in place (the JAX engine donates those
buffers to its compiled programs for the same effect).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpuframe_torch import _device
from tpuframe_torch.models.transformer_lm import TransformerLM
from tpuframe_torch.serve import kv_cache as kv


class LMEngine:
    """Bucketed serving engine for :class:`TransformerLM`; owns the
    decode cache (``slots`` concurrent sequences).

    ``params`` is a ``state_dict`` of the port's model (for one,
    :func:`tpuframe_torch.models.convert.params_from_jax`); without it
    the weights are random, drawn from ``seed``."""

    def __init__(self, cfg, params=None, *, slots: int = 4,
                 max_context: int | None = None, prompt_buckets=None,
                 decode_block: int | None = None, eos_id: int | None = None,
                 seed: int = 0, device="cuda"):
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.eos_id = eos_id
        self.last_prefill_ms = 0.0
        self.decode_block = (decode_block if decode_block is not None
                             else kv.resolve_decode_block())
        buckets = (tuple(prompt_buckets) if prompt_buckets is not None
                   else kv.resolve_buckets())
        self.prompt_buckets = tuple(sorted(set(buckets)))
        max_context = max_context or max(self.prompt_buckets)
        capacity = kv.capacity_for(max_context, self.decode_block)
        problems = kv.check_buckets(self.prompt_buckets, capacity)
        if problems:
            raise ValueError("; ".join(problems))
        self.spec = kv.spec_for_model(cfg, slots=slots, capacity=capacity)
        self.model = TransformerLM(cfg, device=self.device, seed=seed)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval().requires_grad_(False)
        self.reset()

    def reset(self) -> None:
        """Fresh (zeroed) decode cache; every slot becomes free."""
        self._layers, self._lengths = kv.init_cache(self.spec, self.device)
        self._tokens = torch.zeros((self.spec.slots, 1), dtype=torch.int64,
                                   device=self.device)

    @property
    def slots(self) -> int:
        return self.spec.slots

    @torch.no_grad()
    def prefill(self, token_ids) -> tuple:
        """Run one prompt through its bucket.  Returns ``(first_token: int,
        prefill_cache, length: int)``."""
        ids = [int(t) for t in token_ids]
        if not ids:
            raise ValueError("empty prompt")
        bucket = kv.bucket_for(len(ids), self.prompt_buckets)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :len(ids)] = torch.tensor(ids)
        t0 = time.monotonic()
        shape = (1,) + self.spec.layer_shape()[1:]
        dtype = self.cfg.torch_dtype
        pcache = tuple((torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device))
                       for _ in range(self.cfg.num_layers))
        logits, pcache = self.model(
            padded.to(self.device), kv_cache=pcache,
            cache_length=torch.zeros((1,), dtype=torch.int64,
                                     device=self.device))
        first = int(logits[0, len(ids) - 1].argmax())  # host sync
        self.last_prefill_ms = 1e3 * (time.monotonic() - t0)
        return first, pcache, len(ids)

    @torch.no_grad()
    def insert(self, slot: int, pcache, length: int,
               first_token: int) -> None:
        """Admit a prefilled request into ``slot`` of the decode batch."""
        if not 0 <= slot < self.spec.slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.spec.slots})")
        for (k, v), (pk, pv) in zip(self._layers, pcache):
            k[slot].copy_(pk[0])
            v[slot].copy_(pv[0])
        self._lengths[slot] = length
        self._tokens[slot, 0] = first_token

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """One decode step over every slot.  Returns the new token per
        slot (host numpy ``[slots]``; inactive slots carry garbage)."""
        logits, _ = self.model(self._tokens, kv_cache=self._layers,
                               cache_length=self._lengths, decode=True)
        self._tokens = logits[:, 0].argmax(dim=-1, keepdim=True)
        self._lengths += 1
        return self._tokens[:, 0].cpu().numpy()


def golden_parity_check(cfg, *, buckets, capacity: int,
                        decode_tokens: int = 4, seed: int = 0,
                        atol: float = 2e-5, device="cuda") -> list:
    """Prefill-then-decode must reproduce the full forward's logits
    position by position, for every prompt bucket (a full bucket and a
    ragged prompt).  Returns problem strings; [] means parity holds."""
    problems = [f"bucket {b}: prompt+decode {b + decode_tokens} exceeds "
                f"capacity {capacity}"
                for b in buckets if b + decode_tokens > capacity]
    if problems:
        return problems
    diffs = parity_diffs(cfg, buckets=buckets, capacity=capacity,
                         decode_tokens=decode_tokens, seed=seed,
                         device=device)
    return [f"bucket {b} prompt_len {n}: max |logit diff| {d:.2e} > "
            f"{atol:.0e}" for (b, n), d in diffs.items() if not d <= atol]


@torch.no_grad()
def parity_diffs(cfg, *, buckets, capacity: int, decode_tokens: int = 4,
                 seed: int = 0, device="cuda") -> dict:
    """``{(bucket, prompt_len): max |logit diff|}`` between the full
    forward and prefill-then-decode, for a full and a ragged prompt per
    bucket, on random weights and token ids drawn from ``seed``."""
    device = _device.resolve(device)
    model = TransformerLM(cfg, device=device, seed=seed).eval()
    gen = torch.Generator().manual_seed(seed)
    diffs = {}
    for bucket in buckets:
        for prompt_len in sorted({bucket, max(2, bucket - 3)}):
            total = prompt_len + decode_tokens
            ids = torch.randint(0, cfg.vocab_size, (1, total),
                                generator=gen).to(device)
            ref = model(ids)
            shape = (1, capacity, cfg.num_heads, cfg.head_dim)
            layers = tuple(
                (torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                 torch.zeros(shape, dtype=cfg.torch_dtype, device=device))
                for _ in range(cfg.num_layers))
            length = torch.zeros((1,), dtype=torch.int64, device=device)
            got, _ = model(ids[:, :prompt_len], kv_cache=layers,
                           cache_length=length)
            outs = [got]
            length = length + prompt_len
            for t in range(prompt_len, total):
                lg, _ = model(ids[:, t:t + 1], kv_cache=layers,
                              cache_length=length, decode=True)
                outs.append(lg)
                length = length + 1
            diffs[(bucket, prompt_len)] = float(
                (ref - torch.cat(outs, dim=1)).abs().max())
    return diffs
