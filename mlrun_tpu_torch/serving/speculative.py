"""Batch-1 speculative decoding: a draft model proposes, the target
verifies, and the output is exactly the target's greedy stream —
counterpart of ``mlrun_tpu/serving/speculative.py``.

``SpeculativeDecoder`` runs one stream against dense caches;
``accept_tokens`` is the greedy acceptance rule it shares with the
engines' per-row commit loop (serving/llm_batch.py), which is the main
speculation path: batched draft steps and one multi-token verify dispatch
per scheduler tick (the paged engine through the verify kernel).

Greedy equivalence: proposals are accepted only while they match the
target's own argmax at that position, and the first mismatch is replaced
by the target's argmax, so the emitted stream is the target's plain greedy
stream whatever the draft's quality (which buys only speed). The
(k+1)-token verify forward and a 1-token decode forward round differently,
so an argmax whose top-2 gap is below that noise can tie-break
differently; the tests use permutation models whose gaps are far above
it.

Rollback: rejected positions rewind ``cache['pos']``; their stale entries
are overwritten by the next write before any query can attend them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.llama import LlamaConfig
from ..utils import logger
from .llm import _forward_with_cache, init_kv_cache

Params = dict


def accept_tokens(proposals, verified, k_eff: int) -> tuple[list, int]:
    """The greedy acceptance rule. ``proposals``: the row's ``k_eff``
    draft tokens; ``verified``: the target's argmax at chunk positions
    0..k_eff (position i follows proposal i-1; position 0 follows the
    committed last token).

    Accept while proposal == target argmax; the first mismatch is
    replaced by the target's own argmax. Full acceptance emits the k_eff
    proposals without the bonus token at position k_eff: the draft cache
    holds no KV for it. ``k_eff == 0`` is plain decode: the target's argmax
    after the last token.

    Returns (emitted tokens, n_accept)."""
    n_accept = 0
    while n_accept < k_eff and int(proposals[n_accept]) == int(
            verified[n_accept]):
        n_accept += 1
    if n_accept == k_eff and k_eff > 0:
        emitted = [int(t) for t in proposals]
    else:
        emitted = ([int(t) for t in proposals[:n_accept]]
                   + [int(verified[n_accept])])
    return emitted, n_accept


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    tokens: int = 0
    elapsed_s: float = 0.0
    fallback_rounds: int = 0  # rounds decoded target-only (gate closed)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_round(self) -> float:
        return self.tokens / self.rounds if self.rounds else 0.0

    def to_dict(self) -> dict:
        return {"rounds": self.rounds, "proposed": self.proposed,
                "accepted": self.accepted, "tokens": self.tokens,
                "acceptance_rate": round(self.acceptance_rate, 4),
                "tokens_per_round": round(self.tokens_per_round, 3),
                "fallback_rounds": self.fallback_rounds,
                "elapsed_s": round(self.elapsed_s, 4)}


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class SpeculativeDecoder:
    """Greedy speculative decoding with a small draft model on the device
    its params live on. Both models share the vocabulary; ``k`` is the
    proposal length of every round (k draft steps, one (k+1)-token target
    forward)."""

    def __init__(self, target_config: LlamaConfig, target_params: Params,
                 draft_config: LlamaConfig, draft_params: Params,
                 k: int = 4, max_len: int = 2048,
                 kv_dtype: str = "native", gate=None):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        # degradation hook: a callable consulted every round; when it
        # returns False the round decodes ONE token target-only (the same
        # greedy stream), e.g. gate=lambda: engine.speculative_enabled
        self.enabled = True
        self.gate = gate
        self.target_config = target_config
        self.target_params = target_params
        self.draft_config = draft_config
        self.draft_params = draft_params
        self.k = int(k)
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.device = target_params["embedding"].device

    def _speculation_allowed(self) -> bool:
        if not self.enabled:
            return False
        if self.gate is not None:
            try:
                return bool(self.gate())
            except Exception as exc:  # noqa: BLE001 - a broken gate must
                # not take decoding down; fall back to full speculation
                logger.warning("speculative gate failed, assuming enabled",
                               error=str(exc))
        return True

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor([ids], dtype=torch.long, device=self.device)

    def _prefill(self, params, config, tokens):
        cache = init_kv_cache(config, 1, self.max_len, kv_dtype=self.kv_dtype,
                              device=self.device)
        return _forward_with_cache(config, params, self._tokens(tokens),
                                   cache)

    def _draft_propose(self, last: int, cache: dict) -> list:
        """k greedy draft steps from ``last``; the draft cache advances k."""
        proposals, tok = [], last
        for _ in range(self.k):
            logits, cache = _forward_with_cache(
                self.draft_config, self.draft_params, self._tokens([tok]),
                cache)
            tok = int(_argmax(logits)[0])
            proposals.append(tok)
        return proposals

    def _target_verify(self, last: int, proposals: list, cache: dict):
        """One (k+1)-token forward: the target's argmax at every position
        (position i follows proposal i-1)."""
        logits, cache = _forward_with_cache(
            self.target_config, self.target_params,
            self._tokens([last] + proposals), cache, all_logits=True)
        return _argmax(logits)[0].tolist()

    def generate(self, prompt_tokens, max_new_tokens: int = 64,
                 eos_id: Optional[int] = None) -> tuple[list, SpecStats]:
        """Greedy generation, equal to the target model's own greedy
        decode; returns (tokens, stats)."""
        prompt = [int(t) for t in prompt_tokens]
        if len(prompt) + max_new_tokens + self.k + 1 > self.max_len:
            from .resilience import PromptTooLongError

            raise PromptTooLongError(
                "prompt + max_new_tokens exceeds max_len")
        stats = SpecStats()
        start = time.perf_counter()

        t_logits, t_cache = self._prefill(self.target_params,
                                          self.target_config, prompt)
        _, d_cache = self._prefill(self.draft_params, self.draft_config,
                                   prompt)
        out = [int(_argmax(t_logits)[0])]

        while len(out) < max_new_tokens and (
                eos_id is None or out[-1] != eos_id):
            if not self._speculation_allowed():
                # degraded mode: ONE token target-only; both caches stay
                # in step so speculation resumes when the gate reopens
                t_logits, t_cache = _forward_with_cache(
                    self.target_config, self.target_params,
                    self._tokens([out[-1]]), t_cache)
                _, d_cache = _forward_with_cache(
                    self.draft_config, self.draft_params,
                    self._tokens([out[-1]]), d_cache)
                out.append(int(_argmax(t_logits)[0]))
                stats.rounds += 1
                stats.fallback_rounds += 1
                continue
            proposals = self._draft_propose(out[-1], d_cache)
            verified = self._target_verify(out[-1], proposals, t_cache)
            emitted, n_accept = accept_tokens(proposals, verified, self.k)
            if eos_id is not None and eos_id in emitted:
                emitted = emitted[:emitted.index(eos_id) + 1]
            out.extend(emitted[:max_new_tokens - len(out)])

            stats.rounds += 1
            stats.proposed += self.k
            stats.accepted += n_accept

            # rewind both caches to the committed stream: the target wrote
            # k+1 entries (last + proposals), the draft k
            committed = len(prompt) + len(out) - 1   # entries behind last
            t_cache["pos"] = torch.full_like(t_cache["pos"], committed)
            d_cache["pos"] = torch.full_like(d_cache["pos"], committed)

        stats.tokens = len(out)
        stats.elapsed_s = time.perf_counter() - start
        logger.debug("speculative decode", **stats.to_dict())
        return out, stats
