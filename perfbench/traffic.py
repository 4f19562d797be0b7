"""The one traffic generator: a mix file's parameters in, a deterministic
plan of requests (or training batches) out.

Every seed gets the same set of sizes and arrivals: they are drawn from
the mix's own ``mix_seed``, and the run's ``--seed`` draws the token ids
(and, for the training rows, orders the documents). So two seeds ask
for the same work, and a run's spread is the system's, not the mix's.
The serving mixes' schedules are replayed whole: which session arrives
when, with how many turns of what sizes, and which client sends what
sizes in which round, are the same for every seed, since a tail or a
closed loop's pace depends on which requests overlap.

Kinds (a mix file's ``kind``):

- ``chat_sessions``: an open loop of chat sessions replayed as from a
  recorded trace. Sessions start as a Poisson process; each picks one of
  a few shared system prompts (Zipf-popular) and runs 1..n turns. A
  turn's prompt replays the session's history (system prompt, earlier
  user turns, earlier assistant turns made by the generator) plus the new
  user turn. Every due time is fixed before the run: the next turn is due
  the recorded reply time after the previous one (``reply``: a first
  token, then a time a token) plus an exponential think time, whatever
  the system does.
- ``closed_batch``: a closed loop of clients, each sending its next
  unique prompt as soon as the previous one completes.
- ``packed_documents``: training batches of documents with heavy-tailed
  lengths packed into fixed-length rows, an end-of-document token
  between them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _lognormal_int(rng, spec: dict, n: int) -> np.ndarray:
    """Integers from a lognormal with the given median and sigma, clipped
    to [min, max]."""
    draw = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(draw), spec["min"], spec["max"]).astype(np.int64)


def _uniform_int(rng, spec: dict, n: int) -> np.ndarray:
    return rng.integers(spec["min"], spec["max"] + 1, n).astype(np.int64)


def draw_sizes(rng, spec: dict, n: int) -> np.ndarray:
    """``spec["dist"]`` is ``lognormal`` (median, sigma, min, max) or
    ``uniform`` (min, max)."""
    if spec["dist"] == "lognormal":
        return _lognormal_int(rng, spec, n)
    if spec["dist"] == "uniform":
        return _uniform_int(rng, spec, n)
    raise ValueError(f"unknown size distribution {spec['dist']!r}")


def _seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


@dataclasses.dataclass
class Request:
    """One request: its prompt, its output length, and who sends the
    next one (a session's next turn or a client's next prompt)."""
    prompt: list
    max_new: int
    owner: int
    index: int
    # closed loop: seconds after this one completes that the owner's
    # next is due
    then_after_s: float = 0.0


class ChatPlan:
    """An open loop of chat sessions (kind ``chat_sessions``)."""

    loop = "open"

    def __init__(self, mix: dict, seed: int, vocab: int, seconds: float):
        base = np.random.default_rng(mix["mix_seed"])
        rng = _seed_rng(seed)
        rate = mix["request_rate_per_s"] / mix["turns"]["mean"]
        # the arrivals of the window: a Poisson process over [0, seconds)
        gaps = base.exponential(1.0 / rate, int(rate * seconds * 3) + 16)
        gaps = gaps[np.cumsum(gaps) < seconds]
        n = len(gaps)
        system = mix["system_prompts"]
        ranks = np.arange(1, system["count"] + 1, dtype=np.float64)
        popularity = ranks ** -system["zipf_s"]
        popularity /= popularity.sum()
        sessions = []
        for _ in range(n):
            turns = int(base.integers(mix["turns"]["min"],
                                      mix["turns"]["max"] + 1))
            sessions.append({
                "system": int(base.choice(system["count"], p=popularity)),
                "user": draw_sizes(base, mix["user_tokens"], turns),
                "assistant": draw_sizes(base, mix["assistant_tokens"],
                                        turns - 1),
                "out": draw_sizes(base, mix["output_tokens"], turns),
                "think": base.exponential(mix["think_s_mean"], turns - 1)})
        # the schedule is the mix's; the seed draws the tokens
        self.sessions = sessions
        self.offsets = np.cumsum(gaps)
        self.vocab = vocab
        self.reply = mix["reply"]
        self.system_prompts = [
            rng.integers(0, vocab, system["tokens"]).tolist()
            for _ in range(system["count"])]
        for s in self.sessions:
            s["user_ids"] = [rng.integers(0, vocab, k).tolist()
                             for k in s["user"]]
            s["assistant_ids"] = [rng.integers(0, vocab, k).tolist()
                                  for k in s["assistant"]]

    def first(self) -> list:
        """(offset seconds after the window opens, request) of every
        turn of every session."""
        out = []
        for i, s in enumerate(self.sessions):
            due = float(self.offsets[i])
            for k in range(len(s["user"])):
                out.append((due, self.turn(i, k)))
                if k + 1 < len(s["user"]):
                    due += (self.reply["first_token_s"] + int(s["out"][k])
                            * self.reply["per_token_s"] + float(s["think"][k]))
        return out

    def turn(self, session: int, k: int) -> Request:
        s = self.sessions[session]
        prompt = list(self.system_prompts[s["system"]])
        for j in range(k):
            prompt += s["user_ids"][j] + s["assistant_ids"][j]
        prompt += s["user_ids"][k]
        return Request(prompt=prompt, max_new=int(s["out"][k]),
                       owner=session, index=k)

    def next_after(self, req: Request):
        """None: every turn's due time is fixed in ``first``."""
        return None

    def warmup(self) -> list:
        """Requests sent during set-up: every system prompt alone (which
        fills the prefix cache with them), then one turn on each (the
        prefix-hit suffix prefill)."""
        out = [Request(prompt=list(p), max_new=2, owner=-1, index=i)
               for i, p in enumerate(self.system_prompts)]
        rng = np.random.default_rng(1)
        for i, p in enumerate(self.system_prompts):
            out.append(Request(prompt=list(p) + rng.integers(
                0, self.vocab, 128 + 64 * i).tolist(), max_new=4, owner=-1,
                index=len(out)))
        return out


class BatchPlan:
    """A closed loop of clients sending unique prompts (kind
    ``closed_batch``)."""

    loop = "closed"

    def __init__(self, mix: dict, seed: int, vocab: int, seconds: float):
        base = np.random.default_rng(mix["mix_seed"])
        rng = _seed_rng(seed)
        clients, rounds = mix["clients"], mix["rounds"]
        prompt = draw_sizes(base, mix["prompt_tokens"], clients * rounds)
        out = draw_sizes(base, mix["output_tokens"], clients * rounds)
        prompt, out = prompt.reshape(rounds, clients), out.reshape(
            rounds, clients)
        self.vocab = vocab
        self.queues = [[] for _ in range(clients)]
        for r in range(rounds):
            # the sizes are the mix's, client by client; the seed draws
            # the tokens
            for c in range(clients):
                self.queues[c].append(Request(
                    prompt=rng.integers(0, vocab, prompt[r, c]).tolist(),
                    max_new=int(out[r, c]), owner=c, index=r))

    def first(self) -> list:
        return [(0.0, q[0]) for q in self.queues]

    def next_after(self, req: Request):
        queue = self.queues[req.owner]
        return queue[req.index + 1] if req.index + 1 < len(queue) else None

    def warmup(self) -> list:
        """One request a prompt bucket (short, middle, long), so set-up
        runs each prefill shape and the decode tick once."""
        rng = np.random.default_rng(1)
        lens = sorted({int(min(max(len(r.prompt) for q in self.queues
                                   for r in q), n)) for n in (128, 512, 1024)})
        return [Request(prompt=rng.integers(0, self.vocab, n).tolist(),
                        max_new=4, owner=-1, index=i)
                for i, n in enumerate(lens)]


class PackedPlan:
    """Training rows of packed documents (kind ``packed_documents``):
    ``batch`` rows of ``seq`` tokens and their next-token targets."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.batch, self.seq = mix["batch"], mix["seq"]
        self.eod = vocab - 1
        self.vocab = vocab
        base = np.random.default_rng(mix["mix_seed"])
        # the document lengths of a long stream: the mix's set; the seed
        # orders them
        lengths = draw_sizes(base, mix["document_tokens"],
                             mix["documents"])
        self.lengths = lengths[_seed_rng(seed).permutation(len(lengths))]
        self.rng = _seed_rng(seed ^ 0x5EED)
        self._doc = 0
        self._left = 0

    def rows(self) -> tuple:
        """(tokens, targets) int64 [batch, seq]: a stream of documents
        (each ending in the end-of-document token) cut into rows of seq +
        1 tokens, every row new."""
        need = self.batch * (self.seq + 1)
        stream = np.empty(need, np.int64)
        filled = 0
        while filled < need:
            if self._left == 0:
                self._left = int(self.lengths[self._doc % len(self.lengths)])
                self._doc += 1
            take = min(self._left, need - filled)
            stream[filled:filled + take] = self.rng.integers(
                0, self.vocab - 1, take)
            self._left -= take
            filled += take
            if self._left == 0:
                stream[filled - 1] = self.eod
        rows = stream.reshape(self.batch, self.seq + 1)
        return rows[:, :-1].copy(), rows[:, 1:].copy()


def plan(mix: dict, seed: int, vocab: int, seconds: float = 0.0):
    kind = mix["kind"]
    if kind == "chat_sessions":
        return ChatPlan(mix, seed, vocab, seconds)
    if kind == "closed_batch":
        return BatchPlan(mix, seed, vocab, seconds)
    if kind == "packed_documents":
        return PackedPlan(mix, seed, vocab)
    raise ValueError(f"unknown traffic kind {kind!r}")
