"""The generator: deterministic in the seed, the same set of sizes and
arrivals for every seed, the stated length and sharing distributions."""

import json
from collections import Counter

import numpy as np

import traffic
from conftest import BENCH


def _mix(name):
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def _chat(seed, seconds=40.0):
    return traffic.plan(_mix("chat-prefix"), seed, 32768, seconds)


def _requests(plan):
    """Every request of the plan: each session's turns, each client's
    queue."""
    if isinstance(plan, traffic.ChatPlan):
        return [plan.turn(i, k) for i, s in enumerate(plan.sessions)
                for k in range(len(s["user"]))]
    return [r for q in plan.queues for r in q]


def test_chat_is_deterministic_in_the_seed():
    a, b = _chat(2 ** 31 + 7), _chat(2 ** 31 + 7)
    assert np.array_equal(a.offsets, b.offsets)
    assert [r.prompt for r in _requests(a)] == \
        [r.prompt for r in _requests(b)]
    c = _chat(2 ** 31 + 8)
    assert [r.prompt for r in _requests(a)] != \
        [r.prompt for r in _requests(c)]


def test_chat_seeds_share_the_set_of_sizes_and_arrivals():
    a, b = _chat(3), _chat(2 ** 33 + 1)
    # the whole schedule: the same sessions at the same times
    assert np.array_equal(a.offsets, b.offsets)
    assert [(s["system"], len(s["user"])) for s in a.sessions] == \
        [(s["system"], len(s["user"])) for s in b.sessions]

    def shape(plan):
        return [(len(r.prompt), r.max_new, r.index)
                for r in _requests(plan)]

    assert shape(a) == shape(b)
    assert [len(r.prompt) for _, r in a.first()] == \
        [len(r.prompt) for _, r in b.first()]


def test_chat_lengths_and_sharing():
    mix = _mix("chat-prefix")
    plan = _chat(11, seconds=400.0)
    sessions = plan.sessions
    user = np.concatenate([s["user"] for s in sessions])
    out = np.concatenate([s["out"] for s in sessions])
    assistant = np.concatenate([s["assistant"] for s in sessions])
    assert user.min() >= 32 and user.max() <= 384
    assert abs(np.median(user) - 128) <= 16
    assert out.min() >= 16 and out.max() <= 256
    assert abs(np.median(out) - 96) <= 12
    assert assistant.min() >= 64 and assistant.max() <= 256
    turns = Counter(len(s["user"]) for s in sessions)
    assert set(turns) == {1, 2, 3, 4}
    # Zipf(1) over 4 system prompts: 1 : 1/2 : 1/3 : 1/4
    picks = Counter(s["system"] for s in sessions)
    share = picks[0] / len(sessions)
    assert abs(share - 1 / (1 + 1 / 2 + 1 / 3 + 1 / 4)) < 0.08
    # every turn starts with its session's system prompt, and turn k + 1
    # starts with turn k's prompt (the replayed history)
    tokens = mix["system_prompts"]["tokens"]
    for i, s in enumerate(sessions[:20]):
        prev = None
        for k in range(len(s["user"])):
            prompt = plan.turn(i, k).prompt
            assert prompt[:tokens] == plan.system_prompts[s["system"]]
            if prev is not None:
                assert prompt[:len(prev)] == prev
            prev = prompt
    longest = max(len(r.prompt) + r.max_new for r in _requests(plan))
    assert longest <= mix["engine"]["max_len"]
    # arrivals: a Poisson process at the sessions' rate
    rate = mix["request_rate_per_s"] / mix["turns"]["mean"]
    assert abs(len(sessions) / 400.0 - rate) / rate < 0.15


def test_batch_clients_and_uniqueness():
    mix = _mix("batch-decode")
    a = traffic.plan(mix, 5, 32768, 40)
    b = traffic.plan(mix, 2 ** 32 + 5, 32768, 40)
    assert len(a.queues) == mix["clients"]
    for r in range(mix["rounds"]):
        assert [(len(q[r].prompt), q[r].max_new) for q in a.queues] \
            == [(len(q[r].prompt), q[r].max_new) for q in b.queues]
    assert [r.prompt for r in _requests(a)] != \
        [r.prompt for r in _requests(b)]
    reqs = _requests(a)
    lens = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new for r in reqs])
    assert lens.min() >= 128 and lens.max() <= 1024
    assert abs(np.median(lens) - 384) <= 48
    assert outs.min() >= 256 and outs.max() <= 1024
    assert (lens + outs).max() <= mix["engine"]["max_len"]
    # no prefix shared beyond a page
    heads = {tuple(r.prompt[:mix["engine"]["page_size"]]) for r in reqs}
    assert len(heads) == len(reqs)
    again = traffic.plan(mix, 5, 32768, 40)
    assert [r.prompt for r in _requests(again)] == [r.prompt for r in reqs]


def test_packed_rows():
    mix = dict(_mix("train-8k"), seq=256)
    plan = traffic.plan(mix, 9, 32000)
    rows = [plan.rows() for _ in range(8)]
    again = traffic.plan(mix, 9, 32000)
    for tokens, targets in rows:
        t2, g2 = again.rows()
        assert np.array_equal(tokens, t2) and np.array_equal(targets, g2)
        assert tokens.shape == (1, 256)
        assert np.array_equal(tokens[0, 1:], targets[0, :-1])
    flat = np.concatenate([t[0] for t, _ in rows])
    assert len({tuple(t[0]) for t, _ in rows}) == len(rows)
    assert (flat == 31999).sum() >= 1
    lengths = plan.lengths
    assert lengths.min() >= 64 and lengths.max() <= 8192
    assert abs(np.median(lengths) - 1024) / 1024 < 0.1
    other = traffic.plan(mix, 10, 32000)
    assert sorted(other.lengths) == sorted(lengths)
