"""Where the time goes on the port's serving path (mlrun_tpu_torch), on one
GPU: the device steps of the paged engine, of LLMEngine and of the dense
engine at Llama-3-8B width, each traced with torch.profiler.

    python3 scripts/profile_torch_serving.py [--seed 0] [--out DIR]

Steps (random bf16 weights from a seed; 4 slots, page size 128,
max_len 2048, the chip smoke test's prompt lengths):

- decode:      one ``_decode_rowwise_paged`` tick over 4 slots at
               positions 600/436/200/700 (kernel path);
- cold prefill: ``_forward_with_cache`` of a 700-token prompt padded to
               its 1024 bucket (cached flash kernel);
- hit prefill:  the 180-token suffix (512 bucket) of a prompt whose
               256-token prefix sits in two pool pages (paged prefill +
               bounded flash, LSE-merged);
- int8 decode: the decode tick on an int8 pool (int8 paged decode);
- verify:      ``_verify_rowwise_paged`` of a 5-token chunk per slot (the
               last token + 4 draft tokens) at the decode positions (the
               verify kernel LSE-merged with the chunk's causal part);
- spec tick:   one speculative round as the engine runs it: 4 greedy steps
               of a Llama-3.2-1B draft (random weights) over its dense slot
               cache, one host read of the proposals, then the verify;
- llm chunk:   ``LLMEngine``'s greedy decode chunk (LLMModelServer's
               default engine): 32 dense 1-token steps of one prompt at
               positions 700..731, the argmax kept on the card, one host
               read;
- dense tick:  the dense ``ContinuousBatchingEngine``'s decode tick: one
               ``_decode_rowwise`` over a dense [32, 4, 2048] slot cache at
               positions 600/436/200/700 and one host read of the tokens;
- lora decode: the decode tick with two LoRA adapters live (rank 16, the
               four default targets, in an ``AdapterRegistry`` bank): the
               4 slots on adapters t1, t2, base, t1;
- lora hit prefill: the hit prefill under adapter t1.

For each step it prints one JSON line: wall ms per step (host clock around
synchronised runs), device busy ms (sum of CUDA kernel times in the
trace), the idle share (1 - busy / wall), and the kernels grouped by name
(our attention kernels, matrix products, everything else). The full
tables go to DIR/profile_<step>.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ITERS = 5  # traced runs per step (after 2 untimed warm-up runs)
OURS = {"paged_decode_kernel": "paged_decode",
        "flash_fwd_cached_kernel": "flash_fwd_cached",
        "flash_fwd_tc_kernel": "flash_fwd_cached",
        "paged_prefill_kernel": "paged_prefill",
        "paged_prefill_tc_kernel": "paged_prefill",
        "paged_verify_kernel": "paged_verify",
        "paged_verify_tc_kernel": "paged_verify"}


def _group(name: str) -> str:
    for key, label in OURS.items():
        if key in name:
            return label
    lowered = name.lower()
    if "gemm" in lowered or "gemv" in lowered or "cutlass" in lowered \
            or "sm90_xmma" in lowered or "nvjet" in lowered:
        return "matmul"
    return "other"


def profile_step(name, fn, iters, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    groups: dict = {}
    busy_us = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.time_range.elapsed_us()
        busy_us += dev_us
        label = _group(evt.name)
        groups[label] = groups.get(label, 0.0) + dev_us
    if busy_us == 0:
        raise SystemExit("profile_torch_serving: the trace holds no device "
                         "time (CUPTI tracing unavailable)")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as fh:
        fh.write(table)
    busy_ms = busy_us / 1e3 / iters
    return {"step": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "device_ms_by_group": {k: v / 1e3 / iters
                                   for k, v in sorted(groups.items())}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(
        os.path.dirname(HERE), "build", "profile"))
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 1
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.models.lora import init_lora_nonzero
    from mlrun_tpu_torch.serving.adapters import AdapterRegistry
    from mlrun_tpu_torch.serving.llm import (
        LLMEngine,
        _forward_with_cache,
        _quantize_kv,
        init_kv_cache,
    )
    from mlrun_tpu_torch.serving.llm_batch import _decode_rowwise
    from mlrun_tpu_torch.serving.paged import (
        _decode_rowwise_paged,
        _verify_rowwise_paged,
        init_paged_pool,
    )

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    config = MODEL_PRESETS["llama3-8b"]()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(config, gen, dev)
    page, max_len, slots = 128, 2048, 4
    pps = max_len // page
    pool = init_paged_pool(config, slots * pps + 1, page, device=dev)
    for name in ("k", "v"):
        pool[name].normal_(generator=gen)
    rng = np.random.default_rng(args.seed)
    table = np.full((slots, pps), -1, np.int32)
    table[:] = rng.permutation(slots * pps).reshape(slots, pps)
    pos = torch.tensor([600, 436, 200, 700], dtype=torch.int32, device=dev)
    table_t = torch.as_tensor(table, device=dev)
    tokens = torch.as_tensor(rng.integers(1, config.vocab_size, (slots, 1)),
                             device=dev)

    def decode():
        _decode_rowwise_paged(config, page, "kernel", params, tokens, pool,
                              table_t, pos)

    cold_tokens = torch.as_tensor(
        rng.integers(1, config.vocab_size, (1, 1024)), device=dev)
    small = init_kv_cache(config, 1, max_len, device=dev)

    def cold_prefill():
        small["pos"].zero_()
        _forward_with_cache(config, params, cold_tokens, small,
                            attn_impl="flash")

    hit_tokens = torch.as_tensor(
        rng.integers(1, config.vocab_size, (1, 512)), device=dev)
    ids = torch.full((pps,), -1, dtype=torch.int32, device=dev)
    ids[:2] = table_t[0, :2]
    prefix_kv = {"k": pool["k"], "v": pool["v"], "page_ids": ids,
                 "base": 256}

    def hit_prefill():
        small["pos"].fill_(256)
        _forward_with_cache(config, params, hit_tokens, small,
                            prefix_kv=prefix_kv, attn_impl="flash",
                            page_size=page)

    pool8 = init_paged_pool(config, slots * pps + 1, page, kv_dtype="int8",
                            device=dev)
    for name in ("k", "v"):
        pool8[name], pool8[f"{name}_scale"] = _quantize_kv(
            torch.randn(pool[name].shape, generator=gen, device=dev))

    def int8_decode():
        _decode_rowwise_paged(config, page, "kernel", params, tokens, pool8,
                              table_t, pos)

    k_draft = 4
    chunk = torch.as_tensor(
        rng.integers(1, config.vocab_size, (slots, k_draft + 1)), device=dev)

    def verify():
        _verify_rowwise_paged(config, page, "kernel", params, chunk, pool,
                              table_t, pos)

    draft_config = MODEL_PRESETS["llama3-1b"]()
    draft = init_params(draft_config, gen, dev)
    dcache = init_kv_cache(draft_config, slots, max_len, device=dev)
    for name in ("k", "v"):
        dcache[name].normal_(generator=gen)

    def spec_tick():
        dcache["pos"] = pos.clone()
        step = tokens
        proposals = []
        for _ in range(k_draft):
            nxt, _ = _decode_rowwise(draft_config, draft, step, dcache)
            proposals.append(nxt)
            step = nxt[:, None].long()
        proposals = torch.stack(proposals, dim=1).cpu()
        spec_chunk = torch.cat([tokens.cpu(), proposals.long()], dim=1)
        _verify_rowwise_paged(config, page, "kernel", params,
                              spec_chunk.to(dev), pool, table_t, pos)

    engine = LLMEngine(config, params, max_len=max_len, device=dev)
    llm_cache = engine._new_cache()
    for name in ("k", "v"):
        llm_cache[name].normal_(generator=gen)
    llm_step = tokens[:1]

    def llm_chunk():
        out, _ = engine._decode_n(llm_step, llm_cache, engine.decode_chunk,
                                  700)
        out.cpu()

    dense = init_kv_cache(config, slots, max_len, device=dev)
    for name in ("k", "v"):
        dense[name].normal_(generator=gen)

    def dense_tick():
        dense["pos"] = pos.clone()
        nxt, _ = _decode_rowwise(config, params, tokens, dense)
        nxt.cpu()

    registry = AdapterRegistry(
        config, sources={name: init_lora_nonzero(config, gen, device=dev)
                         for name in ("t1", "t2")}, device=dev)
    slot_of = {"": 0}
    for name in ("t1", "t2"):
        registry.pin(name)
        slot_of[name] = registry.ensure_loaded(name)
    lora = registry.bank.tensors
    decode_ids = torch.tensor([slot_of[a] for a in ("t1", "t2", "", "t1")],
                              dtype=torch.int32, device=dev)
    hit_ids = torch.tensor([slot_of["t1"]], dtype=torch.int32, device=dev)

    def lora_decode():
        _decode_rowwise_paged(config, page, "kernel", params, tokens, pool,
                              table_t, pos, lora=lora,
                              adapter_ids=decode_ids)

    def lora_hit_prefill():
        small["pos"].fill_(256)
        _forward_with_cache(config, params, hit_tokens, small,
                            prefix_kv=prefix_kv, attn_impl="flash",
                            page_size=page, lora=lora, adapter_ids=hit_ids)

    for name, fn in (("decode", decode), ("cold_prefill", cold_prefill),
                     ("hit_prefill", hit_prefill),
                     ("int8_decode", int8_decode), ("verify", verify),
                     ("spec_tick", spec_tick), ("llm_chunk", llm_chunk),
                     ("dense_tick", dense_tick),
                     ("lora_decode", lora_decode),
                     ("lora_hit_prefill", lora_hit_prefill)):
        row = profile_step(name, fn, ITERS, args.out)
        row.update({"layers": config.n_layers, "card": card})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
