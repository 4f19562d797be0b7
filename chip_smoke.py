"""Chip smoke test of the PyTorch/CUDA port (mlrun_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing JSON lines (any failed check raises, so the script
exits non-zero and never prints the final line):

1. build   - compiles the CUDA kernels from mlrun_tpu_torch/csrc (nvcc,
             sm_90a) and reports the build time, torch/CUDA versions and
             the card's name and power limit; counts the tensor-core
             instructions (HMMA/HGMMA in cuobjdump -sass) of every bf16
             flash kernel and fails if one has none or ptxas reports a
             spill store in it.
2. kernels - holds each hand-written kernel (int8 and verify variants,
             the v1 flash entry point and RMSNorm included) against its
             plain PyTorch
             version at its main path's shapes, in bf16 and f32, with the
             stated tolerances; times kernel, plain version and, where one
             PyTorch call computes the same function
             (scaled_dot_product_attention, torch.nn.functional.rms_norm),
             with CUDA events; checks that
             chunked and unchunked flash prefill agree bit for bit and
             that two flash backward launches give the same bits; then
             drives the op entry points ``_flash_fwd`` and
             ``rms_norm_pallas`` (no engine reaches them) once at each of
             their shapes, counted.
3. serve   - serves Llama-3-8B (random weights from a seed, bf16, all 32
             layers) through LLMModelServer -> PagedContinuousBatchingEngine
             with the kernels, shows every serving kernel launched on that
             path, then reruns the same requests on a reference-attention
             engine and compares first-token logits and greedy tokens.
4. serve_int8 - the same on an int8 KV pool (the int8 decode and prefill
             kernels), against an int8 reference-attention engine, and
             against the native pool (the quantization's own error).
5. spec    - speculative decoding on the paged engine: the permutation
             pair at 8B width (depth cut, zero weights), native and int8
             pools, spec on == spec off exactly; then LLMModelServer at
             Llama-3-8B on an int8 pool with a random Llama-3.2-1B draft
             (k 4) against the spec-off engine: identical until a
             near-tie of the target's logits, every emitted token a
             near-argmax; the verify kernels launched on both paths.
6. serve_dense - LLMModelServer's two non-paged configurations at
             Llama-3-8B: its defaults (an LLMEngine: bucket-padded flash
             prefill, greedy decode in chunks of 32 dense steps) and
             continuous_batching=True (the dense engine, chunked prefill of
             256 tokens, so long prompts resume across ticks), each with
             the cached flash kernel launched once a layer on every prefill
             chunk and against a reference-attention engine; then the
             permutation pair on the dense engine (native and int8 caches,
             the dense verify): spec on == spec off.
7. train   - trains Llama-3.2-1B (random weights from a seed, bf16, all 16
             layers, full width) through Trainer.fit for a few steps on a
             repeated synthetic batch (4 x 2048 tokens, loss chunks of
             512, per-layer remat), shows the flash forward and backward
             kernels launched once per layer per pass, checks that the
             loss is finite and falls, reports the Trainer's own
             tokens/s and MFU, and holds step 1's loss, gradient norm and
             attention-weight gradients against the reference attention.

Then one line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
``--phases build,kernels`` runs a subset (for bring-up;
``--phases build,kernels,serve_dense`` checks the dense serving path); the
final lines are printed only when every phase ran. nvcc's build log (registers, shared
memory and spills per kernel) goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bf16": 989e12,   # dense tensor-core bf16
                  "f32": 67e12}     # float32 outside the tensor cores

# stated tolerances (max abs error, kernel vs plain version on the same
# inputs): bf16 outputs may differ by ~2 bf16 ulps at magnitude 1 because
# the two sum in different orders before rounding; float32 outputs and
# every lse (computed in float32 from the same input bits) only by
# summation-order round-off
TOL = {"bf16": {"o": 1.6e-2, "lse": 1e-4},
       "f32": {"o": 2e-5, "lse": 1e-4}}
# flash backward gradients, kernel vs plain version on the same inputs.
# float32: sums of thousands of terms of both signs, added in another
# order; the bound is 1e-4 of the largest gradient (or of 1, if larger).
# bf16: the kernel and the plain version both compute one float32 sum from
# the same bf16 inputs, and the kernel rounds it to bf16 once. So each
# element is held against the plain version's unrounded float32 value: at
# most half a bf16 ulp of it (2**-8 of its own magnitude), plus a floor of
# 2e-5 of the largest gradient for the two float32 sums' different order
# (the float32 rows read up to ~4e-6 of it)
GRAD_RTOL_F32 = 1e-4
BF16_HALF_ULP = 2.0 ** -8
BF16_GRAD_FLOOR = 2e-5
# end to end: first-token logits of the kernel engine vs the reference
# engine (both bf16, 32 layers) — bf16 rounds at different points in the
# two attention paths, and the difference compounds over the layers
LOGIT_REL_TOL = 5e-2
# train step 1, kernel path vs reference attention (16 layers, same params
# and batch). In bf16, the main path's dtype, the two agree to ~2e-6
# (loss) and ~1e-4 (grad norm); the limits sit 10-60x above. The global
# norm is dominated by the non-attention leaves, so the attention weights'
# gradients are held one by one: in bf16 their norms (within 1e-2); their
# elements differ there by ~3% (||g_kernel - g_ref|| / ||g_ref||), because
# the reference's backward rounds dP to bf16 before the softmax backward
# subtracts two nearly equal numbers — noise that would hide a faulty
# dq, dk or dv. So the same gradients are also compared in float32, where
# the two paths differ only in summation order: within 2e-3 per leaf (a
# zeroed dk reads 1 on wk; a dropped 64-key tile ~0.2)
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_NORM_REL_TOL = 1e-3
TRAIN_LEAF_NORM_REL_TOL = 1e-2
TRAIN_F32_LEAF_REL_TOL = 2e-3
ATTENTION_LEAVES = ("layers.wq", "layers.wk", "layers.wv", "layers.wo")
SERVING_KERNELS = ("paged_decode", "flash_fwd_cached", "paged_prefill")
INT8_KERNELS = ("paged_decode_int8", "flash_fwd_cached", "paged_prefill_int8")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd")
# bf16 flash kernels on the tensor cores: the forward for D 32/64/128,
# causal or not; the backward's dq and dkdv kernels for D 32/64/128
TC_INSTANTIATIONS = 3 * 2 + 3 * 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(card: str):
    import torch

    from mlrun_tpu_torch.ops import _build

    started = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - started
    log = _build.build_log()
    print(log, file=sys.stderr, flush=True)
    emit({"phase": "build", "build_s": seconds, "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "sources": [p.name for p in _build.sources()]})
    # the bf16 flash kernels run on the tensor cores: every instantiation
    # holds HMMA/HGMMA instructions in its SASS and spills nothing
    mma = {name: count
           for name, count in _build.tensor_core_counts(
               _build.library_sass()).items()
           if any(k in name for k in _build.TENSOR_CORE_KERNELS)}
    spills = {name: n for name, n in _build.ptxas_spills(log).items()
              if any(k in name for k in _build.TENSOR_CORE_KERNELS)}
    emit({"phase": "build", "tensor_core_instructions": mma,
          "spill_store_bytes": spills})
    if len(mma) != TC_INSTANTIATIONS or len(spills) != TC_INSTANTIATIONS:
        fail(f"expected {TC_INSTANTIATIONS} tensor-core flash kernels, found "
             f"{len(mma)} in the SASS and {len(spills)} in ptxas' report")
    for name, count in mma.items():
        if count <= 0:
            fail(f"{name}: no HMMA/HGMMA instruction in its SASS")
    for name, n in spills.items():
        if n != 0:
            fail(f"{name}: ptxas reports {n} bytes of spill stores")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

H, HKV, D = 32, 8, 128          # Llama-3-8B attention widths
PAGE, MAX_LEN, SLOTS = 128, 2048, 4


def _dtypes():
    import torch

    return (("bf16", torch.bfloat16), ("f32", torch.float32))


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name, kind, errs: dict):
    for key, err in errs.items():
        tol = TOL[kind][key]
        if not err <= tol:
            fail(f"{name} {kind} {key}: max_abs_err {err} > tol {tol}")


def kernel_decode(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    pps = MAX_LEN // PAGE
    n_pages = SLOTS * pps
    k_pages = (torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                           device=dev) * 0.5).to(dtype)
    v_pages = torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                          device=dev).to(dtype)
    q = torch.randn((SLOTS, H, D), generator=gen, device=dev).to(dtype)
    pos = torch.tensor([1, 700, 1300, 2047], dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((SLOTS, pps), -1, dtype=torch.int32, device=dev)
    for s in range(SLOTS):
        live = int(pos[s]) // PAGE + 1
        table[s, :live] = perm[s * pps:s * pps + live]
    out = pa._paged_decode_call(q, k_pages, v_pages, table, pos, PAGE)
    ref = pa.paged_decode_reference(q, k_pages, v_pages, table, pos, PAGE)
    torch.cuda.synchronize()
    err = _err(out, ref)
    _check("paged_decode", kind, {"o": err})
    ms = time_ms(lambda: pa._paged_decode_call(q, k_pages, v_pages, table,
                                               pos, PAGE))
    plain = time_ms(lambda: pa.paged_decode_reference(
        q, k_pages, v_pages, table, pos, PAGE), iters=5)
    item = q.element_size()
    live_tokens = int((pos.long() + 1).sum())
    n_bytes = (2 * live_tokens * HKV * D * item + 2 * q.numel() * item
               + table.numel() * 4 + pos.numel() * 4)
    n_ops = 4 * D * H * live_tokens
    bound, by = bound_ms(n_bytes, n_ops, kind)
    row = {"name": "paged_decode", "dtype": kind, "slots": SLOTS,
           "pos": pos.tolist(), "max_abs_err": err, "tol": TOL[kind]["o"],
           "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
           "library_ms": None}
    record.append(row)
    emit({"phase": "kernels", **row})


def _sdpa_ms(q, k, v, q_offset, k_lo):
    import torch
    import torch.nn.functional as F

    s, m = q.shape[1], k.shape[1]
    k_pos = torch.arange(m, device=q.device)
    q_pos = q_offset + torch.arange(s, device=q.device)
    mask = (k_pos[None] <= q_pos[:, None]) & (k_pos[None] >= k_lo)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))


def kernel_flash(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import attention as at

    dev = "cuda"
    k = (torch.randn((1, MAX_LEN, HKV, D), generator=gen, device=dev)
         * 0.5).to(dtype)
    v = torch.randn((1, MAX_LEN, HKV, D), generator=gen, device=dev).to(dtype)
    rows = []
    # the first case is the main path's cold 512-bucket prefill, the second
    # its prefix-hit suffix prefill (two cached pages); then S in {128, 512}
    # at q_offset > 0 and k_lo = 128 * k
    for s, q_offset, k_lo in ((512, 0, 0), (512, 256, 256), (512, 1536, 0),
                              (512, 1024, 256), (128, 1900, 0),
                              (128, 640, 512)):
        q = torch.randn((1, s, H, D), generator=gen, device=dev).to(dtype)
        o, lse = at.flash_fwd_cached(q, k, v, q_offset, k_lo)
        o_ref, lse_ref = at.flash_fwd_cached_plain(q, k, v, q_offset, k_lo)
        torch.cuda.synchronize()
        errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
        _check(f"flash_fwd_cached S={s} q_offset={q_offset} k_lo={k_lo}",
               kind, errs)
        ms = time_ms(lambda: at.flash_fwd_cached(q, k, v, q_offset, k_lo))
        plain = time_ms(lambda: at.flash_fwd_cached_plain(q, k, v, q_offset,
                                                          k_lo), iters=5)
        lib_ms = _sdpa_ms(q, k, v, q_offset, k_lo)
        item = q.element_size()
        hi = q_offset + s            # keys k_lo..q_offset+s-1 are needed
        kv_rows = hi - k_lo
        pairs = sum(q_offset + i + 1 - k_lo for i in range(s))
        n_bytes = (2 * q.numel() * item + 2 * kv_rows * HKV * D * item
                   + lse.numel() * 4)
        n_ops = 4 * D * H * pairs
        bound, by = bound_ms(n_bytes, n_ops, kind)
        row = {"name": "flash_fwd_cached", "dtype": kind, "S": s,
               "q_offset": q_offset, "k_lo": k_lo,
               "max_abs_err": max(errs.values()), "errs": errs,
               "tol": TOL[kind], "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        rows.append(row)
        emit({"phase": "kernels", **row})
    record.append(rows[0])
    # chunk invariance: the whole prompt at once vs two q_offset chunks
    # over the same cache, bit for bit
    q = torch.randn((1, 512, H, D), generator=gen, device=dev).to(dtype)
    whole, whole_lse = at.flash_fwd_cached(q, k, v, 0, 0)
    a, a_lse = at.flash_fwd_cached(q[:, :200].contiguous(), k, v, 0, 0)
    b, b_lse = at.flash_fwd_cached(q[:, 200:].contiguous(), k, v, 200, 0)
    torch.cuda.synchronize()
    same = bool(torch.equal(whole, torch.cat([a, b], dim=1))
                and torch.equal(whole_lse, torch.cat([a_lse, b_lse], dim=2)))
    emit({"phase": "kernels", "name": "flash_fwd_cached", "dtype": kind,
          "chunk_invariant": same, "split": [200, 312]})
    if not same:
        fail(f"flash_fwd_cached {kind}: chunked prefill is not bit-identical "
             "to the unchunked one")


def kernel_prefill(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    pps = MAX_LEN // PAGE
    n_pages = SLOTS * pps
    base, s = 256, 512
    k_pages = (torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                           device=dev) * 0.5).to(dtype)
    v_pages = torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                          device=dev).to(dtype)
    q = torch.randn((s, H, D), generator=gen, device=dev).to(dtype)
    ids = torch.full((pps,), -1, dtype=torch.int32, device=dev)
    ids[:base // PAGE] = torch.tensor([37, 5], dtype=torch.int32)
    o, lse = pa._paged_prefill_call(q, k_pages, v_pages, ids, base, PAGE)
    o_ref, lse_ref = pa.paged_prefill_reference(q, k_pages, v_pages, ids,
                                                base, PAGE)
    torch.cuda.synchronize()
    # the prefill kernel emits float32 o and lse whatever the input dtype,
    # computed in float32 from the same input bits as the plain version
    errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
    _check("paged_prefill", "f32", errs)
    ms = time_ms(lambda: pa._paged_prefill_call(q, k_pages, v_pages, ids,
                                                base, PAGE))
    plain = time_ms(lambda: pa.paged_prefill_reference(
        q, k_pages, v_pages, ids, base, PAGE), iters=5)
    item = q.element_size()
    n_bytes = (q.numel() * item + 2 * base * HKV * D * item
               + o.numel() * 4 + lse.numel() * 4 + ids.numel() * 4)
    n_ops = 4 * D * H * s * base
    bound, by = bound_ms(n_bytes, n_ops, kind)
    row = {"name": "paged_prefill", "dtype": kind, "S": s, "base": base,
           "max_abs_err": max(errs.values()), "errs": errs,
           "tol": TOL["f32"],
           "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
           "library_ms": None}
    record.append(row)
    emit({"phase": "kernels", **row})


# the serve phase's decode positions (prompts 600/436/200/700); the
# speculative verify chunk is k 4 + 1 tokens
SERVE_POS = (600, 436, 200, 700)
VERIFY_S = 5


def _int8_pool(gen, n_pages):
    """Random k/v pages quantized by the port's own quantizer: (k, k_scale,
    v, v_scale) on the card."""
    import torch

    from mlrun_tpu_torch.serving.llm import _quantize_kv

    out = []
    for _ in ("k", "v"):
        x = torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                        device="cuda")
        out.extend(_quantize_kv(x))
    return out


def _page_table(gen, lengths, pps, n_pages):
    """[len(lengths), pps] int32 table mapping each row's first
    ceil(length / PAGE) pages to distinct random pages, -1 elsewhere."""
    import torch

    perm = torch.randperm(n_pages, generator=gen, device="cuda").to(
        torch.int32)
    table = torch.full((len(lengths), pps), -1, dtype=torch.int32,
                       device="cuda")
    for r, n in enumerate(lengths):
        live = -(-n // PAGE)
        table[r, :live] = perm[r * pps:r * pps + live]
    return table


def _kv_bytes(tokens: int, item) -> int:
    """Bytes of the k and v vectors of ``tokens`` positions: ``item``
    bytes an element, or "int8": 1 byte an element plus a 4-byte float32
    scale a (position, kv head)."""
    per_head = D + 4 if item == "int8" else D * item
    return 2 * tokens * HKV * per_head


def kernel_decode_int8(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    pps = MAX_LEN // PAGE
    n_pages = SLOTS * pps
    k, ks, v, vs = _int8_pool(gen, n_pages)
    q = torch.randn((SLOTS, H, D), generator=gen, device="cuda").to(dtype)
    pos = torch.tensor(SERVE_POS, dtype=torch.int32, device="cuda")
    table = _page_table(gen, [p + 1 for p in SERVE_POS], pps, n_pages)
    scales = {"k_scale": ks, "v_scale": vs}
    out = pa._paged_decode_call(q, k, v, table, pos, PAGE, **scales)
    ref = pa.paged_decode_reference(q, k, v, table, pos, PAGE, **scales)
    torch.cuda.synchronize()
    err = _err(out, ref)
    _check("paged_decode_int8", kind, {"o": err})
    ms = time_ms(lambda: pa._paged_decode_call(q, k, v, table, pos, PAGE,
                                               **scales))
    plain = time_ms(lambda: pa.paged_decode_reference(
        q, k, v, table, pos, PAGE, **scales), iters=5)
    live_tokens = int((pos.long() + 1).sum())
    n_bytes = (_kv_bytes(live_tokens, "int8") + 2 * q.numel()
               * q.element_size() + table.numel() * 4 + pos.numel() * 4)
    bound, by = bound_ms(n_bytes, 4 * D * H * live_tokens, kind)
    row = {"name": "paged_decode_int8", "dtype": kind, "slots": SLOTS,
           "pos": list(SERVE_POS), "max_abs_err": err, "tol": TOL[kind]["o"],
           "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
           "library_ms": None}
    record.append(row)
    emit({"phase": "kernels", **row})


def kernel_prefill_int8(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    pps = MAX_LEN // PAGE
    n_pages = SLOTS * pps
    base, s = 256, 512
    k, ks, v, vs = _int8_pool(gen, n_pages)
    q = torch.randn((s, H, D), generator=gen, device="cuda").to(dtype)
    ids = _page_table(gen, [base], pps, n_pages)[0]
    scales = {"k_scale": ks, "v_scale": vs}
    o, lse = pa._paged_prefill_call(q, k, v, ids, base, PAGE, **scales)
    o_ref, lse_ref = pa.paged_prefill_reference(q, k, v, ids, base, PAGE,
                                                **scales)
    torch.cuda.synchronize()
    errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
    _check("paged_prefill_int8", "f32", errs)
    ms = time_ms(lambda: pa._paged_prefill_call(q, k, v, ids, base, PAGE,
                                                **scales))
    plain = time_ms(lambda: pa.paged_prefill_reference(
        q, k, v, ids, base, PAGE, **scales), iters=5)
    n_bytes = (q.numel() * q.element_size() + _kv_bytes(base, "int8")
               + o.numel() * 4 + lse.numel() * 4 + ids.numel() * 4)
    bound, by = bound_ms(n_bytes, 4 * D * H * s * base, kind)
    row = {"name": "paged_prefill_int8", "dtype": kind, "S": s,
           "base": base, "max_abs_err": max(errs.values()), "errs": errs,
           "tol": TOL["f32"], "ms": ms, "plain_ms": plain, "bound_ms": bound,
           "bound_by": by, "library_ms": None}
    record.append(row)
    emit({"phase": "kernels", **row})


def kernel_verify(gen, kind, dtype, record):
    """The verify kernel, native and int8 pages, at 4 slots x S 5 over the
    serve positions; the single-slot launch against the prefill kernel's
    bits."""
    import torch

    from mlrun_tpu_torch.ops import paged_attention as pa

    pps = MAX_LEN // PAGE
    n_pages = SLOTS * pps
    base = torch.tensor(SERVE_POS, dtype=torch.int32, device="cuda")
    table = _page_table(gen, [p + VERIFY_S for p in SERVE_POS], pps,
                        n_pages)
    q = torch.randn((SLOTS, VERIFY_S, H, D), generator=gen,
                    device="cuda").to(dtype)
    native_k = (torch.randn((n_pages + 1, PAGE, HKV, D), generator=gen,
                            device="cuda") * 0.5).to(dtype)
    native_v = torch.randn(native_k.shape, generator=gen,
                           device="cuda").to(dtype)
    k8, ks, v8, vs = _int8_pool(gen, n_pages)
    for name, k, v, scales, item in (
            ("paged_verify", native_k, native_v, {}, q.element_size()),
            ("paged_verify_int8", k8, v8, {"k_scale": ks, "v_scale": vs},
             "int8")):
        o, lse = pa._paged_verify_call(q, k, v, table, base, PAGE, **scales)
        o_ref, lse_ref = pa.paged_verify_prefix_reference(
            q, k, v, table, base, PAGE, **scales)
        # one slot through the verify entry = the prefill kernel, bit for
        # bit (one block body)
        o1, lse1 = pa._paged_verify_call(q[2:3].contiguous(), k, v,
                                         table[2:3].contiguous(),
                                         base[2:3].contiguous(), PAGE,
                                         **scales)
        o2, lse2 = pa._paged_prefill_call(q[2], k, v, table[2],
                                          SERVE_POS[2], PAGE, **scales)
        torch.cuda.synchronize()
        same = bool(torch.equal(o1[0], o2) and torch.equal(lse1[0], lse2.T))
        errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
        _check(name, "f32", errs)
        if not same:
            fail(f"{name} {kind}: a one-slot verify launch differs from the "
                 "prefill kernel's bits")
        ms = time_ms(lambda: pa._paged_verify_call(q, k, v, table, base,
                                                   PAGE, **scales))
        plain = time_ms(lambda: pa.paged_verify_prefix_reference(
            q, k, v, table, base, PAGE, **scales), iters=5)
        prefix = int(base.long().sum())
        n_bytes = (q.numel() * q.element_size() + _kv_bytes(prefix, item)
                   + o.numel() * 4 + lse.numel() * 4 + table.numel() * 4
                   + base.numel() * 4)
        bound, by = bound_ms(n_bytes, 4 * D * H * VERIFY_S * prefix, kind)
        row = {"name": name, "dtype": kind, "slots": SLOTS, "S": VERIFY_S,
               "base": list(SERVE_POS), "max_abs_err": max(errs.values()),
               "errs": errs, "tol": TOL["f32"], "single_slot_is_prefill": same,
               "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        record.append(row)
        emit({"phase": "kernels", **row})


# Llama-3.2-1B's attention at the train phase's batch: B 4, S 2048, 32
# query heads over 8 kv heads, head_dim 64
TB, TS, TH, THKV, TD = 4, 2048, 32, 8, 64


def _train_pairs(causal: bool) -> int:
    """Unmasked (query, key) pairs of self-attention over all heads."""
    per_head = TS * (TS + 1) // 2 if causal else TS * TS
    return TB * TH * per_head


def kernel_train_flash(gen, kind, dtype, record):
    import torch
    import torch.nn.functional as F

    from mlrun_tpu_torch.ops import attention as at

    dev = "cuda"
    q = torch.randn((TB, TS, TH, TD), generator=gen, device=dev).to(dtype)
    k = torch.randn((TB, TS, THKV, TD), generator=gen, device=dev).to(dtype)
    v = torch.randn((TB, TS, THKV, TD), generator=gen, device=dev).to(dtype)
    do = torch.randn((TB, TS, TH, TD), generator=gen, device=dev).to(dtype)
    item = q.element_size()
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    shape = {"B": TB, "S": TS, "H": TH, "Hkv": THKV, "D": TD}
    fwd_rows, bwd_rows = [], []
    for causal in (True, False):
        # forward: the Pallas _flash_fwd_kernel_v2 on the main path
        o, lse = at.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
        del o_ref, lse_ref
        _check(f"flash_fwd causal={causal}", kind, errs)
        ms = time_ms(lambda: at.flash_fwd(q, k, v, causal), iters=10)
        plain = time_ms(lambda: at.flash_fwd_plain(q, k, v, causal),
                        iters=3, warmup=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=10)
        n_bytes = (2 * q.numel() + 2 * k.numel()) * item + lse.numel() * 4
        bound, by = bound_ms(n_bytes, 4 * TD * _train_pairs(causal), kind)
        row = {"name": "flash_fwd", "dtype": kind, "causal": causal,
               **shape, "max_abs_err": max(errs.values()), "errs": errs,
               "tol": TOL[kind], "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        fwd_rows.append(row)
        emit({"phase": "kernels", **row})

        # backward: the counterpart of the reference's _blockwise_bwd
        grads = at.flash_bwd(q, k, v, o, lse, do, causal)
        if kind == "f32":
            refs = at.flash_bwd_plain(q, k, v, o, lse, do, causal)
        else:   # float32 on the same bf16 values, not rounded at the end
            refs = at.flash_bwd_plain(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), causal)
        torch.cuda.synchronize()
        errs, tols, worst = {}, {}, {}
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            errs[name] = _err(got, ref)
            top = float(ref.abs().max())
            if kind == "f32":
                tols[name] = GRAD_RTOL_F32 * max(top, 1.0)
                worst[name] = errs[name] / tols[name]
            else:
                tols[name] = {"rel": BF16_HALF_ULP,
                              "floor": BF16_GRAD_FLOOR * top}
                bound = ref.abs() * BF16_HALF_ULP + BF16_GRAD_FLOOR * top
                worst[name] = float(((got.float() - ref).abs()
                                     / bound).max())
            if not worst[name] <= 1.0:
                fail(f"flash_bwd causal={causal} {kind} {name}: error "
                     f"{worst[name]} x its bound (max_abs_err {errs[name]}, "
                     f"tol {tols[name]})")
        del grads, refs
        ms = time_ms(lambda: at.flash_bwd(q, k, v, o, lse, do, causal),
                     iters=5)
        plain = time_ms(lambda: at.flash_bwd_plain(q, k, v, o, lse, do,
                                                   causal), iters=2,
                        warmup=1)
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)
            torch.autograd.grad(out, leaves, dot)

        lib_ms = time_ms(sdpa_fwd_bwd, iters=5)
        # read q, k, v, o, dO and lse once; write dq, dk, dv
        n_bytes = (4 * q.numel() + 4 * k.numel()) * item + lse.numel() * 4
        bound, by = bound_ms(n_bytes, 10 * TD * _train_pairs(causal), kind)
        row = {"name": "flash_bwd", "dtype": kind, "causal": causal,
               **shape, "max_abs_err": max(errs.values()), "errs": errs,
               "tol": tols, "err_over_bound": worst, "ms": ms,
               "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms,
               "library_is": "scaled_dot_product_attention forward + "
                             "backward"}
        bwd_rows.append(row)
        emit({"phase": "kernels", **row})
    record.extend([fwd_rows[0], bwd_rows[0]])  # causal: the main path's
    # no atomics: two launches on the same inputs give the same bits
    o, lse = at.flash_fwd(q, k, v, True)
    first = at.flash_bwd(q, k, v, o, lse, do, True)
    second = at.flash_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    emit({"phase": "kernels", "name": "flash_bwd", "dtype": kind,
          "bit_identical_runs": same})
    if not same:
        fail(f"flash_bwd {kind}: two runs on the same inputs differ")


# the v1 flash entry point's shapes: (name, B, Sq, Sk, H, D, causal) —
# Llama-3-8B's prefill width, BERT-base's encoder (mlrun_tpu/models/bert.py
# :29-31), and ragged lengths that are not multiples of the 64-row tiles
V1_SHAPES = (("llama3-8b", 1, 2048, 2048, 32, 128, True),
             ("bert-base", 8, 512, 512, 12, 64, False),
             ("ragged", 1, 1000, 777, 32, 128, True),
             ("ragged", 1, 1000, 777, 32, 128, False))
# rms_norm_pallas's shapes: Llama-3-8B's and Llama-3.2-1B's hidden states
# at a 4 x 2048 batch, and a ragged row count and width
RMS_SHAPES = (("llama3-8b", (4, 2048, 4096)), ("llama3-1b", (4, 2048, 2048)),
              ("ragged", (1000, 4100)))
RMS_EPS = 1e-5
# rms_norm_pallas vs its plain version: float32 out within RMS_F32_RTOL of
# the plain value, bf16 out within one bf16 ulp of it (rsqrtf may sit an
# ulp from torch.rsqrt, and the two sum the squares in another order)
RMS_F32_RTOL = 2e-6


def _v1_pairs(sq: int, sk: int, causal: bool) -> int:
    """Unmasked (query, key) pairs of one head, top-left causal."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def kernel_flash_v1(gen, kind, dtype, record):
    """The v1 flash entry point ``_flash_fwd`` (the Pallas
    ``_flash_fwd_kernel``; the port launches ``mlt_flash_fwd``) at its
    shapes, against ``flash_fwd_plain``; the library call is SDPA with
    ``is_causal`` (top-left, as v1)."""
    import torch
    import torch.nn.functional as F

    from mlrun_tpu_torch.ops import attention as at

    dev = "cuda"
    rows = []
    for name, b, sq, sk, h, d, causal in V1_SHAPES:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
        o, lse = at._flash_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
        del o_ref, lse_ref
        _check(f"flash_v1 {name} Sq={sq} Sk={sk} causal={causal}", kind,
               errs)
        ms = time_ms(lambda: at._flash_fwd(q, k, v, causal=causal),
                     iters=10)
        plain = time_ms(lambda: at.flash_fwd_plain(q, k, v, causal),
                        iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=10)
        item = q.element_size()
        n_bytes = 2 * (q.numel() + k.numel()) * item + lse.numel() * 4
        n_ops = 4 * d * b * h * _v1_pairs(sq, sk, causal)
        bound, by = bound_ms(n_bytes, n_ops, kind)
        row = {"name": "flash_v1", "dtype": kind, "shape": name, "B": b,
               "Sq": sq, "Sk": sk, "H": h, "D": d, "causal": causal,
               "max_abs_err": max(errs.values()), "errs": errs,
               "tol": TOL[kind], "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        rows.append(row)
        emit({"phase": "kernels", **row})
    record.append(rows[0])  # the 8B prefill width


def _bf16_ulp(x):
    import torch

    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_rms_norm(gen, kind, dtype, record):
    """``rms_norm_pallas`` (the Pallas ``_rms_norm_kernel``; the port
    launches ``csrc/rms_norm.cu``) with a float32 scale at its shapes,
    against ``rms_norm_pallas_plain``; the library call is
    ``torch.nn.functional.rms_norm`` on the same inputs."""
    import torch
    import torch.nn.functional as F

    from mlrun_tpu_torch.ops import norms

    dev = "cuda"
    rows = []
    for name, shape in RMS_SHAPES:
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
        scale = torch.randn(shape[-1:], generator=gen, device=dev)
        out = norms.rms_norm_pallas(x, scale, RMS_EPS)
        ref = norms.rms_norm_pallas_plain(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        if kind == "f32":
            limit = RMS_F32_RTOL * ref.float().abs()
            tol = {"rel": RMS_F32_RTOL}
        else:
            limit = _bf16_ulp(ref)
            tol = {"ulp": 1}
        worst = float((diff / limit.clamp_min(1e-30)).max())
        if not bool((diff <= limit).all()):
            fail(f"rms_norm {name} {kind}: max error {float(diff.max())}, "
                 f"{worst} x its bound {tol}")
        ms = time_ms(lambda: norms.rms_norm_pallas(x, scale, RMS_EPS))
        plain = time_ms(lambda: norms.rms_norm_pallas_plain(x, scale,
                                                            RMS_EPS), iters=5)
        features = shape[-1]
        lib_ms = time_ms(lambda: F.rms_norm(x, (features,), weight=scale,
                                            eps=RMS_EPS))
        # the same call with the scale in x's dtype (PyTorch's fused path)
        scale_x = scale.to(dtype)
        lib_x_ms = time_ms(lambda: F.rms_norm(x, (features,), weight=scale_x,
                                              eps=RMS_EPS))
        n_bytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        bound, by = bound_ms(n_bytes, 4 * x.numel(), kind)
        row = {"name": "rms_norm", "dtype": kind, "shape": name,
               "x": list(shape), "scale_dtype": "f32",
               "max_abs_err": float(diff.max()), "err_over_bound": worst,
               "tol": tol, "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms,
               "library_x_dtype_scale_ms": lib_x_ms}
        rows.append(row)
        emit({"phase": "kernels", **row})
    record.append(rows[0])  # the 8B hidden state


def op_paths(gen) -> dict:
    """The path of the two kernels no engine or trainer reaches: their op
    entry points, driven once at each main-path shape in bf16 with the
    counts reset just before. Returns the launch counts."""
    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.ops import attention as at
    from mlrun_tpu_torch.ops import norms

    dev, dtype = "cuda", torch.bfloat16
    inputs = []
    for _, b, sq, sk, h, d, causal in V1_SHAPES:
        inputs.append([torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, sq, h, d), (b, sk, h, d),
                                     (b, sk, h, d))] + [causal])
    rms_inputs = [(torch.randn(shape, generator=gen, device=dev).to(dtype),
                   torch.randn(shape[-1:], generator=gen, device=dev))
                  for _, shape in RMS_SHAPES]
    _build.reset_launch_counts()
    outs = [at._flash_fwd(q, k, v, causal=c)[0] for q, k, v, c in inputs]
    outs += [norms.rms_norm_pallas(x, s, RMS_EPS) for x, s in rms_inputs]
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    _check_launches(launches, ("flash_v1", "rms_norm"), "op entry point")
    if launches["flash_v1"] != len(V1_SHAPES) \
            or launches["rms_norm"] != len(RMS_SHAPES):
        fail(f"op entry points: launches {launches}")
    for out in outs:
        if not bool(torch.isfinite(out).all()):
            fail("op entry points: non-finite output")
    emit({"phase": "kernels", "path": "op entry points",
          "launches": {k: launches[k] for k in ("flash_v1", "rms_norm")}})
    return {k: launches[k] for k in ("flash_v1", "rms_norm")}


def phase_kernels(seed: int) -> tuple[list, dict]:
    """Every kernel against its plain version in bf16 and f32 (the bf16
    rows go on the final line), then the op entry points' path."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    record = []
    for kind, dtype in _dtypes():
        kernel_decode(gen, kind, dtype, record)
        kernel_flash(gen, kind, dtype, record)
        kernel_prefill(gen, kind, dtype, record)
        kernel_decode_int8(gen, kind, dtype, record)
        kernel_prefill_int8(gen, kind, dtype, record)
        kernel_verify(gen, kind, dtype, record)
        kernel_train_flash(gen, kind, dtype, record)
        kernel_flash_v1(gen, kind, dtype, record)
        kernel_rms_norm(gen, kind, dtype, record)
        torch.cuda.empty_cache()
    launches = op_paths(gen)
    return [r for r in record if r["dtype"] == "bf16"], launches


# ---------------------------------------------------------------------------
# phase 3: serve Llama-3-8B through the port's main path
# ---------------------------------------------------------------------------

MAX_NEW = 32


class _Event:
    def __init__(self, body):
        self.body = body
        self.path = "/v2/models/llama3-8b/infer"


def _prompts(seed: int, vocab: int):
    """Four prompts of 200-700 tokens, two sharing a 256-token (two-page)
    prefix; token ids drawn from numpy's generator."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(1, vocab, size=n).tolist()

    shared = draw(256)
    return [shared + draw(344), shared + draw(180), draw(200), draw(700)]


def _record_first_logits(engine, sink: list):
    """Keep each admission's first-token logits (admissions run in submit
    order on the one scheduler thread)."""
    first_token = engine._first_token

    def wrapped(logits, sampling):
        sink.append(logits[0].float().cpu())
        return first_token(logits, sampling)

    engine._first_token = wrapped


def _serve_events(submit_event, prompts):
    """The main path's traffic: one event with the four prompts, then one
    repeating the first (a prefix-cache hit)."""
    outputs = list(submit_event(prompts))
    outputs += list(submit_event([prompts[0]]))
    return outputs


def _check_launches(launches: dict, expected, path: str):
    """Every kernel of ``expected`` launched on the path, no other kernel
    launched at all."""
    for name, count in launches.items():
        if name in expected and count <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
        if name not in expected and count != 0:
            fail(f"kernel {name} was launched {count} times on the {path} "
                 "path")


def _submit_engine(engine):
    def submit(batch):
        futures = [engine.submit(p, max_new_tokens=MAX_NEW) for p in batch]
        return [f.result(timeout=600)[0] for f in futures]

    return submit


def _compare(logits_a, out_a, logits_b, out_b):
    """(max relative first-token logit error, first tokens identical,
    share of greedy tokens identical) of two engines on the same
    traffic."""
    import torch

    if len(logits_a) != len(logits_b):
        fail("engines admitted different request counts")
    rel = []
    for x, y in zip(logits_a, logits_b):
        if not bool(torch.isfinite(x).all()):
            fail("non-finite first-token logits")
        rel.append(float((x - y).abs().max() / y.abs().max()))
    same = sum(x == y for ka, ra in zip(out_a, out_b)
               for x, y in zip(ka, ra))
    first = sum(ka[0] == ra[0] for ka, ra in zip(out_a, out_b))
    return (max(rel), f"{first}/{len(out_a)}",
            same / sum(len(t) for t in out_a))


def phase_serve(seed: int, card: str, kv_dtype: str = "native",
                native: dict | None = None) -> dict:
    """Serve the five requests through LLMModelServer on a ``kv_dtype``
    pool with the kernels, then on a reference-attention engine with the
    same weights and pool type. On the int8 pool, ``native`` (the native
    serve phase's result) gives the quantization's own error."""
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMModelServer
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    phase = "serve" if kv_dtype == "native" else "serve_int8"
    kernels = SERVING_KERNELS if kv_dtype == "native" else INT8_KERNELS
    config = MODEL_PRESETS["llama3-8b"]()
    prompts = _prompts(seed, config.vocab_size)

    # -- the main path, counted: every count reset right before it ---------
    _build.reset_launch_counts()
    started = time.perf_counter()
    server = LLMModelServer(
        name="llama3-8b", model_preset="llama3-8b", continuous_batching=True,
        paged=True, slots=4, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, kv_dtype=kv_dtype, seed=seed)
    server.post_init()
    if not server.ready:
        fail(f"LLMModelServer failed to load: {server.error}")
    load_s = time.perf_counter() - started
    kernel_logits: list = []
    _record_first_logits(server.engine, kernel_logits)

    def submit_server(batch):
        return server.do_event(_Event({"inputs": batch})).body["outputs"]

    t0 = time.perf_counter()
    kernel_out = _serve_events(submit_server, prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    stats = server.engine.stats
    metrics = dict(server.metrics)
    params = server.engine.params
    server.close()

    _check_launches(launches, kernels, phase)
    if not stats["attn_kernel_ticks"] > 0:
        fail("no decode tick ran on the paged decode kernel")
    if not stats["prefill_kernel_chunks"] > 0:
        fail("no prefix-hit prefill ran on the paged prefill kernel")
    if stats["prefill_gather_admissions"] != 0:
        fail("a prefix hit fell back to the dense gather")
    if stats["attn_gather_ticks"] != 0:
        fail("a decode tick fell back to the gather path")
    if not stats.get("prefix_hit_rate", 0) > 0:
        fail("the prefix cache never hit")
    for tokens in kernel_out:
        if len(tokens) != MAX_NEW or not all(
                0 <= t < config.vocab_size for t in tokens):
            fail(f"bad output tokens: {tokens[:8]}... ({len(tokens)})")

    # -- the same traffic on a reference-attention engine, same weights ----
    ref_engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=4, page_size=PAGE,
        kv_dtype=kv_dtype, attention_impl="reference", seed=seed,
        device="cuda")
    ref_logits: list = []
    _record_first_logits(ref_engine, ref_logits)
    ref_out = _serve_events(_submit_engine(ref_engine), prompts)
    ref_stats = ref_engine.stats
    ref_engine.stop()
    if _build.launch_counts() != launches:
        fail("the reference engine launched a kernel")

    rel_err, first_same, share = _compare(kernel_logits, kernel_out,
                                          ref_logits, ref_out)
    result = {
        "phase": phase, "model": "llama3-8b", "layers": config.n_layers,
        "kv_dtype": kv_dtype, "card": card, "requests": len(kernel_out),
        "prompt_lens": [len(p) for p in prompts] + [len(prompts[0])],
        "max_new_tokens": MAX_NEW, "load_s": load_s, "serve_s": serve_s,
        "launches": launches,
        "attn_kernel_ticks": stats["attn_kernel_ticks"],
        "prefill_kernel_chunks": stats["prefill_kernel_chunks"],
        "prefill_gather_admissions": stats["prefill_gather_admissions"],
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "ttft_p50_s": stats.get("ttft_p50_s"),
        "itl_p50_s": stats.get("itl_p50_s"),
        "decode_tick_p50_s": stats.get("decode_tick_p50_s"),
        "decode_tps": metrics.get("decode_tps"),
        "reference_ttft_p50_s": ref_stats.get("ttft_p50_s"),
        "reference_decode_tick_p50_s": ref_stats.get("decode_tick_p50_s"),
        "first_logits_max_rel_err": rel_err,
        "first_logits_rel_tol": LOGIT_REL_TOL,
        "first_tokens_identical": first_same,
        "greedy_token_share_identical": share,
    }
    if native is not None:
        # the quantization's own error: the int8 pool against the native
        # pool, both on the kernels, same weights and traffic
        q_err, q_first, q_share = _compare(kernel_logits, kernel_out,
                                           native["first_logits"],
                                           native["outputs"])
        result.update({"vs_native_first_logits_max_rel_diff": q_err,
                       "vs_native_first_tokens_identical": q_first,
                       "vs_native_greedy_token_share_identical": q_share})
    emit(result)
    if not rel_err <= LOGIT_REL_TOL:
        fail(f"first-token logits ({kv_dtype} pool): kernel vs reference max "
             f"relative error {rel_err} > {LOGIT_REL_TOL}")
    return {**result, "first_logits": kernel_logits, "outputs": kernel_out}


# speculative phase: the permutation pair at Llama-3-8B width, depth cut to
# PERM_LAYERS (every transformer weight is zero: the layers add time and
# nothing else); the draft proposes SPEC_K tokens a round
PERM_LAYERS = 4
PERM_OVERLAP = 0.7
SPEC_K = 4
# spec-on vs spec-off on random weights (bf16, 32 layers): the verify
# forward and the decode forward round differently, by about the serve
# phase's first-token logit error (LOGIT_REL_TOL of the largest logit). So
# the two streams must agree until the first position where the two
# tokens are a near-tie of the target's teacher-forced float32 logits
# (within SPEC_REL_TOL of the position's largest |logit|), and every token
# the speculative server emitted must be such a near-argmax of the target
SPEC_REL_TOL = LOGIT_REL_TOL


def _teacher_logits(config, params, prompt, tokens):
    """The target's float32 logits at each generated position of
    ``prompt + tokens``, from one teacher-forced forward: [len(tokens),
    vocab]."""
    import torch

    from mlrun_tpu_torch.models.llama import forward

    seq = torch.tensor([prompt + tokens[:-1]], device="cuda")
    with torch.no_grad():
        return forward(config, params, seq)[0, len(prompt) - 1:].float()


def _stream_check(config, params, prompt, spec, plain) -> dict:
    """Where the speculative stream ``spec`` departs from ``plain`` and how
    close to a tie that was; the worst near-argmax gap over ``spec``; the
    first position of ``plain`` whose top-2 margin is within the noise."""
    import torch

    def tol(row):
        return SPEC_REL_TOL * float(row.abs().max())

    plain_logits = _teacher_logits(config, params, prompt, plain)
    top2 = torch.topk(plain_logits, 2, dim=-1).values
    low = [i for i, row in enumerate(plain_logits)
           if float(top2[i, 0] - top2[i, 1]) < tol(row)]
    depart = next((i for i, (a, b) in enumerate(zip(spec, plain))
                   if a != b), len(plain))
    tie = None
    if depart < len(plain):
        row = plain_logits[depart]
        tie = float((row[plain[depart]] - row[spec[depart]]).abs()) \
            / float(row.abs().max())
    spec_logits = _teacher_logits(config, params, prompt, spec)
    gaps = [float(row.max() - row[t]) / float(row.abs().max())
            for row, t in zip(spec_logits, spec)]
    return {"identical_prefix": depart,
            "first_low_margin": low[0] if low else len(plain),
            "tie_at_departure_rel": tie, "worst_argmax_gap_rel": max(gaps)}


def phase_spec(seed: int, card: str) -> dict:
    """In-engine speculative decoding on the paged engine: (1) the port's
    own permutation pair at 8B width, native and int8 pools, spec on ==
    spec off exactly; (2) LLMModelServer at Llama-3-8B on an int8 pool with
    a random Llama-3.2-1B draft, against the spec-off engine on the same
    weights."""
    import dataclasses
    import gc

    import torch

    from mlrun_tpu_torch.models.llama import (
        MODEL_PRESETS,
        init_permutation_params,
        permutation_pair,
    )
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMModelServer
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    config = dataclasses.replace(MODEL_PRESETS["llama3-8b"](),
                                 n_layers=PERM_LAYERS)
    prompts = _prompts(seed, config.vocab_size)
    target_perm, draft_perm = permutation_pair(config.vocab_size,
                                               PERM_OVERLAP, seed=seed)
    target = init_permutation_params(config, target_perm, device="cuda")
    draft = init_permutation_params(config, draft_perm, device="cuda")
    perm_rows, launches = [], {}
    for kv_dtype in ("native", "int8"):
        outs = []
        for spec in (None, {"enabled": True, "k": SPEC_K,
                            "draft_config": config, "draft_params": draft}):
            engine = PagedContinuousBatchingEngine(
                config, target, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
                kv_dtype=kv_dtype, speculative=spec, seed=seed,
                device="cuda")
            # the main path of the native verify kernel, counted
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            outs.append(_serve_events(_submit_engine(engine), prompts))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _build.launch_counts()
            stats = engine.stats
            engine.stop()
        verify = "paged_verify" if kv_dtype == "native" else \
            "paged_verify_int8"
        if kv_dtype == "native":
            launches["paged_verify"] = counts["paged_verify"]
        if outs[0] != outs[1]:
            fail(f"permutation pair ({kv_dtype} pool): spec-on streams "
                 "differ from spec-off streams")
        if not counts[verify] > 0 or stats["attn_gather_ticks"]:
            fail(f"permutation pair ({kv_dtype} pool): the verify kernel "
                 "did not run every round")
        row = {"phase": "spec", "leg": "permutation", "model":
               f"llama3-8b width, {PERM_LAYERS} zero layers",
               "kv_dtype": kv_dtype, "overlap": PERM_OVERLAP, "k": SPEC_K,
               "spec_equals_plain": True, "serve_s": seconds,
               "verify_launches": counts[verify],
               "spec_rounds": stats["spec_rounds"],
               "acceptance_rate": stats["acceptance_rate"],
               "spec_tokens_per_round": stats["spec_tokens_per_round"],
               "card": card}
        perm_rows.append(row)
        emit(row)
        if not (0 < stats["acceptance_rate"] < 1
                and stats["spec_tokens_per_round"] > 1):
            fail(f"permutation pair ({kv_dtype} pool): acceptance "
                 f"{stats['acceptance_rate']}, tokens per round "
                 f"{stats['spec_tokens_per_round']}")
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()

    # -- the server with a draft preset, int8 pool, counted ----------------
    config = MODEL_PRESETS["llama3-8b"]()
    prompts = _prompts(seed, config.vocab_size)
    _build.reset_launch_counts()
    started = time.perf_counter()
    server = LLMModelServer(
        name="llama3-8b", model_preset="llama3-8b", continuous_batching=True,
        paged=True, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, kv_dtype="int8", seed=seed,
        speculative={"draft": "llama3-1b", "k": SPEC_K})
    server.post_init()
    if not server.ready:
        fail(f"LLMModelServer (speculative) failed to load: {server.error}")
    load_s = time.perf_counter() - started

    def submit_server(batch):
        return server.do_event(_Event({"inputs": batch})).body["outputs"]

    t0 = time.perf_counter()
    spec_out = _serve_events(submit_server, prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = server.engine.stats
    params = server.engine.params
    server.close()
    launches["paged_verify_int8"] = counts["paged_verify_int8"]
    _check_launches(counts, INT8_KERNELS + ("paged_verify_int8",),
                    "speculative int8 serving")
    if stats["attn_gather_ticks"] != 0:
        fail("a speculative tick fell back to the gather path")

    engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        kv_dtype="int8", seed=seed, device="cuda")
    plain_out = _serve_events(_submit_engine(engine), prompts)
    engine.stop()
    agree = [_stream_check(config, params, prompt, got, want)
             for prompt, got, want in zip(prompts + [prompts[0]], spec_out,
                                          plain_out)]
    result = {"phase": "spec", "leg": "server", "model": "llama3-8b",
              "draft": "llama3-1b", "kv_dtype": "int8", "k": SPEC_K,
              "card": card, "load_s": load_s, "serve_s": serve_s,
              "launches": counts, "spec_rounds": stats["spec_rounds"],
              "acceptance_rate": stats["acceptance_rate"],
              "spec_tokens_per_round": stats["spec_tokens_per_round"],
              "spec_resyncs": stats["spec_resyncs"],
              "attn_kernel_ticks": stats["attn_kernel_ticks"],
              "ttft_p50_s": stats.get("ttft_p50_s"),
              "itl_p50_s": stats.get("itl_p50_s"),
              "rel_tol": SPEC_REL_TOL, "streams": agree}
    emit(result)
    for i, row in enumerate(agree):
        if row["tie_at_departure_rel"] is not None \
                and not row["tie_at_departure_rel"] <= SPEC_REL_TOL:
            fail(f"speculative server, stream {i}: departs from spec-off at "
                 f"token {row['identical_prefix']} where the target's two "
                 f"tokens are {row['tie_at_departure_rel']} apart")
        if not row["worst_argmax_gap_rel"] <= SPEC_REL_TOL:
            fail(f"speculative server, stream {i}: emitted a token "
                 f"{row['worst_argmax_gap_rel']} below the target's argmax")
    return {"launches": launches, "permutation": perm_rows,
            "server": result}


# ---------------------------------------------------------------------------
# phase 6: serve_dense — LLMModelServer's default engine (LLMEngine) and the
# dense ContinuousBatchingEngine at Llama-3-8B
# ---------------------------------------------------------------------------

# the dense engine's chunked prefill: the 600- and 700-token prompts resume
# across ticks at q_offset 256 and 512
DENSE_CHUNK = 256


def _record_sampled_logits(engine, sink: list):
    """LLMEngine: keep each request's first-token logits (a greedy request
    samples only its first token; its decode chunks take the argmax on the
    card)."""
    sample = engine._sample

    def wrapped(logits):
        sink.append(logits[0].float().cpu())
        return sample(logits)

    engine._sample = wrapped


def _serve_dense_leg(seed: int, card: str, leg: str, config,
                     prompts) -> dict:
    """One of the two non-paged LLMModelServer configurations at Llama-3-8B
    (random weights from ``seed``, all 32 layers), counted from its
    construction, then the same traffic on a reference-attention engine
    with the same weights."""
    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMEngine, LLMModelServer
    from mlrun_tpu_torch.serving.llm_batch import ContinuousBatchingEngine

    default = leg == "llm_engine"
    kwargs = {} if default else {"continuous_batching": True,
                                 "slots": SLOTS,
                                 "prefill_chunk": DENSE_CHUNK}
    _build.reset_launch_counts()
    started = time.perf_counter()
    server = LLMModelServer(name="llama3-8b", model_preset="llama3-8b",
                            max_len=MAX_LEN, max_new_tokens=MAX_NEW,
                            seed=seed, **kwargs)
    server.post_init()
    if not server.ready:
        fail(f"LLMModelServer ({leg}) failed to load: {server.error}")
    load_s = time.perf_counter() - started
    engine = server.engine
    expected = LLMEngine if default else ContinuousBatchingEngine
    if type(engine) is not expected:
        fail(f"LLMModelServer ({leg}) built a {type(engine).__name__}")
    logits: list = []
    per_request: list = []
    if default:
        _record_sampled_logits(engine, logits)
        generate = engine.generate

        def timed(*args, **kw):
            tokens, stats = generate(*args, **kw)
            per_request.append(stats)
            return tokens, stats

        engine.generate = timed
    else:
        _record_first_logits(engine, logits)

    def submit_server(batch):
        return server.do_event(_Event({"inputs": batch})).body["outputs"]

    t0 = time.perf_counter()
    out = _serve_events(submit_server, prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    stats = {} if default else engine.stats
    metrics = dict(server.metrics)
    params = engine.params
    buckets = engine.prefill_buckets
    server.close()
    del server, engine

    traffic = prompts + [prompts[0]]
    # prefill dispatches of S > 1, one flash launch a layer each: LLMEngine
    # warms every bucket and prefills each request once; the dense engine
    # warms one bucket and runs every chunk it counts
    prefills = (len(buckets) + len(traffic) if default
                else 1 + stats["prefill_chunks"])
    _check_launches(launches, ("flash_fwd_cached",), f"serve_dense {leg}")
    if launches["flash_fwd_cached"] != config.n_layers * prefills:
        fail(f"serve_dense {leg}: flash_fwd_cached launched "
             f"{launches['flash_fwd_cached']} times for {prefills} prefill "
             f"dispatches of {config.n_layers} layers")
    for tokens in out:
        if len(tokens) != MAX_NEW or not all(
                0 <= t < config.vocab_size for t in tokens):
            fail(f"bad output tokens: {tokens[:8]}... ({len(tokens)})")

    ref_logits: list = []
    if default:
        ref = LLMEngine(config, params, max_len=MAX_LEN,
                        attention_impl="reference", seed=seed, device="cuda")
        _record_sampled_logits(ref, ref_logits)
        ref_out = [ref.generate(p, max_new_tokens=MAX_NEW)[0]
                   for p in traffic]
    else:
        ref = ContinuousBatchingEngine(
            config, params, max_len=MAX_LEN, slots=SLOTS,
            prefill_chunk=DENSE_CHUNK, attention_impl="reference", seed=seed,
            device="cuda")
        _record_first_logits(ref, ref_logits)
        ref_out = _serve_events(_submit_engine(ref), prompts)
        ref.stop()
    del ref, params
    if _build.launch_counts() != launches:
        fail(f"serve_dense {leg}: the reference engine launched a kernel")
    rel_err, first_same, share = _compare(logits, out, ref_logits, ref_out)
    if default:
        ttfts = sorted(r["ttft_s"] for r in per_request)
        ttft_p50 = ttfts[(len(ttfts) - 1) // 2]
        decode_tps = [r["decode_tokens_per_sec"] for r in per_request]
    else:
        ttft_p50 = stats.get("ttft_p50_s")
        decode_tps = metrics.get("decode_tps")
    result = {
        "phase": "serve_dense", "leg": leg, "model": "llama3-8b",
        "layers": config.n_layers, "card": card,
        "engine": expected.__name__, "requests": len(out),
        "prompt_lens": [len(p) for p in traffic],
        "max_new_tokens": MAX_NEW, "load_s": load_s, "serve_s": serve_s,
        "prefill_chunk": None if default else DENSE_CHUNK,
        "prefill_dispatches": prefills, "launches": launches,
        "ttft_p50_s": ttft_p50, "decode_tps": decode_tps,
        "itl_p50_s": stats.get("itl_p50_s"),
        "decode_tick_p50_s": stats.get("decode_tick_p50_s"),
        "first_logits_max_rel_err": rel_err,
        "first_logits_rel_tol": LOGIT_REL_TOL,
        "first_tokens_identical": first_same,
        "greedy_token_share_identical": share,
    }
    emit(result)
    if not rel_err <= LOGIT_REL_TOL:
        fail(f"serve_dense {leg}: first-token logits, kernel vs reference "
             f"max relative error {rel_err} > {LOGIT_REL_TOL}")
    return result


def phase_serve_dense(seed: int, card: str) -> dict:
    """LLMModelServer's two non-paged configurations at Llama-3-8B: (a) its
    defaults (an LLMEngine), (b) ``continuous_batching=True`` (the dense
    engine, chunked prefill); each against a reference-attention engine.
    (c) The permutation pair at 8B width on the dense engine, native and
    int8 caches: spec on == spec off."""
    import dataclasses
    import gc

    import torch

    from mlrun_tpu_torch.models.llama import (
        MODEL_PRESETS,
        init_permutation_params,
        permutation_pair,
    )
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm_batch import ContinuousBatchingEngine

    config = MODEL_PRESETS["llama3-8b"]()
    prompts = _prompts(seed, config.vocab_size)
    legs = {}
    for leg in ("llm_engine", "dense_engine"):
        legs[leg] = _serve_dense_leg(seed, card, leg, config, prompts)
        gc.collect()
        torch.cuda.empty_cache()

    config = dataclasses.replace(config, n_layers=PERM_LAYERS)
    target_perm, draft_perm = permutation_pair(config.vocab_size,
                                               PERM_OVERLAP, seed=seed)
    target = init_permutation_params(config, target_perm, device="cuda")
    draft = init_permutation_params(config, draft_perm, device="cuda")
    perm_rows = []
    for kv_dtype in ("native", "int8"):
        outs = []
        for spec in (None, {"enabled": True, "k": SPEC_K,
                            "draft_config": config, "draft_params": draft}):
            engine = ContinuousBatchingEngine(
                config, target, max_len=MAX_LEN, slots=SLOTS,
                kv_dtype=kv_dtype, speculative=spec, seed=seed,
                device="cuda")
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            outs.append(_serve_events(_submit_engine(engine), prompts))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _build.launch_counts()
            stats = engine.stats
            engine.stop()
            _check_launches(counts, ("flash_fwd_cached",),
                            f"dense permutation pair ({kv_dtype})")
        if outs[0] != outs[1]:
            fail(f"dense permutation pair ({kv_dtype} cache): spec-on "
                 "streams differ from spec-off streams")
        row = {"phase": "serve_dense", "leg": "permutation",
               "model": f"llama3-8b width, {PERM_LAYERS} zero layers",
               "engine": "ContinuousBatchingEngine", "kv_dtype": kv_dtype,
               "overlap": PERM_OVERLAP, "k": SPEC_K,
               "spec_equals_plain": True, "serve_s": seconds,
               "spec_rounds": stats["spec_rounds"],
               "acceptance_rate": stats["acceptance_rate"],
               "spec_tokens_per_round": stats["spec_tokens_per_round"],
               "card": card}
        perm_rows.append(row)
        emit(row)
        if not (0 < stats["acceptance_rate"] < 1
                and stats["spec_tokens_per_round"] > 1):
            fail(f"dense permutation pair ({kv_dtype} cache): acceptance "
                 f"{stats['acceptance_rate']}, tokens per round "
                 f"{stats['spec_tokens_per_round']}")
    del target, draft
    return {**legs, "permutation": perm_rows}


# ---------------------------------------------------------------------------
# phase 7: train Llama-3.2-1B through the port's Trainer
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ, LOSS_CHUNK = 4, 2048, 512


def _leaf_names(tree, prefix="") -> list:
    """Dotted names of a param tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [name for key in sorted(tree)
                for name in _leaf_names(tree[key], f"{prefix}{key}.")]
    return [prefix[:-1]]


def _attention_grads(trainer, tokens, targets) -> tuple[dict, dict]:
    """Step 1's gradient on ``trainer``'s params through the step's own
    gradient function: the attention weights' gradients by name, and the
    loss and pre-clip global norm the step reports as metrics."""
    import torch

    from mlrun_tpu_torch.training.train import global_norm

    grads, metrics = trainer.step_fn.compute_grads(trainer.state.params,
                                                   tokens, targets)
    step = {"loss": float(metrics["loss"]),
            "grad_norm": float(global_norm(grads))}
    named = dict(zip(_leaf_names(trainer.state.params), grads))
    kept = {name: named[name] for name in ATTENTION_LEAVES}
    del grads, named
    torch.cuda.synchronize()
    return kept, step


def phase_train(seed: int, card: str) -> dict:
    import dataclasses
    import gc
    import math

    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.data import synthetic_token_stream, to_device

    config = MODEL_PRESETS["llama3-1b"]()
    tokens, targets = next(synthetic_token_stream(
        TRAIN_BATCH, TRAIN_SEQ, config.vocab_size, seed=seed))
    tokens_dev, targets_dev = to_device((tokens, targets), "cuda")

    def repeated():
        while True:
            yield tokens, targets

    train_config = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                               total_steps=TRAIN_STEPS,
                               loss_chunk=LOSS_CHUNK)

    def step1(model_config):
        """Step 1's gradient of a fresh Trainer on the seeded params."""
        other = Trainer(model_config, train_config, device="cuda")
        other.init(seed)
        started = time.perf_counter()
        out = _attention_grads(other, tokens_dev, targets_dev)
        seconds = time.perf_counter() - started
        del other
        gc.collect()
        torch.cuda.empty_cache()
        return (*out, seconds)

    def rel_diff(got, ref):
        got, ref = got.float(), ref.float()
        return float(torch.linalg.vector_norm(got - ref)
                     / torch.linalg.vector_norm(ref))

    # step 1 on the reference attention, bf16 and float32 (no kernel)
    before = _build.launch_counts()
    ref_grads, ref_step, ref_step_s = step1(
        dataclasses.replace(config, attention_impl="reference"))
    ref32_grads, ref32_step, _ = step1(dataclasses.replace(
        config, attention_impl="reference", dtype=torch.float32))
    if _build.launch_counts() != before:
        fail("the reference-attention train step launched a kernel")
    # the kernel path in float32 (uncounted: before the reset)
    k32_grads, k32_step, _ = step1(
        dataclasses.replace(config, dtype=torch.float32))
    f32_leaf_rel = {name: rel_diff(k32_grads[name], ref32_grads[name])
                    for name in ATTENTION_LEAVES}
    f32_loss_rel = abs(k32_step["loss"] - ref32_step["loss"]) \
        / abs(ref32_step["loss"])
    del k32_grads, ref32_grads

    trainer = Trainer(config, train_config, device="cuda")
    trainer.init(seed)
    warm = trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    # the bf16 kernel path's gradient (uncounted: before the reset)
    kernel_grads, kernel_step = _attention_grads(trainer, tokens_dev,
                                                 targets_dev)
    leaf_norm_rel, leaf_rel = {}, {}
    for name in ATTENTION_LEAVES:
        got, want_g = kernel_grads[name].float(), ref_grads[name].float()
        norm = torch.linalg.vector_norm
        leaf_norm_rel[name] = float(abs(norm(got) - norm(want_g))
                                    / norm(want_g))
        leaf_rel[name] = rel_diff(got, want_g)
    del kernel_grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()

    # -- the main path, counted: every count reset right before it ---------
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    trainer.fit(repeated(), TRAIN_STEPS, log_every=1, prefetch=2)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.metrics_history

    # throughput: the Trainer's own steady window (steps after the first),
    # as read at each log point
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    for view in history:
        emit({"phase": "train", "step": view["step"], "loss": view["loss"],
              "grad_norm": view["grad_norm"],
              "window_step_ms": tokens_per_step / view["tokens_per_sec"]
              * 1e3,
              "tokens_per_sec": view["tokens_per_sec"], "mfu": view["mfu"],
              "card": card})
    losses = [view["loss"] for view in history]
    norms = [view["grad_norm"] for view in history]
    loss_rel = abs(losses[0] - ref_step["loss"]) / abs(ref_step["loss"])
    norm_rel = abs(norms[0] - ref_step["grad_norm"]) / ref_step["grad_norm"]
    per_pass = config.n_layers * TRAIN_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    last = history[-1]
    result = {
        "phase": "train", "model": "llama3-1b", "layers": config.n_layers,
        "embed_dim": config.embed_dim, "card": card,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "loss_chunk": LOSS_CHUNK,
        "remat_policy": config.remat_policy, "steps": TRAIN_STEPS,
        "losses": losses, "grad_norms": norms,
        "step_ms": tokens_per_step / last["tokens_per_sec"] * 1e3,
        "tokens_per_sec": last["tokens_per_sec"], "mfu": last["mfu"],
        "goodput_fraction": last["goodput_fraction"],
        "compile_seconds": warm["compile_seconds"],
        "peak_memory_gib": peak_gb, "launches": launches,
        "expected_launches": want,
        "reference_step1": ref_step, "reference_step_s": ref_step_s,
        "kernel_step1_gradient": kernel_step,
        "step1_loss_rel_err": loss_rel,
        "step1_loss_rel_tol": TRAIN_LOSS_REL_TOL,
        "step1_grad_norm_rel_err": norm_rel,
        "step1_grad_norm_rel_tol": TRAIN_GRAD_NORM_REL_TOL,
        "step1_leaf_grad_norm_rel_err": leaf_norm_rel,
        "step1_leaf_grad_norm_rel_tol": TRAIN_LEAF_NORM_REL_TOL,
        "step1_leaf_grad_rel_diff_bf16": leaf_rel,
        "step1_f32_loss_rel_err": f32_loss_rel,
        "step1_f32_leaf_grad_rel_err": f32_leaf_rel,
        "step1_f32_leaf_grad_rel_tol": TRAIN_F32_LEAF_REL_TOL,
        "reference_step1_f32": ref32_step, "kernel_step1_f32": k32_step,
    }
    emit(result)
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    for name, count in want.items():
        if launches[name] != count:
            fail(f"kernel {name} launched {launches[name]} times on the "
                 f"train path, expected {count}")
    for name, count in launches.items():
        if name not in TRAINING_KERNELS and count != 0:
            fail(f"serving kernel {name} was launched on the train path")
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        fail(f"step 1 loss: kernel vs reference attention relative error "
             f"{loss_rel} > {TRAIN_LOSS_REL_TOL}")
    if not norm_rel <= TRAIN_GRAD_NORM_REL_TOL:
        fail(f"step 1 grad norm: kernel vs reference attention relative "
             f"error {norm_rel} > {TRAIN_GRAD_NORM_REL_TOL}")
    for name in ATTENTION_LEAVES:
        if not leaf_norm_rel[name] <= TRAIN_LEAF_NORM_REL_TOL:
            fail(f"step 1 gradient norm of {name}: kernel vs reference "
                 f"attention relative error {leaf_norm_rel[name]} > "
                 f"{TRAIN_LEAF_NORM_REL_TOL}")
        if not f32_leaf_rel[name] <= TRAIN_F32_LEAF_REL_TOL:
            fail(f"step 1 float32 gradient of {name}: kernel vs reference "
                 f"attention relative error {f32_leaf_rel[name]} > "
                 f"{TRAIN_F32_LEAF_REL_TOL}")
    return result


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ALL_PHASES = ("build", "kernels", "serve", "serve_int8", "spec",
              "serve_dense", "train")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import mlrun_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: mlrun_tpu_torch not found next to this script "
              f"({exc}); run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import gc

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    card = gpu_name_and_limit()
    kernels, launches, served = [], {}, None
    if "build" in phases:
        phase_build(card)
    if "kernels" in phases:
        kernels, op_launches = phase_kernels(args.seed)
        launches.update(op_launches)
    if "serve" in phases:
        served = phase_serve(args.seed, card)
        launches.update({name: served["launches"][name]
                         for name in SERVING_KERNELS})
        release()
    if "serve_int8" in phases:
        served = phase_serve(args.seed, card, "int8", native=served)
        launches.update({name: served["launches"][name]
                         for name in ("paged_decode_int8",
                                      "paged_prefill_int8")})
    served = None
    release()
    if "spec" in phases:
        launches.update(phase_spec(args.seed, card)["launches"])
        release()
    if "serve_dense" in phases:
        phase_serve_dense(args.seed, card)
        release()
    if "train" in phases:
        trained = phase_train(args.seed, card)
        launches.update({name: trained["launches"][name]
                         for name in TRAINING_KERNELS})
    if set(phases) != set(ALL_PHASES):
        return 0
    replaces = {
        "paged_decode": "mlrun_tpu/ops/paged_attention.py:163",
        "flash_fwd_cached": "mlrun_tpu/ops/attention.py:230",
        "paged_prefill": "mlrun_tpu/ops/paged_attention.py:305",
        # the quantized=True variants of the same two Pallas kernels
        "paged_decode_int8": "mlrun_tpu/ops/paged_attention.py:163",
        "paged_prefill_int8": "mlrun_tpu/ops/paged_attention.py:305",
        "paged_verify": "mlrun_tpu/ops/paged_attention.py:494",
        "paged_verify_int8": "mlrun_tpu/ops/paged_attention.py:494",
        "flash_fwd": "mlrun_tpu/ops/attention.py:223",
        # the reference's backward is XLA (_blockwise_bwd), not Pallas
        "flash_bwd": "mlrun_tpu/ops/attention.py:447",
        "flash_v1": "mlrun_tpu/ops/attention.py:87",
        "rms_norm": "mlrun_tpu/ops/norms.py:26",
    }
    sources = {
        "paged_decode": "mlrun_tpu_torch/csrc/paged_decode.cu",
        "paged_decode_int8": "mlrun_tpu_torch/csrc/paged_decode.cu",
        "flash_fwd_cached": "mlrun_tpu_torch/csrc/flash_fwd_cached.cu",
        "paged_prefill": "mlrun_tpu_torch/csrc/paged_prefill.cu",
        "paged_prefill_int8": "mlrun_tpu_torch/csrc/paged_prefill.cu",
        "paged_verify": "mlrun_tpu_torch/csrc/paged_prefill.cu",
        "paged_verify_int8": "mlrun_tpu_torch/csrc/paged_prefill.cu",
        "flash_fwd": "mlrun_tpu_torch/csrc/flash_fwd_cached.cu",
        "flash_bwd": "mlrun_tpu_torch/csrc/flash_bwd.cu",
        "flash_v1": "mlrun_tpu_torch/csrc/flash_fwd_cached.cu",
        "rms_norm": "mlrun_tpu_torch/csrc/rms_norm.cu",
    }
    line = [{"name": k["name"], "route": "cuda", "source": sources[k["name"]],
             "replaces": replaces[k["name"]],
             "launches": launches[k["name"]],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
             "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
            for k in kernels]
    print(card, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
