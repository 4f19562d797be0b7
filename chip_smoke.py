"""Chip smoke test of the PyTorch/CUDA port (mlrun_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing JSON lines (any failed check raises, so the script
exits non-zero and never prints the final line):

1. build   - first, before any engine boots, runs the port's static lint
             (``python -m mlrun_tpu_torch.analysis mlrun_tpu_torch``) in
             a child and fails on any finding or parse error, then
             ``python -m mlrun_tpu_torch version`` (the click CLI, under
             the card's click) and checks its line; then
             compiles the CUDA kernels from mlrun_tpu_torch/csrc (nvcc,
             sm_90a) and reports the build time, torch/CUDA versions and
             the card's name and power limit; counts the tensor-core
             instructions (HMMA/HGMMA in cuobjdump -sass) of every bf16
             tensor-core kernel (flash forward and backward, the paged
             prefill and verify bodies) and fails if one has none or
             ptxas reports a spill store in it.
2. kernels - holds each hand-written kernel (int8 and verify variants,
             the v1 flash entry point and RMSNorm included) against its
             plain PyTorch
             version at its main path's shapes, in bf16 and f32, with the
             stated tolerances; times kernel, plain version and, where one
             PyTorch call computes the same function
             (scaled_dot_product_attention, torch.nn.functional.rms_norm),
             with CUDA events around back-to-back calls (``ms``, the
             final line's); times each kernel again behind a sleep kernel
             (``device_ms``: the card's time alone, where ``ms`` of a
             short kernel reads its wrapper's host rate) and reads the
             host's enqueue time a call (``host_ms``); checks that
             chunked and unchunked flash prefill agree bit for bit, that
             two flash backward launches give the same bits, that two
             launches of each paged kernel give the same bits
             (bit_identical_runs), that each slot of a 4-slot paged
             decode gives the bits it gets decoded alone
             (batch_invariant) and that a one-slot verify gives the
             prefill's bits; times native decode also at the int8 row's
             positions (a phase line, off the final line); then
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
7. lora    - two LoRA adapters (t1, t2: rank 16, the default targets,
             random nonzero factors from the seed) on LLMModelServer's
             paged engine at Llama-3-8B (all 32 layers): the serve
             prompts as t1, t2, base and t1 in one decode batch, then the
             600-token prompt under t2 and under t1 through the v2 body's
             "adapter"; shows the paged kernels launched on that path (no
             gather fallback), that no prefix KV crosses tenants and a
             same-tenant rerun hits, holds each tenant's rows against an
             engine on its merged weights (first-token logits, greedy
             streams until a near-tie) and reports the decode tick and
             TTFT beside the serve phase's; then speculation with tenant
             rows on the permutation pair at 8B width (a tiny adapter;
             the base draft and a draft adapter): spec on == spec off.
8. train   - trains Llama-3.2-1B (random weights from a seed, bf16, all 16
             layers, full width) through Trainer.fit for a few steps on a
             repeated synthetic batch (4 x 2048 tokens, loss chunks of
             512, per-layer remat), shows the flash forward and backward
             kernels launched once per layer per pass, checks that the
             loss is finite and falls, reports the Trainer's own
             tokens/s and MFU, and holds step 1's loss, gradient norm and
             attention-weight gradients against the reference attention;
             then a LoRA leg (rank 16, frozen base, 3 steps): the loss
             falls, the base's checksum holds, the flash kernels launch
             once a layer a pass.
9. resilience - the degradation ladder, an armed llm.spec_verify, the
             max_wait expiry and the request ledger on the 8B server.
10. kv_tier - the host KV tier (demote, promote), the KV handoff and
             fetch_prefix / import_prefix on the 8B paged engine (the
             8B width, CUT_LAYERS layers: this phase, fleet and podfleet
             test host logic).
11. fleet  - the engine fleet over the 8B paged engine (CUT_LAYERS
             layers), every replica from one factory over one param
             dict: affinity routing on two
             replicas (a shared 512-token prefix on one replica, its hits
             on the paged prefill kernel), one prefill and one decode
             replica joined by the KV handoff (the decode replica runs no
             prefill), a third replica joining and a moved hot key's
             prefix pages fetched from the old owner (and the armed
             llm.kv_fetch fallback), re-dispatch after a replica crash and
             its drain, a concurrent burst, LLMModelServer with
             replicas=2 and prefill_replicas=1, and TpuModelServer over
             the 8B forward (one flash launch a layer); every stream held
             to a single engine's (one JSON line a leg).
12. families - the other model families, random weights from the seed,
             bf16: MoE through auto_trainer.train(moe_experts=8) at
             Mixtral-8x7B width (depth cut to 2 layers, printed; the batch
             halved if a step's peak passed 75 GB) for 4 steps, step 1
             held against the reference attention, forward + backward and
             the AdamW update timed apart, the dropped (token, choice)
             share read per layer; BERT-base's classifier step (B 8 x
             512, half the rows padded) and mlm_logits, ViT-B/16's step (B
             32, 224 x 224 x 3), each 3 steps and held the same way; the
             flash forward and backward launched the counted number of
             times on each; T5-base's step (B 8, 512 + 128), which reaches
             no kernel, with its float32 loss on the card held against
             the CPU's. The kernels phase holds rows 8 / 8b at these
             legs' attention shapes too.
13. entry_points - where users enter the two main paths: the serve
             phase's seeded Llama-3-8B params written as an HF checkpoint
             (BF16 safetensors in ~5 GB shards, an index and a config.json
             stating every field; no safetensors package) under a
             temporary directory, served by LLMModelServer(hf_model=) on
             the paged engine (all 32 layers): every loaded leaf
             bit-equal to the written one, the token streams equal to the
             preset server's, the three serving kernels launched, the
             write and load times, load GB/s and peak host RSS; the
             same checkpoint reloaded with shardings= for a one-rank
             mesh {"fsdp": 1} (a world-size-1 NCCL group): every leaf a
             DTensor bit-equal to the written one; string
             inputs through a word-level tokenizer where transformers is
             installed (else one skip line), and there too
             HuggingFaceModelServer's pipeline on the card by default,
             its scores on a tiny classifier within 1e-4 of the CPU's;
             then auto_trainer.train at
             Llama-3.2-1B (B 4 x 2048, all 16 layers) on a tokens .npy
             with epochs of 2 steps, early stopping, a checkpoint every 2
             steps and a recording callback: an early stop at step 4,
             checkpoints 2 and 4, the hooks' sequence, raw device metrics
             off the log points, the flash forward and backward launched
             the counted times; then evaluate from that checkpoint
             against a direct loss_fn (1e-4 relative), the flash forward
             once a layer a batch and no backward, the host's RSS rising
             by less than the checkpoint's params (the optimizer state is
             never read).
14. parallel - training on many GPUs at world size 1 (the card's machine
             has one GPU, and NCCL refuses two ranks on one): on a
             one-rank NCCL group, Trainer.fit at Llama-3.2-1B (B 4 x
             2048, all 16 layers) for 4 steps on the mesh {"data": 1,
             "fsdp": 1} (DTensor state, gathered for the step, gradients
             reduced back) against the no-mesh Trainer on the same seed
             and batches, in turns (no mesh, mesh, mesh, no mesh):
             losses and norms bit-equal (else within TRAIN_LOSS_REL_TOL,
             said), the flash launched the counted times, the step times
             of both; the sharded state saved at step
             2 through torch.distributed.checkpoint (seconds and bytes,
             beside a torch.save of the same state) and resumed by the
             environment's directive in a fresh Trainer, its steps 3-4
             bit-equal to the uninterrupted run's; then every rank's ring
             hops of an 8192-token sequence as 4 shards (H 32 / 8, D 64,
             bf16) run in ring order in this process: exactly 10 forward
             and 10 backward flash launches, o and lse within the kernel
             phase's TOL of the flash over the whole sequence, dq/dk/dv
             within a bound from each shard's hop count, and the summed
             hop times beside the full flash's. One line says why
             Ulysses has no check of its own at world size 1. Then,
             inside the NCCL group, Trainer.fit at 1B for 2 steps on
             {"data": 1, "fsdp": 1, "tensor": 1} (the per-layer-gather
             step) against no mesh and the whole-gather step
             (make_loss_step on the mesh): bit-equal, each run's
             torch.cuda.max_memory_allocated. Then one Llama-3-8B-width
             layer (B 1 x 2048) as 2 and 8 tensor ranks' attention and
             MLP halves on their shards in rank order, the partials
             summed where the all-reduce stands, forward and backward
             against the unsharded layer (bf16 norms within
             TRAIN_LEAF_NORM_REL_TOL, float32 within
             TRAIN_F32_LEAF_REL_TOL), one flash forward and backward a
             rank, each rank's flash timed at its local heads beside
             SDPA; then Llama-3.2-1B as 4 GPipe stages of 4 layers over
             4 microbatches in this process against the unpipelined
             loss_fn (loss, grad norm and leaf norms within the train
             phase's bf16 bounds), 128 / 64 flash launches, each stage's
             times. One line says why one card cannot show an elastic
             reshard. Since slice 14, inside the NCCL group: MoE at
             Mixtral-8x7B width (2 layers, B 4 x 2048) for 2 steps on
             {"expert": 1, "fsdp": 1} against no mesh (bit-equal, peak
             memory, 8 / 4 flash launches); BERT-base's, ViT-B/16's and
             T5-base's sharded steps on {"data": 1, "fsdp": 1, "tensor":
             1} against their no-mesh steps (bit-equal, the flash
             counted); a rank-16 LoRA adapter on the frozen 1B for 2
             steps on {"tensor": 1} against no mesh (bit-equal). Then, in
             one process: one Mixtral layer's experts as the bodies of
             2, 4 and 8 expert ranks (each its 8 / n experts on the full
             rows, the partials summed in rank order) against the
             unsharded _moe_mlp, and one 8B layer with a rank-16 adapter
             as 2 and 8 tensor ranks' halves against the unsharded
             adapted layer (both: bf16 norms within
             TRAIN_LEAF_NORM_REL_TOL, float32 within
             TRAIN_F32_LEAF_REL_TOL; a rank's expert bytes); and the 1B
             fit (B 4 x 2048, 6 steps) fed by TokenShardLoader over two
             uint16 shards of 64 Mi tokens written from the seed (step
             time against the train phase's, consumer waits, ring
             occupancy, 192 / 96 flash launches).
15. observe - in-process torch.profiler captures on the two main paths
             through utils/profiler.arm_profile: (a) the serve phase's
             server and traffic (a fresh 5-request burst, 32 greedy
             tokens) with an 8-iteration capture claimed by the engine
             loop in the iteration that admits the burst: the trace's
             device-kernel events hold paged decode, the cached flash and
             paged prefill under their __global__ names exactly as often
             as the launch counters moved inside the window; the decode
             tick p50 captured, dark and with a SampleRing observer
             (every completion one sample, its logit_margin the plain
             top-2 gap of the same first-token logits); (b) the train
             phase's 1B fit (B 4 x 2048, 6 steps) with a 2-step capture
             armed at step 1's end: 64 flash forward and 32 + 32 flash
             backward (dq, dk/dv) kernel events, the captured steps' ms
             beside the others; (c) two processes over one
             MLT_TRAINING__COMPILE_CACHE_DIR: the first runs nvcc, the
             second, with no nvcc reachable, loads the same library and
             launches the RMSNorm and paged decode op entry points against
             their plain versions; (d) the 1B param tree (bf16) through
             TorchTreePackager to an .npz and back, bit for bit; (e) the
             env of build_jobset(nodes=1, gpus_per_node=1) on the pod's
             torchrun command (MASTER_ADDR 127.0.0.1): a one-rank NCCL
             group, 2 steps of the 1B fit (its width, 2 layers) through
             auto_trainer.train, the logging worker and one log_results.
16. gateway - the serving graph and the port's standard-library HTTP
             gateway: GATEWAY_SPEC (a router with one LLMModelServer
             route, the serve phase's paged engine at Llama-3-8B, in the
             SERVING_SPEC_ENV form) loaded by asgi.server_from_env and
             served on a free 127.0.0.1 port, driven by urllib clients:
             (a) /readyz 503 with Retry-After from begin_warmup until the
             warmup pass, healthz 200 throughout; (b) the serve traffic
             over HTTP (the four prompts in one request, then the prefix
             hit), every token a near-argmax of a teacher-forced forward
             over the route's own params, paged decode / paged prefill /
             cached flash launched as the engine's counters say; (c) 20
             sequential 16-token requests (4 tokens) over HTTP and 20
             through GraphServer.test, p50 / p99, /__stats__, then 4
             concurrent clients on the one worker; (d) a front gateway
             whose RemoteStep calls the model gateway: the prefix-hit
             answer again, its X-MLT-Trace id in /debug/trace/<id>; (e)
             /__drain__ with a 4 x 64-token request in flight: readyz 503
             before it ends, it ends 200, the next request gets the
             ServerDrainingError envelope (503, Retry-After); (f)
             /metrics: request and probe counts, the OpenMetrics variant.
17. podfleet - the serving pod fleet (serving/podfleet.py) over the 8B
             paged engine (CUT_LAYERS layers): every pod's engine from one
             factory over one param dict, each pod a JobSet on an
             in-memory cluster (a
             duck-typed provider defined here: create / delete /
             list_serving_jobsets and a pod read that answers Running or
             404), a FleetAutoscaler (dry_run off, pods=) reading a
             MetricsAggregator and a TimeSeriesStore fed from the registry
             before each tick. (a) a pod joins below the floor and serves
             the serve prompts and two 600-token prompts whose keys move
             to the next replica; a forced scale-up (the obs.autoscale
             box) walks pending -> warming -> ready -> joined one
             transition a tick, the pre-warm fetches the moved keys'
             pages from the owner, and the first moved request is a
             prefix hit on the new pod (paged prefill over the imported
             pages) with the lone engine's prefix-hit stream; (b) 4
             requests of 64 tokens, two on the new pod, then its pod is
             deleted: the next tick fails them over as
             ReplicaPreemptedError with a KVHandoff and they resume on the
             survivor (no request lost, each stream the lone run's until a
             near-tie); (c) a second scale-up, 20 ticks with two replicas
             live (tick ms p50 / p99), then the load drops: the autoscaler
             drains, sweeps and removes a replica, its JobSet deleted and
             its series gone from /metrics; (d) the p95 TTFT the
             autoscaler reads from the store within one bucket of the
             engines' own, and two latency SLOs (a target below the p50,
             one above every TTFT) of which exactly the first breaches;
             paged decode / cached flash / paged prefill launched as the
             engines' counters (and the pre-warms' warmup passes) say.
18. runs   - the run stack over a temporary SQLite run db and artifact
             path: (a) new_function("train", kind="tpujob") sized
             with_gpus(nodes=1, gpus_per_node=1): its JobSet (one node,
             one GPU, the torchrun env, the exec config round-tripping the
             run dict), then .run(handler=auto_trainer.train, local=True)
             at Llama-3.2-1B (B 4 x 2048, all 16 layers, 4 steps, a
             checkpoint): completed, the db's results equal to the run's,
             the handler's stdout in the run log, the model artifact
             resolved by get_model("store://models/smoke/llama-1b") to the
             checkpoint directory with a ModelArtifact spec, the flash
             forward and backward launched 2 x and 1 x 16 layers x (4
             steps + the warmup), the step ms beside the train phase's;
             (b) the same function with a preset the handler refuses: the
             run ends in error with the reason, its run_failed event in the
             db fires a JobFailed alert once through a console
             notification; (c) a hyper-parameter run over two learning
             rates (2 steps each) selected by min.loss: both iterations in
             the db, best_iteration the lower loss; (d) a burst of the
             serve traffic on a 1B paged LLMModelServer with a
             TimeSeriesStore fed from the registry around it: a TTFT
             target below the burst's p50 fires SLOBurnRate through
             SLOEvaluator.process once, a second call within refire_after
             fires nothing, the breach event is in the db; paged decode /
             cached flash / paged prefill launched as the engine's
             counters say; (e) a seeded 5,313-parameter MLP on the card
             trains 2 epochs of 4 host batches through
             frameworks.torch.train in a local run (completed, its state
             dict a model artifact in the db), then TorchModelServer
             with its default device loads it on the card and predicts a
             batch: params and outputs on cuda, the served outputs within
             1e-6 of the in-memory model's.
19. tuning - the continuous-tuning loop (model_monitoring/
             ContinuousTuningController) on Llama-3.2-1B at full width
             and depth: one paged engine (page 128, 4 slots, max_len
             2048) with a rank-16 adapter bank (tenants t1, t2) under one
             controller whose retrains are local runs of a LoRA fit in a
             temporary run db, with its canary journal live. (a) 32 t1
             requests of 16 new tokens lock the reference, two windows
             of 16 requests of 48 tokens drift it naturally (length PSI
             over 0.2 both times) and exactly one retrain is submitted;
             (b) the retrain is a completed rank-16 LoRA run of 4 steps
             at B4 x 2048 on the served base (checksum), its adapter
             written with save_adapter; (c) the next tick loads it as
             t1@v1 at a 0.5 hash split: 32 requests with distinct keys
             each land on the router's side for split_key_for, no prefix
             page crosses sides, the quality stat is pinned canary-better
             through monitor.drift, promotion after promote_ticks evicts
             the old factors and the promoted streams are within 5% of an
             engine on merge_lora(base, retrained); (d) injected drift on
             t2 gives a second retrain run whose canary, pinned worse,
             rolls back after rollback_ticks with the ordered post-mortem,
             t2's stream unchanged; (e) a third canary live at a restart:
             a new controller on the journal adopts the split with the
             same side for every key and submits nothing; every kernel's
             launches exact.
20. projects - the pod's own program, the port's CLI, each leg a child
             process over the build phase's kernel library, with a
             temporary SQLite run db and MLT_HOME: (a) the tpujob
             JobSet's own container command (python3 -m mlrun_tpu_torch
             run --from-env under torchrun, one node and one GPU,
             MASTER_ADDR 127.0.0.1, the handler in MLT_EXEC_CODE) runs
             the 1B-width trainer at 2 layers (B 4 x 2048, 4 steps after
             the warmup); the run is read back completed from the db
             with its results, log and model artifact, its losses equal
             to an in-process fit of the seed, its flash launches
             2 x 2 x 5 / 2 x 5; (b) `project <dir> --run main` runs a
             two-step workflow: a rank-16 LoRA fit on the 1B base logged
             as a model, then the adapter (step 1's output) on a 1B paged
             engine, its greedy streams held to an engine on the merged
             weights; `get runs` and `logs <uid>` read both runs back.
21. service - the service and its clients: the port's API server on
             127.0.0.1 (a thread, a temporary SQLite run db, the local
             process provider); HTTPRunDB through MLT_DBPATH and
             ClientRemoteLauncher submit a tpujob run of
             auto_trainer.train (the 1B width at 2 layers, B 4 x 2048,
             4 steps, a checkpoint every 2, max_retries 1, no backoff);
             the provider runs the JobSet's own command (torchrun, one
             process) on the card; after step 2's checkpoint the child's
             process group is SIGKILLed; the service's monitor classifies
             the failure (infra) and resubmits <name>-r1 with the resume
             env; the resumed child trains steps 3-4, their losses equal
             to an uninterrupted in-process fit's; retry_count 1, the run
             completed, both attempts' log lines read over HTTP, each
             child's flash launches 2 x 2 x 3 / 2 x 3. Then a serving
             function (GATEWAY_SPEC's router, a user route class over
             LLMModelServer at Llama-3-8B, 32 layers, its code in
             spec.build.functionSourceCode) deployed through HTTPRunDB
             and the service's DeploymentManager, which starts the port's
             gateway as a child: ready with its address stored, the serve
             traffic through fn.invoke within 5% of the argmax with its
             kernels' launches as the engine counts them, a drain with a
             request in flight, SIGINT and exit 0, the service's monitor
             flipping the function to error; a second deploy of the same
             graph and undeploy leave it offline with no process.

Then one line {"kernels": [...]} (the serving kernels' launches summed
over the serve, entry_points, observe, gateway, podfleet, runs, tuning,
projects and service paths, the training flash's over the train, families,
entry_points, parallel, observe, runs, tuning, projects and service
paths) and,
last,
{"ok": true, "device": ...}. ``--phases build,kernels`` runs a subset (for bring-up;
``--phases build,kernels,serve_dense`` checks the dense serving path,
``--phases build,lora`` the adapters, ``--phases build,fleet`` the engine
fleet, ``--phases build,families`` the model families,
``--phases build,entry_points`` the entry points, ``--phases
build,parallel`` training on many GPUs at world size 1, ``--phases
build,observe`` the captures, the sample tap, the build cache, packaging
and the JobSet's env, ``--phases build,gateway`` the HTTP gateway,
``--phases build,podfleet`` the serving pod fleet and its autoscaler,
``--phases build,runs`` the run stack, ``--phases build,tuning`` the
continuous-tuning loop, ``--phases build,projects`` the pod's program,
``--phases build,service`` the service with a killed and resumed run and
a deployed serving function);
the
final lines are printed only when every phase ran. nvcc's build log (registers, shared
memory and spills per kernel) goes to standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
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
# bf16 kernels on the tensor cores: the flash forward for D 32/64/128,
# causal or not; the flash backward's dq and dkdv kernels for D 32/64/128;
# the paged prefill and verify bodies for D 32/64/128, bf16 or int8 pages
TC_INSTANTIATIONS = 3 * 2 + 3 * 2 + 2 * 2 * 3


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


def queued_ms(fn, iters=20, warmup=3):
    """(device ms, host ms) per ``fn()``. :func:`time_ms` reads the card's
    time only while the host enqueues the calls faster than the card runs
    them; a kernel shorter than its wrapper's host work reads the host's
    rate. Here a sleep kernel queued first holds the card while the host
    enqueues all ``iters`` calls, so the events read the card's time
    alone; the host's enqueue time per call is read beside it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    fn()
    one_s = time.perf_counter() - started
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles for twice the host's enqueue time at up to 2 GHz
    torch.cuda._sleep(int(max(2 * iters * one_s, 1e-3) * 2e9))
    start.record()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - started
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def kernel_times(fn, iters=20, warmup=3) -> dict:
    """A kernel row's times: ``ms`` by :func:`time_ms` (the method of every
    earlier reading, and the final line's), ``device_ms`` and ``host_ms``
    by :func:`queued_ms`."""
    device, host = queued_ms(fn, iters, warmup)
    return {"ms": time_ms(fn, iters, warmup), "device_ms": device,
            "host_ms": host}


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def _child(args: list, what: str) -> tuple[str, float]:
    """``python -m <args>`` from the checkout: (stdout, seconds); fails the
    phase on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH", "")) if p)
    started = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - started
    if proc.returncode != 0:
        fail(f"build ({what}): `python -m {' '.join(args)}` exited "
             f"{proc.returncode}\n{proc.stdout[-4000:]}\n"
             f"{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def _lint_and_cli():
    """The port's lint over its own package (zero findings, no parse
    error) and the click CLI's ``version``, each in a child."""
    import importlib.metadata

    import mlrun_tpu_torch

    out, seconds = _child(["mlrun_tpu_torch.analysis", "mlrun_tpu_torch",
                           "--format", "json"], "lint")
    report = json.loads(out)
    lint = {"files_checked": report["files_checked"],
            "findings": len(report["findings"]),
            "suppressed": len(report["suppressed"]),
            "parse_errors": len(report["parse_errors"]),
            "seconds": seconds}
    emit({"phase": "build", "lint": lint})
    if report["findings"] or report["parse_errors"] or not report["ok"]:
        fail(f"build (lint): {report['findings'][:5]} "
             f"{report['parse_errors'][:5]}")
    out, seconds = _child(["mlrun_tpu_torch", "version"], "version")
    version = {"line": out, "seconds": seconds,
               "click": importlib.metadata.version("click")}
    emit({"phase": "build", "cli_version": version})
    if out != f"mlrun-tpu version {mlrun_tpu_torch.__version__}\n":
        fail(f"build (version): {out!r}")


def phase_build(card: str):
    import torch

    from mlrun_tpu_torch.ops import _build

    _lint_and_cli()
    started = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - started
    log = _build.build_log()
    print(log, file=sys.stderr, flush=True)
    emit({"phase": "build", "build_s": seconds, "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "sources": [p.name for p in _build.sources()]})
    # the bf16 tensor-core kernels (flash, paged prefill and verify): each
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
        fail(f"expected {TC_INSTANTIATIONS} tensor-core kernels, found "
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


def _bit_checks(name, kind, run, again=None) -> dict:
    """``run()`` twice gives the same bits (``bit_identical_runs``); with
    ``again``, each of ``again()``'s (got, want) pairs is equal too
    (``batch_invariant``). Fails the phase on either."""
    import torch

    first, second = run(), run()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    checks = {"bit_identical_runs": all(
        bool(torch.equal(a, b)) for a, b in zip(first, second))}
    if again is not None:
        checks["batch_invariant"] = all(bool(torch.equal(a, b))
                                        for a, b in again())
    for key, ok in checks.items():
        if not ok:
            fail(f"{name} {kind}: {key} is false")
    return checks


def _decode_batch_invariance(call, q, table, pos, out):
    """Each slot decoded alone against its row of the 4-slot launch."""
    def pairs():
        for r in range(q.shape[0]):
            alone = call(q[r:r + 1].contiguous(), table[r:r + 1].contiguous(),
                         pos[r:r + 1].contiguous())
            yield alone[0], out[r]
    return pairs


def kernel_decode(gen, kind, dtype, record, positions=(1, 700, 1300, 2047),
                  extra=False):
    """Native paged decode at ``positions``; ``extra`` rows (the serve
    positions, to compare with the int8 row) stay off the final line."""
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
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
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
    bits = _bit_checks(
        "paged_decode", kind,
        lambda: pa._paged_decode_call(q, k_pages, v_pages, table, pos, PAGE),
        _decode_batch_invariance(
            lambda qq, tt, pp: pa._paged_decode_call(qq, k_pages, v_pages,
                                                     tt, pp, PAGE),
            q, table, pos, out))
    times = kernel_times(lambda: pa._paged_decode_call(
        q, k_pages, v_pages, table, pos, PAGE))
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
           **bits, **times, "plain_ms": plain, "bound_ms": bound,
           "bound_by": by, "library_ms": None}
    if extra:
        row["extra"] = True
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
        times = kernel_times(lambda: at.flash_fwd_cached(q, k, v, q_offset,
                                                         k_lo))
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
               "tol": TOL[kind], **times, "plain_ms": plain,
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
    bits = _bit_checks("paged_prefill", kind, lambda: pa._paged_prefill_call(
        q, k_pages, v_pages, ids, base, PAGE))
    times = kernel_times(lambda: pa._paged_prefill_call(
        q, k_pages, v_pages, ids, base, PAGE))
    plain = time_ms(lambda: pa.paged_prefill_reference(
        q, k_pages, v_pages, ids, base, PAGE), iters=5)
    item = q.element_size()
    n_bytes = (q.numel() * item + 2 * base * HKV * D * item
               + o.numel() * 4 + lse.numel() * 4 + ids.numel() * 4)
    n_ops = 4 * D * H * s * base
    bound, by = bound_ms(n_bytes, n_ops, kind)
    row = {"name": "paged_prefill", "dtype": kind, "S": s, "base": base,
           "max_abs_err": max(errs.values()), "errs": errs,
           "tol": TOL["f32"], **bits,
           **times, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
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
    bits = _bit_checks(
        "paged_decode_int8", kind,
        lambda: pa._paged_decode_call(q, k, v, table, pos, PAGE, **scales),
        _decode_batch_invariance(
            lambda qq, tt, pp: pa._paged_decode_call(qq, k, v, tt, pp, PAGE,
                                                     **scales),
            q, table, pos, out))
    times = kernel_times(lambda: pa._paged_decode_call(
        q, k, v, table, pos, PAGE, **scales))
    plain = time_ms(lambda: pa.paged_decode_reference(
        q, k, v, table, pos, PAGE, **scales), iters=5)
    live_tokens = int((pos.long() + 1).sum())
    n_bytes = (_kv_bytes(live_tokens, "int8") + 2 * q.numel()
               * q.element_size() + table.numel() * 4 + pos.numel() * 4)
    bound, by = bound_ms(n_bytes, 4 * D * H * live_tokens, kind)
    row = {"name": "paged_decode_int8", "dtype": kind, "slots": SLOTS,
           "pos": list(SERVE_POS), "max_abs_err": err, "tol": TOL[kind]["o"],
           **bits, **times, "plain_ms": plain, "bound_ms": bound,
           "bound_by": by, "library_ms": None}
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
    bits = _bit_checks("paged_prefill_int8", kind,
                       lambda: pa._paged_prefill_call(q, k, v, ids, base,
                                                      PAGE, **scales))
    times = kernel_times(lambda: pa._paged_prefill_call(
        q, k, v, ids, base, PAGE, **scales))
    plain = time_ms(lambda: pa.paged_prefill_reference(
        q, k, v, ids, base, PAGE, **scales), iters=5)
    n_bytes = (q.numel() * q.element_size() + _kv_bytes(base, "int8")
               + o.numel() * 4 + lse.numel() * 4 + ids.numel() * 4)
    bound, by = bound_ms(n_bytes, 4 * D * H * s * base, kind)
    row = {"name": "paged_prefill_int8", "dtype": kind, "S": s,
           "base": base, "max_abs_err": max(errs.values()), "errs": errs,
           "tol": TOL["f32"], **bits, **times, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": None}
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
        bits = _bit_checks(name, kind, lambda: pa._paged_verify_call(
            q, k, v, table, base, PAGE, **scales))
        if not same:
            fail(f"{name} {kind}: a one-slot verify launch differs from the "
                 "prefill kernel's bits")
        times = kernel_times(lambda: pa._paged_verify_call(
            q, k, v, table, base, PAGE, **scales))
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
               **bits,
               **times, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        record.append(row)
        emit({"phase": "kernels", **row})


# Llama-3.2-1B's attention at the train phase's batch: B 4, S 2048, 32
# query heads over 8 kv heads, head_dim 64
TB, TS, TH, THKV, TD = 4, 2048, 32, 8, 64
# the families phase's training shapes (name, B, S, H, Hkv, D, causal):
# BERT-base (mlrun_tpu/models/bert.py:29-31) at B 8, S 512; ViT-B/16 at
# 224 x 224 (mlrun_tpu/models/vit.py:38-40; 196 patches + cls = 197
# tokens, not a multiple of the 64-row tiles) at B 32; Mixtral-8x7B's
# attention (mlrun_tpu/models/moe.py:83-85) at B 4, S 2048
FAMILY_SHAPES = (("bert-base", 8, 512, 12, 12, 64, False),
                 ("vit-b16", 32, 197, 12, 12, 64, False),
                 ("mixtral-8x7b", 4, 2048, 32, 8, 128, True))


def _train_pairs(causal: bool, b=TB, s=TS, h=TH) -> int:
    """Unmasked (query, key) pairs of self-attention over all heads."""
    per_head = s * (s + 1) // 2 if causal else s * s
    return b * h * per_head


def _train_flash_rows(kind, q, k, v, do, causal, extra=None):
    """The training flash forward and backward on (q, k, v, dO) against
    their plain versions, timed against SDPA: emits and returns the two
    rows (``extra`` joins each)."""
    import torch
    import torch.nn.functional as F

    from mlrun_tpu_torch.ops import attention as at

    b, s, h, d = q.shape
    item = q.element_size()
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    shape = {"B": b, "S": s, "H": h, "Hkv": k.shape[2], "D": d,
             **(extra or {})}
    pairs = _train_pairs(causal, b, s, h)
    # forward: the Pallas _flash_fwd_kernel_v2 on the main path
    o, lse = at.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = at.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    errs = {"o": _err(o, o_ref), "lse": _err(lse, lse_ref)}
    del o_ref, lse_ref
    _check(f"flash_fwd {shape} causal={causal}", kind, errs)
    times = kernel_times(lambda: at.flash_fwd(q, k, v, causal), iters=10)
    plain = time_ms(lambda: at.flash_fwd_plain(q, k, v, causal),
                    iters=3, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters=10)
    n_bytes = (2 * q.numel() + 2 * k.numel()) * item + lse.numel() * 4
    bound, by = bound_ms(n_bytes, 4 * d * pairs, kind)
    fwd_row = {"name": "flash_fwd", "dtype": kind, "causal": causal,
               **shape, "max_abs_err": max(errs.values()), "errs": errs,
               "tol": TOL[kind], **times, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    emit({"phase": "kernels", **fwd_row})

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
            fail(f"flash_bwd {shape} causal={causal} {kind} {name}: error "
                 f"{worst[name]} x its bound (max_abs_err {errs[name]}, "
                 f"tol {tols[name]})")
    del grads, refs
    times = kernel_times(
        lambda: at.flash_bwd(q, k, v, o, lse, do, causal), iters=5)
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
    bound, by = bound_ms(n_bytes, 10 * d * pairs, kind)
    bwd_row = {"name": "flash_bwd", "dtype": kind, "causal": causal,
               **shape, "max_abs_err": max(errs.values()), "errs": errs,
               "tol": tols, "err_over_bound": worst, **times,
               "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms,
               "library_is": "scaled_dot_product_attention forward + "
                             "backward"}
    emit({"phase": "kernels", **bwd_row})
    return fwd_row, bwd_row


def kernel_train_flash(gen, kind, dtype, record):
    import torch

    from mlrun_tpu_torch.ops import attention as at

    dev = "cuda"
    q = torch.randn((TB, TS, TH, TD), generator=gen, device=dev).to(dtype)
    k = torch.randn((TB, TS, THKV, TD), generator=gen, device=dev).to(dtype)
    v = torch.randn((TB, TS, THKV, TD), generator=gen, device=dev).to(dtype)
    do = torch.randn((TB, TS, TH, TD), generator=gen, device=dev).to(dtype)
    fwd_rows, bwd_rows = [], []
    for causal in (True, False):
        fwd, bwd = _train_flash_rows(kind, q, k, v, do, causal)
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
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


def kernel_train_flash_families(seed: int):
    """The training flash forward and backward at the families phase's
    shapes (FAMILY_SHAPES), bf16 and f32, against their plain versions and
    SDPA, from a generator of their own (the rows before keep their
    inputs). Phase lines only: the final line keeps the train phase's
    row."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    for kind, dtype in _dtypes():
        for name, b, s, h, hkv, d, causal in FAMILY_SHAPES:
            q, k, v, do = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dtype)
                           for shape in ((b, s, h, d), (b, s, hkv, d),
                                         (b, s, hkv, d), (b, s, h, d)))
            _train_flash_rows(kind, q, k, v, do, causal,
                              extra={"shape": name})
            del q, k, v, do
            torch.cuda.empty_cache()


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
        times = kernel_times(lambda: at._flash_fwd(q, k, v, causal=causal),
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
               "tol": TOL[kind], **times, "plain_ms": plain,
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
        times = kernel_times(lambda: norms.rms_norm_pallas(x, scale,
                                                           RMS_EPS))
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
               "tol": tol, **times, "plain_ms": plain, "bound_ms": bound,
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
    # native decode at the int8 row's positions; after the rows above, so
    # each of them keeps its inputs from the seed
    for kind, dtype in _dtypes():
        kernel_decode(gen, kind, dtype, record, SERVE_POS, extra=True)
    launches = op_paths(gen)
    kernel_train_flash_families(seed)
    return [r for r in record
            if r["dtype"] == "bf16" and not r.get("extra")], launches


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
    # the server's default: the request ledger is on, as the reference's
    stats_ledger = server.engine.request_ledger
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
        "request_ledger": stats_ledger,
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
# phase 7: lora — multi-tenant LoRA adapters on the paged engine at 8B
# ---------------------------------------------------------------------------

# two synthetic "trained" adapters on the default targets (models/lora.py
# init_lora_nonzero): rank 16, scaling alpha / rank = 2, B drawn at
# b_scale; their deltas move an 8B layer's projections by ~40% of the base
# product, so the three tenants' streams part at once
LORA_RANK, LORA_ALPHA, LORA_B_SCALE = 16, 32.0, 0.05
# the serve traffic's tenants, then the 600-token prompt again under t2
# (another tenant's KV for it is cached) and under t1 (its own)
LORA_TENANTS = ("t1", "t2", "", "t1")
LORA_RERUNS = ("t2", "t1")
# the speculative leg's tiny adapters on the permutation pair (deltas far
# below its argmax gaps, so spec on == spec off exactly)
LORA_SPEC = dict(rank=2, alpha=0.1, b_scale=0.001)


def _serve_tenants(engine, prompts, tenants) -> list:
    futures = [engine.submit(p, max_new_tokens=MAX_NEW, adapter=a)
               for p, a in zip(prompts, tenants)]
    return [f.result(timeout=600)[0] for f in futures]


def _merged_reference(config, params, seed, requests) -> tuple:
    """A paged engine on the kernels, no adapters, over ``params``
    (merged weights): (first-token logits, streams) of ``requests``,
    served one after another in the main path's order."""
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        seed=seed, device="cuda")
    logits: list = []
    _record_first_logits(engine, logits)
    try:
        out = [engine.generate(p, max_new_tokens=MAX_NEW)[0]
               for p in requests]
    finally:
        engine.stop()
    return logits, out


def _lora_spec_leg(seed: int, card: str, prompts) -> dict:
    """Speculation with tenant rows on the permutation pair at 8B width:
    spec on == spec off exactly, with the base draft and with a draft
    adapter; the verify kernel launched on the speculative path."""
    import dataclasses

    import torch

    from mlrun_tpu_torch.models.llama import (
        MODEL_PRESETS,
        init_permutation_params,
        permutation_pair,
    )
    from mlrun_tpu_torch.models.lora import init_lora_nonzero
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.adapters import AdapterRegistry
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    config = dataclasses.replace(MODEL_PRESETS["llama3-8b"](),
                                 n_layers=PERM_LAYERS)
    target_perm, draft_perm = permutation_pair(config.vocab_size,
                                               PERM_OVERLAP, seed=seed)
    target = init_permutation_params(config, target_perm, device="cuda")
    draft = init_permutation_params(config, draft_perm, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    lora, draft_lora = (init_lora_nonzero(config, gen, device="cuda",
                                          **LORA_SPEC) for _ in range(2))
    tenants = ("t1", "", "t1", "")
    rows = []
    for draft_mode in ("base", "tenant"):
        outs = []
        for spec in (None, {"enabled": True, "k": SPEC_K,
                            "draft_config": config, "draft_params": draft}):
            registry = AdapterRegistry(config, sources={"t1": lora},
                                       device="cuda")
            if spec is not None and draft_mode == "tenant":
                registry.attach_draft(config, sources={"t1": draft_lora})
            engine = PagedContinuousBatchingEngine(
                config, target, max_len=MAX_LEN, slots=SLOTS,
                page_size=PAGE, speculative=spec, adapters=registry,
                seed=seed, device="cuda")
            _build.reset_launch_counts()
            try:
                outs.append(_serve_tenants(engine, prompts, tenants))
                torch.cuda.synchronize()
                counts = _build.launch_counts()
                stats = engine.stats
            finally:
                engine.stop()
        if outs[0] != outs[1]:
            fail(f"lora speculation ({draft_mode} draft): spec-on streams "
                 "differ from spec-off streams")
        if not counts["paged_verify"] > 0 or stats["attn_gather_ticks"]:
            fail(f"lora speculation ({draft_mode} draft): the verify "
                 "kernel did not run every round")
        row = {"phase": "lora", "leg": "speculation", "draft": draft_mode,
               "model": f"llama3-8b width, {PERM_LAYERS} zero layers",
               "tenants": list(tenants), "adapter": LORA_SPEC,
               "spec_equals_plain": True,
               "verify_launches": counts["paged_verify"],
               "spec_rounds": stats["spec_rounds"],
               "acceptance_rate": stats["acceptance_rate"], "card": card}
        rows.append(row)
        emit(row)
        if not stats["spec_rounds"] > 0:
            fail(f"lora speculation ({draft_mode} draft): no round ran")
    return {"rows": rows}


def phase_lora(seed: int, card: str, serve: dict | None) -> dict:
    """Two LoRA adapters on LLMModelServer's paged engine at Llama-3-8B:
    t1, t2 and base rows in one decode batch, then cross- and same-tenant
    reruns; each tenant's rows held against an engine on its merged
    weights; the tick and TTFT beside the serve phase's (``serve``); then
    the speculative leg."""
    import gc

    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.models.lora import init_lora_nonzero, merge_lora
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMModelServer

    config = MODEL_PRESETS["llama3-8b"]()
    prompts = _prompts(seed, config.vocab_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)
    adapters = {name: init_lora_nonzero(config, gen, rank=LORA_RANK,
                                        alpha=LORA_ALPHA,
                                        b_scale=LORA_B_SCALE, device="cuda")
                for name in ("t1", "t2")}
    emit({"phase": "lora", "adapters": sorted(adapters), "rank": LORA_RANK,
          "alpha": LORA_ALPHA, "b_scale": LORA_B_SCALE,
          "targets": sorted(adapters["t1"]), "card": card})

    # -- the main path, counted: every count reset right before it ---------
    _build.reset_launch_counts()
    started = time.perf_counter()
    server = LLMModelServer(
        name="llama3-8b", model_preset="llama3-8b", continuous_batching=True,
        paged=True, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, seed=seed, adapters=adapters)
    server.post_init()
    if not server.ready:
        fail(f"LLMModelServer (adapters) failed to load: {server.error}")
    load_s = time.perf_counter() - started
    engine = server.engine
    logits: list = []
    _record_first_logits(engine, logits)
    t0 = time.perf_counter()
    # the burst goes to the engine the server built (one v2 body carries
    # one adapter); the reruns come through the server's v2 body
    out = _serve_tenants(engine, prompts, LORA_TENANTS)
    cached = [engine.stats["prefix_cached_tokens"]]
    for tenant in LORA_RERUNS:
        body = {"inputs": [prompts[0]], "adapter": tenant}
        out += server.do_event(_Event(body)).body["outputs"]
        cached.append(engine.stats["prefix_cached_tokens"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    stats = engine.stats
    params = engine.params
    server.close()
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()

    _check_launches(launches, SERVING_KERNELS, "lora")
    if stats["attn_gather_ticks"] or stats["prefill_gather_admissions"]:
        fail("an adapter row fell back to the dense gather")
    if not (stats["attn_kernel_ticks"] > 0
            and stats["prefill_kernel_chunks"] > 0):
        fail("the adapter path did not run the paged decode and prefill "
             "kernels")
    if stats["adapter_loads"] != 2 or stats["adapter_live"] != 2:
        fail(f"adapter_loads {stats['adapter_loads']}, adapter_live "
             f"{stats['adapter_live']} (want 2 and 2)")
    # the 436-token prompt under t2 shares 256 tokens with the 600-token
    # one under t1: no hit in the burst. The 600-token prompt under t2
    # then reuses only t2's own 256 tokens (from the 436-token prompt),
    # never t1's 512 (its full pages); under t1 it reuses its own 512
    shared = len(os.path.commonprefix([prompts[0], prompts[1]]))
    want_cached = [shared // PAGE * PAGE, len(prompts[0]) // PAGE * PAGE]
    rerun_cached = [b - a for a, b in zip(cached, cached[1:])]
    if cached[0] != 0 or rerun_cached != want_cached:
        fail(f"prefix reuse across tenants: burst {cached[0]} cached "
             f"tokens, reruns {rerun_cached} (want 0, {want_cached})")
    for tokens in out:
        if len(tokens) != MAX_NEW or not all(
                0 <= t < config.vocab_size for t in tokens):
            fail(f"bad output tokens: {tokens[:8]}... ({len(tokens)})")

    # -- each tenant against an engine on its merged weights ---------------
    requests = list(zip(prompts, LORA_TENANTS)) + [
        (prompts[0], tenant) for tenant in LORA_RERUNS]
    ref_logits, ref_out, checks = ([None] * len(requests) for _ in range(3))
    base_shared = None
    for tenant in ("t1", "t2", ""):
        index = [i for i, (_, a) in enumerate(requests) if a == tenant]
        mine = [requests[i][0] for i in index]
        if not tenant:
            mine.append(prompts[0])   # the base stream of the shared prompt
        merged = merge_lora(params, adapters[tenant]) if tenant else params
        lg, ro = _merged_reference(config, merged, seed, mine)
        for i, j in enumerate(index):
            ref_logits[j], ref_out[j] = lg[i], ro[i]
            checks[j] = _stream_check(config, merged, requests[j][0],
                                      out[j], ro[i])
        if not tenant:
            base_shared = ro[-1]
        del merged
        gc.collect()
        torch.cuda.empty_cache()
    rel_err, first_same, share = _compare(logits, out, ref_logits, ref_out)
    # the 600-token prompt under t1 (the burst), t2 (the rerun) and base
    shared = (out[0], out[len(LORA_TENANTS)], base_shared)
    differ = len({tuple(s) for s in shared}) == 3
    result = {
        "phase": "lora", "model": "llama3-8b", "layers": config.n_layers,
        "card": card, "requests": len(out),
        "tenants": [a for _, a in requests],
        "prompt_lens": [len(p) for p, _ in requests],
        "max_new_tokens": MAX_NEW, "load_s": load_s, "serve_s": serve_s,
        "launches": launches, "adapter_loads": stats["adapter_loads"],
        "adapter_live": stats["adapter_live"],
        "attn_kernel_ticks": stats["attn_kernel_ticks"],
        "prefill_kernel_chunks": stats["prefill_kernel_chunks"],
        "burst_prefix_cached_tokens": cached[0],
        "rerun_prefix_cached_tokens": dict(zip(LORA_RERUNS, rerun_cached)),
        "ttft_p50_s": stats.get("ttft_p50_s"),
        "decode_tick_p50_s": stats.get("decode_tick_p50_s"),
        "itl_p50_s": stats.get("itl_p50_s"),
        "serve_ttft_p50_s": (serve or {}).get("ttft_p50_s"),
        "serve_decode_tick_p50_s": (serve or {}).get("decode_tick_p50_s"),
        "vs_merged_first_logits_max_rel_err": rel_err,
        "first_logits_rel_tol": LOGIT_REL_TOL,
        "vs_merged_first_tokens_identical": first_same,
        "vs_merged_greedy_token_share_identical": share,
        "tenant_streams_differ": differ, "streams": checks,
    }
    emit(result)
    if not rel_err <= LOGIT_REL_TOL:
        fail(f"lora: first-token logits vs the merged-weight engines, max "
             f"relative error {rel_err} > {LOGIT_REL_TOL}")
    if not differ:
        fail("lora: the t1, t2 and base streams of the 600-token prompt do "
             "not all differ")
    for i, row in enumerate(checks):
        if row["tie_at_departure_rel"] is not None \
                and not row["tie_at_departure_rel"] <= SPEC_REL_TOL:
            fail(f"lora, stream {i}: departs from its merged-weight engine "
                 f"at token {row['identical_prefix']} where the two tokens "
                 f"are {row['tie_at_departure_rel']} apart")
        if not row["worst_argmax_gap_rel"] <= SPEC_REL_TOL:
            fail(f"lora, stream {i}: emitted a token "
                 f"{row['worst_argmax_gap_rel']} below its merged weights' "
                 "argmax")
    del params, adapters
    gc.collect()
    torch.cuda.empty_cache()
    return {**result, "speculation": _lora_spec_leg(seed, card, prompts)}


# ---------------------------------------------------------------------------
# phase 8: train Llama-3.2-1B through the port's Trainer
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
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {**result, "lora": _train_lora_leg(seed, card, config,
                                              (tokens, targets))}


# the LoRA leg: rank 16 on the default targets over a frozen base, a few
# steps on the same repeated batch (no warmup: at step 0 the adapter's B
# is zero, so only a nonzero learning rate moves it)
LORA_TRAIN_STEPS, LORA_TRAIN_RANK, LORA_TRAIN_LR = 3, 16, 5e-3


def _train_lora_leg(seed: int, card: str, config, batch) -> dict:
    """LoRA training of Llama-3.2-1B through Trainer.fit: the loss is
    finite and falls, the base params' checksum does not move, and the
    flash forward and backward launch once a layer a pass (dq, dk and dv
    still flow to the adapters on wq, wk and wv)."""
    import math

    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.train import tree_leaves

    def repeated():
        while True:
            yield batch

    trainer = Trainer(config, TrainConfig(
        learning_rate=LORA_TRAIN_LR, warmup_steps=0,
        total_steps=LORA_TRAIN_STEPS, loss_chunk=LOSS_CHUNK,
        lora_rank=LORA_TRAIN_RANK), device="cuda")
    trainer.init(seed)

    def checksum():
        with torch.no_grad():
            return [float(leaf.double().sum())
                    for leaf in tree_leaves(trainer.state.params)]

    base_sum = checksum()
    warm = trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    # the LoRA leg's path, counted: every count reset right before it
    _build.reset_launch_counts()
    trainer.fit(repeated(), LORA_TRAIN_STEPS, log_every=1, prefetch=2)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.metrics_history
    losses = [view["loss"] for view in history]
    per_pass = config.n_layers * LORA_TRAIN_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    unchanged = checksum() == base_sum
    trained = sum(leaf.numel() for leaf in tree_leaves(trainer.state.lora))
    b_max = max(float(parts["lora_b"].detach().abs().max())
                for parts in trainer.state.lora.values())
    last = history[-1]
    result = {
        "phase": "train", "leg": "lora", "model": "llama3-1b",
        "layers": config.n_layers, "card": card, "rank": LORA_TRAIN_RANK,
        "trained_params": trained, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": LORA_TRAIN_STEPS, "learning_rate": LORA_TRAIN_LR,
        "losses": losses,
        "grad_norms": [view["grad_norm"] for view in history],
        "step_ms": TRAIN_BATCH * TRAIN_SEQ / last["tokens_per_sec"] * 1e3,
        "tokens_per_sec": last["tokens_per_sec"], "mfu": last["mfu"],
        "compile_seconds": warm["compile_seconds"],
        "peak_memory_gib": peak_gb, "launches": launches,
        "expected_launches": want, "base_checksum_unchanged": unchanged,
        "lora_b_max_abs": b_max,
    }
    emit(result)
    del trainer
    if not all(math.isfinite(x) for x in losses):
        fail(f"LoRA training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"LoRA training: the loss did not fall: {losses}")
    if not unchanged:
        fail("LoRA training moved the frozen base params")
    if not b_max > 0:
        fail("LoRA training left every B factor at zero")
    for name, count in want.items():
        if launches[name] != count:
            fail(f"kernel {name} launched {launches[name]} times on the "
                 f"LoRA train path, expected {count}")
    for name, count in launches.items():
        if name not in TRAINING_KERNELS and count != 0:
            fail(f"serving kernel {name} was launched on the LoRA train "
                 "path")
    return result


# ---------------------------------------------------------------------------
# phase 9: resilience — the degradation ladder, llm.spec_verify, max_wait
# expiry, the v2 timing field and the engine metrics on the 8B paged server
# ---------------------------------------------------------------------------

RES_LADDER = {"queue_depth": 2, "max_new_tokens": 8}
RES_MAX_WAIT = 120.0        # the server's budget: no normal request expires
RES_TINY_WAIT = 1e-3        # the expiry leg's request: expires behind a queue
RES_PARKED = 2              # spec_verify ticks parked by the chaos leg
RES_LEDGER_ORDER = (False, True, True, False)


def _burst(seed: int, vocab: int) -> list:
    """Eight prompts of 200-700 tokens (two draws of the serve traffic)."""
    return _prompts(seed, vocab) + _prompts(seed + 1, vocab)


def _spec_off_engine(config, params, seed, request_ledger):
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    return PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        seed=seed, request_ledger=request_ledger, device="cuda")


def phase_resilience(seed: int, card: str) -> dict:
    """The paged LLMModelServer at Llama-3-8B with a Llama-3.2-1B draft,
    the request ledger, a max_wait budget and the degradation ladder:
    (1) llm.spec_verify armed for two ticks parks them to paged decode (no
    verify launch in them), the stream unchanged; (2) a burst of eight
    requests on four slots turns speculation off while the queue is two
    deep and clamps those requests, a later lone request turns it back on,
    every stream the spec-off engine's greedy stream (until a near-tie);
    (3) a request with a tiny max_wait behind a full queue fails with
    DeadlineExceeded (504), the rest succeed; (4) {"timing": true} returns
    phases that sum to the request's wall; (5) mlt_llm_ttft_seconds counted
    one observation a request; (6) the decode-tick p50 of the same traffic
    with the ledger on and off."""
    import torch

    from mlrun_tpu_torch.chaos import always, chaos, fail_first
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.obs import LLM_TTFT, REGISTRY
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMModelServer
    from mlrun_tpu_torch.serving.resilience import DeadlineExceeded

    config = MODEL_PRESETS["llama3-8b"]()
    burst = _burst(seed, config.vocab_size)
    lone = _prompts(seed + 2, config.vocab_size)
    REGISTRY.reset()
    started = time.perf_counter()
    server = LLMModelServer(
        name="llama3-8b", model_preset="llama3-8b", continuous_batching=True,
        paged=True, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, seed=seed, request_ledger=True,
        max_wait=RES_MAX_WAIT, degradation=RES_LADDER,
        speculative={"draft": "llama3-1b", "k": SPEC_K})
    server.post_init()
    if not server.ready:
        fail(f"LLMModelServer (resilience) failed to load: {server.error}")
    load_s = time.perf_counter() - started
    engine = server.engine
    params = engine.params
    streams = []            # (prompt, tokens) the server emitted

    # -- (1) llm.spec_verify parks two ticks to plain decode ---------------
    snapshots = []
    _build.reset_launch_counts()
    with chaos.inject("llm.spec_verify", always(),
                      action=lambda point, ctx: snapshots.append(
                          dict(_build.launch_counts()))):
        with chaos.inject("llm.spec_verify", fail_first(RES_PARKED),
                          error=RuntimeError("injected verify fault")):
            tokens, _ = engine.generate(lone[0], max_new_tokens=MAX_NEW)
    streams.append((lone[0], tokens))
    stats = engine.stats
    ticks = [{name: b[name] - a[name] for name in b}
             for a, b in zip(snapshots, snapshots[1:])]
    if stats["spec_parked_ticks"] != RES_PARKED or len(ticks) <= RES_PARKED:
        fail(f"spec_verify: {stats['spec_parked_ticks']} parked ticks, "
             f"{len(snapshots)} verify rounds tried")
    for tick in ticks[:RES_PARKED]:
        if tick["paged_decode"] != config.n_layers or tick["paged_verify"]:
            fail(f"a parked tick launched {tick}, not one paged decode a "
                 "layer and no verify")
    if not any(t["paged_verify"] for t in ticks[RES_PARKED:]):
        fail("speculation did not resume after the parked ticks")
    parked = {"parked_ticks": stats["spec_parked_ticks"],
              "parked_tick_launches": ticks[:RES_PARKED],
              "first_spec_tick_launches": ticks[RES_PARKED],
              "spec_resyncs": stats["spec_resyncs"]}

    # -- (2) the ladder: a burst, then a lone request ----------------------
    # every submit's ladder level (the engine's own pressure_level call in
    # _enqueue), the queue depth beside it and the speculation flag after
    enqueued = []
    enqueue, pressure = engine._enqueue, engine.pressure_level
    levels = []

    def capturing():
        depth = engine._queue_depth()
        level = pressure()
        levels.append((depth, level))
        return level

    def recording(future, prompt, max_new, *rest):
        n = len(levels)
        out = enqueue(future, prompt, max_new, *rest)
        depth, level = levels[n]
        enqueued.append({"depth": depth, "level": level,
                         "speculative_enabled": engine.speculative_enabled})
        return out

    engine.pressure_level = capturing
    engine._enqueue = recording
    t0 = time.perf_counter()
    outputs = server.do_event(_Event({"inputs": burst})).body["outputs"]
    burst_s = time.perf_counter() - t0
    streams += list(zip(burst, outputs))
    t0 = time.perf_counter()
    body = server.do_event(_Event({"inputs": [lone[1]],
                                   "timing": True})).body
    lone_wall_s = time.perf_counter() - t0
    streams.append((lone[1], body["outputs"][0]))

    def check_ladder(rows, outs, leg):
        for row, tokens in zip(rows, outs):
            degraded = row["level"] >= 1
            want = RES_LADDER["max_new_tokens"] if degraded else MAX_NEW
            if row["speculative_enabled"] == degraded or \
                    len(tokens) != want:
                fail(f"ladder ({leg}): at level {row['level']} speculation "
                     f"{row['speculative_enabled']}, {len(tokens)} tokens")

    check_ladder(enqueued, outputs + body["outputs"], "burst")
    if not any(r["level"] >= 1 for r in enqueued) \
            or not enqueued[-1]["speculative_enabled"]:
        fail(f"ladder: the burst never degraded, or speculation did not "
             f"come back ({enqueued})")
    ladder_rows = list(enqueued)

    # -- (4) {"timing": true} ----------------------------------------------
    (timing,) = body["timing"]
    closure = abs(timing["wall_s"] - sum(timing["phases"].values()))
    if not (timing["attribution_closed"] and closure < 1e-6
            and timing["wall_s"] <= lone_wall_s):
        fail(f"timing: phases {timing['phases']} vs wall {timing['wall_s']}"
             f" (request wall {lone_wall_s})")

    # -- (3) max_wait expiry behind a full queue ---------------------------
    enqueued.clear()
    futures = [engine.submit(p, max_new_tokens=MAX_NEW) for p in burst[:5]]
    late = engine.submit(lone[2], max_new_tokens=MAX_NEW,
                         max_wait=RES_TINY_WAIT)
    served = [f.result(timeout=600)[0] for f in futures]
    expired = late.exception(timeout=600)
    engine._enqueue, engine.pressure_level = enqueue, pressure
    if not isinstance(expired, DeadlineExceeded) or \
            expired.status_code != 504:
        fail(f"expiry: the late request ended with {expired!r}")
    check_ladder(enqueued[:5], served, "expiry")
    expiry_rows = list(enqueued)
    stats = engine.stats
    ttft_count = LLM_TTFT.value(replica="", adapter="")["count"]
    server_counts = _build.launch_counts()
    server_tick_p50 = stats.get("decode_tick_p50_s")
    server.close()

    # -- (5) the metrics ----------------------------------------------------
    if ttft_count != stats["completed"] or stats["expired"] != 1:
        fail(f"metrics: {ttft_count} TTFT observations for "
             f"{stats['completed']} completed requests, "
             f"{stats['expired']} expired")

    # -- the spec-off streams; the same traffic with the ledger off, on,
    # on, off (6): host time spreads between runs, so the pairs bracket it
    prompts = [p for p, _ in streams]
    ticks_p50 = {False: [], True: []}
    reference = None
    for ledger in RES_LEDGER_ORDER:
        ref = _spec_off_engine(config, params, seed, ledger)
        ref.warmup()
        plain = [ref.generate(p, max_new_tokens=MAX_NEW)[0]
                 for p in prompts[:1]]
        plain += _submit_engine(ref)(prompts[1:-1])
        plain += [ref.generate(prompts[-1], max_new_tokens=MAX_NEW)[0]]
        ticks_p50[ledger].append(ref.stats.get("decode_tick_p50_s"))
        ref.stop()
        if reference is None:
            reference = plain
        elif plain != reference:
            fail("resilience: the spec-off engine's streams changed with "
                 "the request ledger")
    agree = []
    for (prompt, spec), want in zip(streams, reference):
        n = len(spec)
        agree.append(_stream_check(config, params, prompt, spec, want[:n]))
    for i, row in enumerate(agree):
        if row["tie_at_departure_rel"] is not None \
                and not row["tie_at_departure_rel"] <= SPEC_REL_TOL:
            fail(f"resilience, stream {i}: departs from spec-off at token "
                 f"{row['identical_prefix']}, "
                 f"{row['tie_at_departure_rel']} apart")
        if not row["worst_argmax_gap_rel"] <= SPEC_REL_TOL:
            fail(f"resilience, stream {i}: a token "
                 f"{row['worst_argmax_gap_rel']} below the argmax")
    result = {
        "phase": "resilience", "model": "llama3-8b", "draft": "llama3-1b",
        "layers": config.n_layers, "card": card, "load_s": load_s,
        "request_ledger": True, "max_wait_s": RES_MAX_WAIT,
        "degradation": RES_LADDER, **parked,
        "ladder": ladder_rows, "expiry_leg_ladder": expiry_rows,
        "burst_s": burst_s,
        "degraded": stats["degraded"], "spec_rounds": stats["spec_rounds"],
        "acceptance_rate": stats["acceptance_rate"],
        "timing": timing, "timing_request_wall_s": lone_wall_s,
        "expired": stats["expired"], "expiry_error": type(expired).__name__,
        "expiry_status": expired.status_code,
        "ttft_observations": ttft_count, "completed": stats["completed"],
        "launches": server_counts,
        "server_decode_tick_p50_s": server_tick_p50,
        "decode_tick_p50_s_ledger_on": ticks_p50[True],
        "decode_tick_p50_s_ledger_off": ticks_p50[False],
        "ledger_run_order": ["on" if x else "off" for x in RES_LEDGER_ORDER],
        "streams": agree, "rel_tol": SPEC_REL_TOL}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 10: kv_tier — the host KV tier, the KV handoff and fetch/import on
# the 8B paged engine
# ---------------------------------------------------------------------------

TIER_PAGES = 20             # the device pool holds two 9-page requests
# the 8B phases that test host logic (the host KV tier, the engine fleet,
# the pod fleet) run Llama-3-8B at its full width with this many layers;
# the serve, serve_int8, lora, resilience and gateway phases keep all 32
CUT_LAYERS = 4
CUT_PRESET = "llama3-8b-cut"   # the same config as a preset, for a server

TIER_PROMPT = 1024          # 8 pages of prompt + 32 new tokens: 9 pages
TIER_HOST_BYTES = 2 << 30
TIER_TIMING_ITERS = 20


def _cut_8b(**overrides):
    """Llama-3-8B at its full width with CUT_LAYERS layers."""
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS

    return MODEL_PRESETS["llama3-8b"](**{"n_layers": CUT_LAYERS,
                                         **overrides})


@contextlib.contextmanager
def _cut_preset():
    """_cut_8b as the preset CUT_PRESET while the block runs, so an
    LLMModelServer builds the phase's config from the seed as the phase
    does."""
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS

    MODEL_PRESETS[CUT_PRESET] = _cut_8b
    try:
        yield CUT_PRESET
    finally:
        MODEL_PRESETS.pop(CUT_PRESET, None)


def _tier_prompts(seed: int, vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    return [rng.integers(1, vocab, size=TIER_PROMPT).tolist()
            for _ in range(4)]


def _same_kv(a, b) -> bool:
    import numpy as np

    return set(a.kv) == set(b.kv) and all(
        a.kv[n].dtype == b.kv[n].dtype and np.array_equal(a.kv[n], b.kv[n])
        for n in a.kv)


def _page_copy_ms(engine) -> dict:
    """One 8B page's demote (device -> pinned host, every layer, K and V
    and on int8 the scales) and promote (back) by CUDA events."""
    import torch

    pid = 0
    host = engine._host_page(pid)

    def demote():
        engine._host_page(pid)

    def promote():
        for name, arr in engine._pool.items():
            arr[:, pid].copy_(host[name])

    def demote_pageable():
        for arr in engine._pool.values():
            arr[:, pid].cpu()

    nbytes = sum(t.nbytes for t in host.values())
    out = {"page_bytes": nbytes}
    keep = []

    def demote_fresh_pinned_kept():
        # fresh pinned buffers that stay alive (as the tier holds them),
        # so the host allocator cannot hand back a freed one
        keep.append([torch.empty(arr[:, pid].shape, dtype=arr.dtype,
                                 pin_memory=True).copy_(arr[:, pid])
                     for arr in engine._pool.values()])

    for name, fn in (("demote", demote), ("promote", promote),
                     ("demote_fresh_pinned", demote_fresh_pinned_kept),
                     ("demote_pageable", demote_pageable)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIER_TIMING_ITERS):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / TIER_TIMING_ITERS
        out[f"{name}_ms_per_page"] = ms
        out[f"{name}_gb_per_s"] = nbytes / ms / 1e6
    keep.clear()
    return out


def _tier_leg(config, params, seed, card, kv_dtype) -> dict:
    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    prefill_name = "paged_prefill" if kv_dtype == "native" \
        else "paged_prefill_int8"
    prompts = _tier_prompts(seed, config.vocab_size)
    engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        n_pages=TIER_PAGES, kv_dtype=kv_dtype, seed=seed, device="cuda",
        kv_tier={"host_bytes": TIER_HOST_BYTES})
    engine.warmup()
    copies = {"demote": 0.0, "promote": 0.0}
    demote, promote = engine._demote_node, engine._tier_import

    def timed(kind, fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            copies[kind] += time.perf_counter() - t0
            return out
        return wrapper

    engine._demote_node = timed("demote", demote)
    engine._tier_import = timed("promote", promote)
    p1 = prompts[0]
    cold, _ = engine.generate(p1, max_new_tokens=MAX_NEW)
    before = engine.fetch_prefix(p1).result(timeout=600)
    hit, _ = engine.generate(p1, max_new_tokens=MAX_NEW)
    for prompt in prompts[1:]:
        engine.generate(prompt, max_new_tokens=MAX_NEW)
    demoted = engine.stats
    _build.reset_launch_counts()
    kernel_chunks = demoted["prefill_kernel_chunks"]
    promoted, rstats = engine.generate(p1, max_new_tokens=MAX_NEW)
    counts = _build.launch_counts()
    stats = engine.stats
    after = engine.fetch_prefix(p1).result(timeout=600)
    page_times = _page_copy_ms(engine)
    engine.stop()
    coverable = (TIER_PROMPT - 1) // PAGE
    from_cache = rstats["timing"].get("cached_prefix", 0) // PAGE
    checks = {
        "demoted": demoted["kv_demoted_pages"] >= coverable,
        "promoted": stats["kv_promoted_pages"] == coverable,
        "served_from_cache": from_cache == coverable,
        "tokens_equal_device_hit": promoted == hit,
        "pages_bit_identical": _same_kv(before, after)
        and before.cached_prefix == after.cached_prefix == coverable * PAGE,
        "paged_prefill_launched": counts[prefill_name] > 0
        and stats["prefill_kernel_chunks"] > kernel_chunks
        and stats["prefill_gather_admissions"] == 0,
    }
    row = {"phase": "kv_tier", "leg": "tier", "kv_dtype": kv_dtype,
           "model": "llama3-8b", "layers": config.n_layers, "card": card,
           "n_pages": TIER_PAGES,
           "prompt_tokens": TIER_PROMPT, "served_from_cache_rate":
           1.0 if checks["served_from_cache"] else 0.0,
           "kv_demoted_pages": demoted["kv_demoted_pages"],
           "kv_promoted_pages": stats["kv_promoted_pages"],
           "tier": stats["kv_tier"], "rerun_launches": counts,
           "demote_s_per_page_in_engine":
           copies["demote"] / max(1, stats["kv_demotes"]),
           "promote_s_per_page_in_engine":
           copies["promote"] / max(1, stats["kv_promoted_pages"]),
           **page_times, "checks": checks,
           "cold_vs_promoted": _stream_check(config, params, p1, promoted,
                                             cold)}
    return row, cold, hit, prompts


def _handoff_leg(config, params, seed, card, kv_dtype, cold, hit,
                 prompts) -> dict:
    import numpy as np
    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    engines = [PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        kv_dtype=kv_dtype, seed=seed, device="cuda") for _ in range(2)]
    prefill, decode = engines
    for engine in engines:
        engine.warmup()
    p1 = prompts[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handoff = prefill.submit_prefill(p1).result(timeout=600)
    handoff_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    tokens, stats = decode.submit_prefilled(
        handoff, max_new_tokens=MAX_NEW).result(timeout=600)
    decode_counts = _build.launch_counts()
    payload = prefill.fetch_prefix(p1).result(timeout=600)
    imported = decode.import_prefix(payload).result(timeout=600)
    fetched, fstats = decode.generate(p1, max_new_tokens=MAX_NEW)
    dstats = decode.stats
    for engine in engines:
        engine.stop()
    want_dtype = np.int8 if kv_dtype == "int8" else np.uint16
    checks = {
        "handoff_tokens_equal_single_engine": tokens == cold,
        "payload_dtype": str(handoff.kv["k"].dtype) == str(np.dtype(
            want_dtype)),
        "decode_launched_paged_decode":
        decode_counts["paged_decode" if kv_dtype == "native"
                      else "paged_decode_int8"] > 0,
        "no_prefill_on_decode": decode_counts["flash_fwd_cached"] == 0,
        "import_pages": imported == (TIER_PROMPT - 1) // PAGE,
        "import_makes_a_hit": dstats["prefix_hits"] == 1
        and fstats["timing"].get("cached_prefix") == payload.cached_prefix,
        "fetched_tokens_equal_device_hit": fetched == hit,
    }
    return {"phase": "kv_tier", "leg": "handoff", "kv_dtype": kv_dtype,
            "model": "llama3-8b", "layers": config.n_layers, "card": card,
            "handoff_bytes": handoff.nbytes(),
            "handoff_dtypes": {n: str(a.dtype) for n, a in
                               handoff.kv.items()},
            "submit_prefill_s": handoff_s, "prefill_s": handoff.prefill_s,
            "decode_handoff_phase_s": stats["timing"]["phases"].get(
                "handoff"),
            "fetch_bytes": payload.nbytes(), "imported_pages": imported,
            "decode_launches": decode_counts, "checks": checks}


def phase_kv_tier(seed: int, card: str) -> dict:
    """The host KV tier on the 8B paged engine, native and int8 pools: a
    20-page device pool holds two of four 1024-token prompts, so the
    first prompt's pages demote before its rerun, which promotes them
    (served from cache, the paged prefill kernel reading the promoted
    pages, pages bit-identical through the round trip, tokens equal to a
    device-hit run's); then a prefill engine hands the prompt to a decode
    engine (submit_prefill -> submit_prefilled, the single-engine tokens,
    an int8 payload arriving as int8) and fetch_prefix -> import_prefix
    makes the decode engine's next request a hit."""
    import gc

    import torch

    from mlrun_tpu_torch.models.llama import init_params

    config = _cut_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(config, gen, "cuda")
    rows = []
    for kv_dtype in ("native", "int8"):
        tier, cold, hit, prompts = _tier_leg(config, params, seed, card,
                                             kv_dtype)
        emit(tier)
        handoff = _handoff_leg(config, params, seed, card, kv_dtype, cold,
                               hit, prompts)
        emit(handoff)
        rows += [tier, handoff]
        gc.collect()
        torch.cuda.empty_cache()
        for row in (tier, handoff):
            bad = [name for name, ok in row["checks"].items() if not ok]
            if bad:
                fail(f"kv_tier ({kv_dtype}, {row['leg']}): {bad}")
        check = tier["cold_vs_promoted"]
        if check["tie_at_departure_rel"] is not None \
                and not check["tie_at_departure_rel"] <= SPEC_REL_TOL:
            fail(f"kv_tier ({kv_dtype}): the promoted rerun departs from "
                 f"the cold run at token {check['identical_prefix']}")
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phase 11: the engine fleet at Llama-3-8B
# ---------------------------------------------------------------------------

FLEET_SHARED = 512                  # the shared prefix: 4 pages = the key
FLEET_SUFFIXES = (64, 128, 200, 88)
FLEET_ROUTE_BLOCKS = 4
FLEET_TPU_TOKENS = 512              # TpuModelServer's [2, 512] batch


def _fleet_prompts(seed: int, vocab: int) -> list:
    """Four prompts sharing a 512-token prefix (suffixes 64, 128, 200, 88)
    and the serve set's 600- and 700-token prompts."""
    import numpy as np

    rng = np.random.default_rng(seed + 11)
    shared = rng.integers(1, vocab, size=FLEET_SHARED).tolist()
    serve = _prompts(seed, vocab)
    return [shared + rng.integers(1, vocab, size=n).tolist()
            for n in FLEET_SUFFIXES] + [serve[0], serve[3]]


def _kv_bytes_per_token(config, item: int) -> int:
    # K and V, every layer, every KV head, ``item`` bytes an element
    return config.n_layers * config.n_kv_heads * config.head_dim * 2 * item


def _tick_mark(engine) -> int:
    return len(engine._tick_ring)


def _tick_p50_since(engine, mark: int):
    import statistics

    ticks = list(engine._tick_ring)[mark:]
    return statistics.median(ticks) if ticks else None


def _leg_check(leg: str, row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"fleet ({leg}): {bad}")


def _fleet_movers(fleet, config, seed, count=2) -> list:
    """Seeded 600-token prompts whose routing key moves to the replica the
    next ``add_replica`` creates (the ring alone decides)."""
    import numpy as np

    from mlrun_tpu_torch.serving.fleet import ConsistentHashRing

    probe = ConsistentHashRing(vnodes=fleet._ring.vnodes)
    for node in fleet._ring.nodes():
        probe.add(node)
    candidate = f"{fleet._fleet_id}-u{fleet._replica_seq}"
    probe.add(candidate)
    rng = np.random.default_rng(seed + 12)
    movers = []
    while len(movers) < count:
        prompt = rng.integers(1, config.vocab_size, size=600).tolist()
        if probe.lookup(fleet.routing_key(prompt)) == candidate:
            movers.append(prompt)
    return candidate, movers


def phase_fleet(seed: int, card: str) -> dict:
    """The engine fleet over the 8B paged engine (random weights from the
    seed, bf16, native pools, prefix cache on, speculation off), every
    replica built by one factory over ONE param dict: affinity routing,
    disaggregated prefill/decode over the KV handoff, a ring move with a
    cross-replica prefix fetch (and its chaos fallback), re-dispatch after
    a replica crash and a drain, a concurrent burst, then LLMModelServer's
    fleet branches and TpuModelServer over the 8B forward. A single paged
    engine serving the same requests one by one gives the reference
    streams."""
    import gc

    import torch

    from mlrun_tpu_torch.chaos import FaultPoints, chaos, fail_nth
    from mlrun_tpu_torch.models.llama import forward, init_params
    from mlrun_tpu_torch.obs import REGISTRY
    from mlrun_tpu_torch.obs.reqledger import PHASES
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.fleet import EngineFleet
    from mlrun_tpu_torch.serving.llm import LLMModelServer
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine
    from mlrun_tpu_torch.serving.resilience import EngineStoppedError
    from mlrun_tpu_torch.serving.v2_serving import TpuModelServer

    phase_started = time.perf_counter()
    config = _cut_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(config, gen, "cuda")
    prompts = _fleet_prompts(seed, config.vocab_size)

    def build(role="unified"):
        return PagedContinuousBatchingEngine(
            config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
            seed=seed, device="cuda", request_ledger=True)

    def generate_all(target, batch):
        return [target.generate(p, max_new_tokens=MAX_NEW) for p in batch]

    # the reference streams: one paged engine, requests one by one
    single = build()
    ref = [t for t, _ in generate_all(single, prompts)]
    tpu_prompts = [prompts[0][:FLEET_TPU_TOKENS], prompts[5][:FLEET_TPU_TOKENS]]
    engine_first = [single.generate(p, max_new_tokens=1)[0][0]
                    for p in tpu_prompts]
    pool_bytes = sum(t.nbytes for t in single._pool.values())
    per_token = _kv_bytes_per_token(config, single._pool["k"].element_size())
    single.stop()
    rows = []

    # -- leg 1: affinity, 2 unified replicas, one by one -------------------
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fleet = EngineFleet(build, replicas=2, route_blocks=FLEET_ROUTE_BLOCKS)
    fleet_mem = torch.cuda.memory_allocated() - mem0
    _build.reset_launch_counts()
    served = generate_all(fleet, prompts)
    launches = _build.launch_counts()
    _check_launches(launches, SERVING_KERNELS, "fleet affinity")
    owners = [s["replica"] for _, s in served]
    cached = [s["timing"].get("cached_prefix", 0) for _, s in served]
    per = fleet.stats["per_replica"]
    row = {"phase": "fleet", "leg": "affinity", "card": card,
           "model": "llama3-8b", "layers": config.n_layers, "replicas": 2,
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": MAX_NEW, "replica_of_request": owners,
           "cached_prefix": cached, "launches": launches,
           "replica_pool_bytes": pool_bytes,
           "fleet_memory_bytes": fleet_mem,
           "per_replica": {rid: {k: v.get(k) for k in (
               "prefill_kernel_chunks", "prefill_gather_admissions",
               "prefix_hit_rate", "decode_tick_p50_s", "ttft_p50_s")}
               for rid, v in per.items()},
           "checks": {
               "shared_prefix_on_one_replica": len(set(owners[:4])) == 1,
               "hits_cached_512": all(c >= FLEET_SHARED
                                      for c in cached[1:4]),
               "paged_prefill_on_hits":
               per[owners[0]]["prefill_kernel_chunks"] >= 3
               and per[owners[0]]["prefill_gather_admissions"] == 0,
               "streams_equal_single_engine": [t for t, _ in served] == ref,
               # the weights once (before the fleet), then a pool each
               "weights_shared": fleet_mem < 2 * pool_bytes + (256 << 20),
           }}
    _leg_check("affinity", row)
    rows.append(row)

    # -- leg 2: disaggregated, 1 prefill + 1 decode replica ----------------
    split = EngineFleet(build, replicas=1, prefill_replicas=1,
                        route_blocks=FLEET_ROUTE_BLOCKS)
    _build.reset_launch_counts()
    served = generate_all(split, prompts)
    launches = _build.launch_counts()
    stats = split.stats
    split.stop()
    decode = next(v for v in stats["per_replica"].values()
                  if v["role"] == "decode")
    prefill = next(v for v in stats["per_replica"].values()
                   if v["role"] == "prefill")
    row = {"phase": "fleet", "leg": "disaggregated", "card": card,
           "launches": launches,
           "handoff_bytes": [s["handoff_bytes"] for _, s in served],
           "prompt_kv_bytes": [len(p) * per_token for p in prompts],
           "handoff_s": [s["handoff_s"] for _, s in served],
           "prefill_s": [s["prefill_s"] for _, s in served],
           "cached_prefix": [s["cached_prefix"] for _, s in served],
           "decode_prefill_chunks": decode["prefill_chunks"],
           "decode_prefill_kernel_chunks": decode["prefill_kernel_chunks"],
           "decode_handoffs_in": decode["handoffs_in"],
           "prefill_handoffs_out": prefill["handoffs_out"],
           "checks": {
               "streams_equal_single_engine": [t for t, _ in served] == ref,
               "decode_runs_no_prefill": decode["prefill_chunks"] == 0
               and decode["prefill_kernel_chunks"] == 0,
               "handoffs_in_every_request":
               decode["handoffs_in"] == len(prompts),
               "handoff_bytes_are_prompt_kv": all(
                   s["handoff_bytes"] == len(p) * per_token
                   for p, (_, s) in zip(prompts, served)),
           }}
    _check_launches(launches, SERVING_KERNELS, "fleet disaggregated")
    _leg_check("disaggregated", row)
    rows.append(row)

    # -- leg 3: a ring move and the cross-replica prefix fetch -------------
    candidate, movers = _fleet_movers(fleet, config, seed)
    warm = [generate_all(fleet, [m, m]) for m in movers]
    cold = [w[0][0] for w in warm]
    hit = [w[1][0] for w in warm]
    old_owner = warm[0][1][1]["replica"]
    reassigned = [p for _, p, _ in fleet.reassigned_hot_keys(candidate)]
    before = dict(fleet.stats)
    added = fleet.add_replica("unified")
    target = next(r for r in fleet.replicas if r.id == added)
    chunks = target.engine.stats["prefill_kernel_chunks"]
    _build.reset_launch_counts()
    fetched, fstats = fleet.generate(movers[0], max_new_tokens=MAX_NEW)
    launches = _build.launch_counts()
    tstats = target.engine.stats
    after = fleet.stats
    with chaos.inject(FaultPoints.llm_kv_fetch, fail_nth(1),
                      error=RuntimeError("fleet smoke: fetch path down")):
        fallback, fbstats = fleet.generate(movers[1], max_new_tokens=MAX_NEW)
    last = fleet.stats
    # fetch and import apart: the old owner's pages into the replica that
    # holds neither mover
    owner = next(r for r in fleet.replicas if r.id == old_owner)
    third = next(r for r in fleet.replicas
                 if r.id not in (old_owner, added))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = owner.engine.fetch_prefix(movers[0]).result(timeout=600)
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = third.engine.import_prefix(payload).result(timeout=600)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    row = {"phase": "fleet", "leg": "ring_move_fetch", "card": card,
           "candidate": candidate, "added": added, "old_owner": old_owner,
           "launches": launches,
           "fetched_cached_prefix": fstats["timing"].get("cached_prefix", 0),
           "fetch_phase_s": fstats["timing"]["phases"].get("fetch"),
           "fallback_cached_prefix":
           fbstats["timing"].get("cached_prefix", 0),
           "fetch_payload_bytes": payload.nbytes(),
           "fetch_ms": fetch_s * 1e3, "import_ms": import_s * 1e3,
           "imported_pages": imported,
           "fetched_vs_device_hit": _stream_check(config, params, movers[0],
                                                  fetched, hit[0]),
           "checks": {
               "movers_reassigned": all(m in reassigned for m in movers),
               "added_is_candidate": added == candidate,
               "fetched_on_new_replica": fstats["replica"] == added,
               "prefix_fetches_plus_one":
               after["prefix_fetches"] == before["prefix_fetches"] + 1,
               "fetched_hit_512": fstats["timing"].get("cached_prefix", 0)
               >= FLEET_SHARED,
               "paged_prefill_over_imported_pages":
               launches["paged_prefill"] > 0
               and tstats["prefill_kernel_chunks"] > chunks
               and tstats["prefill_gather_admissions"] == 0,
               "fetched_tokens_equal_device_hit": fetched == hit[0],
               "fallback_counted": last["prefix_fetch_fallbacks"]
               == after["prefix_fetch_fallbacks"] + 1,
               "fallback_tokens_equal_cold": fallback == cold[1],
               "import_pages": imported == payload.cached_prefix // PAGE,
           }}
    _leg_check("ring_move_fetch", row)
    rows.append(row)

    # -- leg 4: re-dispatch after a replica crash, then drain --------------
    prompt = prompts[4]
    victim = fleet._ring.lookup(fleet.routing_key(prompt))
    before = dict(fleet.stats)
    # the owner's scheduler crashes on this request's prefill: its future
    # fails 503-class (an armed llm.submit would raise out of submit()
    # itself, which the fleet fails loudly, as the reference's does)
    with chaos.inject(FaultPoints.llm_prefill, fail_nth(1),
                      error=EngineStoppedError("fleet smoke: crashed"),
                      match=lambda ctx: ctx.get("replica") == victim):
        rescued, rstats = fleet.generate(prompt, max_new_tokens=MAX_NEW)
    after = dict(fleet.stats)
    fleet.drain_replica(victim)
    ring_after_drain = fleet._ring.nodes()
    moved, mstats = fleet.generate(prompt, max_new_tokens=MAX_NEW)
    REGISTRY.render()
    fleet.remove_replica(victim)
    rendered = REGISTRY.render()
    row = {"phase": "fleet", "leg": "redispatch_drain", "card": card,
           "victim": victim, "served_by": rstats["replica"],
           "dispatch_attempts": rstats["dispatch_attempts"],
           "redispatch_backoff_s":
           rstats["timing"]["phases"].get("redispatch_backoff"),
           "after_drain_served_by": mstats["replica"],
           "checks": {
               "served_by_next_ring_node": rstats["replica"] != victim,
               "redispatched": after["redispatches"]
               >= before["redispatches"] + 1,
               "no_client_error": len(rescued) == MAX_NEW,
               "rescued_tokens_equal_single_engine": rescued == ref[4],
               "drained_off_ring": victim not in ring_after_drain,
               "drained_keys_elsewhere": mstats["replica"] != victim,
               "series_removed": victim not in rendered,
           }}
    _leg_check("redispatch_drain", row)
    rows.append(row)
    fleet.stop()
    fleet = split = None
    gc.collect()
    torch.cuda.empty_cache()

    # -- leg 5: a concurrent burst on 2 replicas ---------------------------
    burst_fleet = EngineFleet(build, replicas=2,
                              route_blocks=FLEET_ROUTE_BLOCKS)
    futures = [burst_fleet.submit(p, max_new_tokens=MAX_NEW)
               for p in prompts]
    burst = [f.result(timeout=600) for f in futures]
    burst_per = {rid: {"decode_tick_p50_s": v.get("decode_tick_p50_s"),
                       "completed": v["completed"]}
                 for rid, v in burst_fleet.stats["per_replica"].items()}
    lone = [t for t, _ in generate_all(burst_fleet, prompts)]
    burst_fleet.stop()
    lone_engine = build()
    mark = _tick_mark(lone_engine)
    futures = [lone_engine.submit(p, max_new_tokens=MAX_NEW)
               for p in prompts]
    for f in futures:
        f.result(timeout=600)
    lone_tick = _tick_p50_since(lone_engine, mark)
    lone_engine.stop()
    streams = [_stream_check(config, params, p, b[0], lt)
               for p, b, lt in zip(prompts, burst, lone)]
    row = {"phase": "fleet", "leg": "burst", "card": card,
           "burst_replica_of_request": [s["replica"] for _, s in burst],
           "burst_per_replica": burst_per,
           "lone_engine_burst_tick_p50_s": lone_tick,
           "streams": streams,
           "checks": {
               "burst_equals_lone_until_near_tie": all(
                   s["tie_at_departure_rel"] is None
                   or s["tie_at_departure_rel"] <= SPEC_REL_TOL
                   for s in streams),
               "every_request_served": all(len(b[0]) == MAX_NEW
                                           for b in burst),
           }}
    _leg_check("burst", row)
    rows.append(row)
    burst_fleet = lone_engine = None
    gc.collect()
    torch.cuda.empty_cache()

    # -- leg 6: through the servers -----------------------------------------
    server_rows = {}
    for shape, body in (({"replicas": 2}, {"inputs": prompts[:2],
                                           "timing": True}),
                        ({"replicas": 1, "prefill_replicas": 1},
                         {"inputs": [prompts[4]], "timing": True})):
        with _cut_preset() as preset:
            server = LLMModelServer(
                name="llama3-8b", model_preset=preset,
                continuous_batching=True, paged=True, slots=SLOTS,
                max_len=MAX_LEN, page_size=PAGE, max_new_tokens=MAX_NEW,
                seed=seed, warmup=False, **shape)
            server.post_init()
        if not server.ready:
            fail(f"LLMModelServer {shape} failed to load: {server.error}")
        _build.reset_launch_counts()
        reply = server.do_event(_Event(dict(body))).body
        launches = _build.launch_counts()
        kind = type(server.engine).__name__
        server.close()
        server = None
        gc.collect()
        torch.cuda.empty_cache()
        want = ref[:2] if "prefill_replicas" not in shape else [ref[4]]
        timings = reply.get("timing") or []
        server_rows["+".join(f"{k}={v}" for k, v in shape.items())] = {
            "engine": kind, "launches": launches,
            "phases": [sorted(t["phases"]) for t in timings],
            "checks": {
                "fleet_engine": kind == "EngineFleet",
                "outputs_equal_single_engine": reply["outputs"] == want,
                "timing_closed": len(timings) == len(want) and all(
                    t["attribution_closed"] for t in timings),
                "reference_phase_names": all(
                    set(t["phases"]) <= set(PHASES)
                    and "network" in t["phases"] for t in timings),
                "handoff_phase": "prefill_replicas" not in shape or all(
                    "handoff" in t["phases"] for t in timings),
            }}
    tpu = TpuModelServer(
        name="llama3-8b-forward",
        forward_fn=lambda p, x: forward(config, p, x.long())[:, -1],
        params=params, warmup_shapes=[(2, FLEET_TPU_TOKENS)], device="cuda")
    tpu.post_init()
    if not tpu.ready:
        fail(f"TpuModelServer failed to load: {tpu.error}")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    reply = tpu.do_event(_Event({"inputs": tpu_prompts})).body
    tpu_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    logits = torch.tensor(reply["outputs"])
    firsts = []
    for row_logits, want in zip(logits, engine_first):
        got = int(row_logits.argmax())
        gap = float(row_logits[got] - row_logits[want]) \
            / float(row_logits.abs().max())
        firsts.append({"argmax": got, "engine_first": want, "gap_rel": gap})
    server_rows["tpu_model_server"] = {
        "launches": launches, "predict_s": tpu_s,
        "flash_fwd_per_call": launches["flash_fwd"],
        "first_tokens": firsts,
        "checks": {
            "one_flash_fwd_a_layer": launches["flash_fwd"]
            == config.n_layers and sum(launches.values())
            == config.n_layers,
            "finite_logits": bool(torch.isfinite(logits).all()),
            "argmax_equals_engine_first_token_or_near_tie": all(
                f["gap_rel"] <= LOGIT_REL_TOL for f in firsts),
        }}
    row = {"phase": "fleet", "leg": "servers", "card": card,
           "servers": server_rows,
           "checks": {f"{name}:{check}": ok
                      for name, srow in server_rows.items()
                      for check, ok in srow["checks"].items()}}
    _leg_check("servers", row)
    rows.append(row)
    emit({"phase": "fleet", "card": card,
          "phase_s": time.perf_counter() - phase_started})
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phase 12: the other model families — MoE training through the trainer's
# entry point at Mixtral-8x7B width, then BERT-base, ViT-B/16 and T5-base
# train steps
# ---------------------------------------------------------------------------

FAM_MOE_LAYERS = 2          # Mixtral-8x7B has 32; two fit one card with AdamW
FAM_MOE_BATCH, FAM_MOE_SEQ, FAM_MOE_STEPS = 4, 2048, 4
FAM_PEAK_GB = 75.0          # above it the MoE batch is halved (never the width)
FAM_STEPS = 3
FAM_BERT_BATCH, FAM_BERT_SEQ = 8, 512
FAM_VIT_BATCH = 32
FAM_T5_BATCH, FAM_T5_ENC, FAM_T5_DEC = 8, 512, 128
FAM_T5_CHECK_BATCH = 2
FAM_LR = 1e-4
# T5's step-1 loss in float32 (TF32 off) on the card against the port's
# CPU loss on the same params and batch: the two differ in summation order
# only, but T5's attention has no softmax scale, so at random init its
# logits (std ~8 at D 64) make near-one-hot softmaxes that amplify that
# order across 24 layers: at T5-base width on a B 2 batch the port's and
# the JAX package's CPU losses differ by 6.9e-5 relative, the card's and
# the CPU's by 1.3e-4. The bound sits ~4x above the card's reading
FAM_T5_F32_REL_TOL = 5e-4


def _step1(compute_grads, params, *batch) -> dict:
    """Step 1's gradient through a step's own gradient function: the loss,
    the global norm and the attention weights' gradients by name."""
    import torch

    from mlrun_tpu_torch.training.train import global_norm

    grads, metrics = compute_grads(params, *batch)
    named = dict(zip(_leaf_names(params), grads))
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(global_norm(grads)),
           "leaves": {name: named[name] for name in ATTENTION_LEAVES}}
    del grads, named
    torch.cuda.synchronize()
    return out


def _step1_gaps(a: dict, b: dict) -> dict:
    """Relative gaps of two step-1 readings: the loss, the global norm and
    each attention weight's gradient norm."""
    import torch

    norm = torch.linalg.vector_norm
    leaves = {}
    for name in ATTENTION_LEAVES:
        got, want = a["leaves"][name].float(), b["leaves"][name].float()
        leaves[name] = float(abs(norm(got) - norm(want)) / norm(want))
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_norm": abs(a["grad_norm"] - b["grad_norm"])
            / b["grad_norm"], "leaves": leaves}


def _step1_checks(leg: str, kernel: dict, ref: dict, kernel32=None,
                  ref32=None) -> dict:
    """Step 1 on the kernels against step 1 on the reference attention,
    same params and batch, by the train phase's bf16 bounds (loss,
    global norm, the attention weights' gradient norms).

    With the float32 readings (``kernel32``, ``ref32``: the same params in
    float32, TF32 off) two more checks: the float32 paths, which differ
    only in summation order, agree by the train phase's float32 bound
    (each attention weight's gradient within 2e-3, its loss by the bf16
    loss bound); and each bf16 bound becomes the larger of the train
    phase's and twice the gap between the bf16 and float32 reference
    readings — the kernel's bf16 step may sit no farther from the
    reference's than the reference's own bf16 rounding (P rounded to bf16
    before P·V) moves the reference from float32. An encoder's
    classification loss near log(classes) moves more with that rounding
    than a language model's loss near log(vocab)."""
    import torch

    gaps = _step1_gaps(kernel, ref)
    bounds = {"loss": TRAIN_LOSS_REL_TOL,
              "grad_norm": TRAIN_GRAD_NORM_REL_TOL,
              "leaves": {name: TRAIN_LEAF_NORM_REL_TOL
                         for name in ATTENTION_LEAVES}}
    out = {
        "kernel_step1": {k: kernel[k] for k in ("loss", "grad_norm")},
        "reference_step1": {k: ref[k] for k in ("loss", "grad_norm")},
        "step1_loss_rel_err": gaps["loss"],
        "step1_grad_norm_rel_err": gaps["grad_norm"],
        "step1_leaf_grad_norm_rel_err": gaps["leaves"],
    }
    if kernel32 is not None:
        own = _step1_gaps(ref, ref32)       # the bf16 reference's own gap
        bounds = {"loss": max(bounds["loss"], 2 * own["loss"]),
                  "grad_norm": max(bounds["grad_norm"],
                                   2 * own["grad_norm"]),
                  "leaves": {name: max(TRAIN_LEAF_NORM_REL_TOL,
                                       2 * own["leaves"][name])
                             for name in ATTENTION_LEAVES}}
        f32 = _step1_gaps(kernel32, ref32)
        f32_leaf = {}
        for name in ATTENTION_LEAVES:
            got = kernel32["leaves"][name]
            want = ref32["leaves"][name]
            f32_leaf[name] = float(torch.linalg.vector_norm(got - want)
                                   / torch.linalg.vector_norm(want))
        out.update({
            "reference_bf16_vs_f32_rel": own,
            "step1_f32_loss_rel_err": f32["loss"],
            "step1_f32_grad_norm_rel_err": f32["grad_norm"],
            "step1_f32_leaf_grad_rel_err": f32_leaf,
            "step1_f32_leaf_grad_rel_tol": TRAIN_F32_LEAF_REL_TOL,
        })
        if not f32["loss"] <= TRAIN_LOSS_REL_TOL:
            fail(f"families {leg}: float32 step 1 loss, kernel vs reference "
                 f"attention, relative error {f32['loss']} > "
                 f"{TRAIN_LOSS_REL_TOL}")
        for name, rel in f32_leaf.items():
            if not rel <= TRAIN_F32_LEAF_REL_TOL:
                fail(f"families {leg}: float32 step 1 gradient of {name}, "
                     f"kernel vs reference attention, relative error {rel} "
                     f"> {TRAIN_F32_LEAF_REL_TOL}")
    out["step1_bf16_bounds"] = bounds
    if not gaps["loss"] <= bounds["loss"]:
        fail(f"families {leg}: step 1 loss, kernel vs reference attention, "
             f"relative error {gaps['loss']} > {bounds['loss']}")
    if not gaps["grad_norm"] <= bounds["grad_norm"]:
        fail(f"families {leg}: step 1 grad norm, kernel vs reference "
             f"attention, relative error {gaps['grad_norm']} > "
             f"{bounds['grad_norm']}")
    for name, rel in gaps["leaves"].items():
        if not rel <= bounds["leaves"][name]:
            fail(f"families {leg}: step 1 gradient norm of {name}, kernel "
                 f"vs reference attention, relative error {rel} > "
                 f"{bounds['leaves'][name]}")
    return out


def _exact_launches(path: str, launches: dict, want: dict):
    """Exactly ``want``'s launches on the path, no other kernel."""
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"{path}: kernel {name} launched {count} times, "
                 f"expected {want.get(name, 0)}")


def _float32_tree(tree):
    """A float32 copy of a param tree (bf16 values are exact in float32)."""
    if isinstance(tree, dict):
        return {key: _float32_tree(value) for key, value in tree.items()}
    return tree.detach().float()


def _release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _timed_steps(step, params, opt_state, batch, steps: int):
    """``steps`` train steps on one batch, each between CUDA events:
    (per-step ms, per-step metrics read after the last)."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    history = []
    events[0].record()
    for i in range(steps):
        params, opt_state, metrics = step(params, opt_state, *batch)
        events[i + 1].record()
        history.append(metrics)
    torch.cuda.synchronize()
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    return ms, [{k: float(v) for k, v in m.items()} for m in history]


def _dropped_share(config, params, tokens) -> list:
    """Per layer, the share of (token, choice) pairs routed past their
    expert's capacity: one forward without gradients, the port's router
    wrapped to read each layer's dispatch mask."""
    import torch

    from mlrun_tpu_torch.models import moe

    shares = []
    route = moe.route

    def reading_route(cfg, x, router):
        dispatch, combine, aux = route(cfg, x, router)
        kept = float(dispatch.sum()) / (x.shape[0] * x.shape[1] * cfg.top_k)
        shares.append(1.0 - kept)
        return dispatch, combine, aux

    moe.route = reading_route
    try:
        with torch.no_grad():
            moe.hidden_states(config, params, tokens)
    finally:
        moe.route = route
    return shares


def _families_moe(seed: int, card: str) -> dict:
    """MoE at Mixtral-8x7B width (depth cut to FAM_MOE_LAYERS) through
    ``auto_trainer.train(moe_experts=8)``, the tpujob handler's contract;
    step 1 held against the reference attention; forward + backward and
    the AdamW update timed apart with CUDA events."""
    import torch

    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.models.moe import mixtral_8x7b_like
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.data import synthetic_token_stream, to_device
    from mlrun_tpu_torch.training.train import resolve_model_config

    config = mixtral_8x7b_like(n_layers=FAM_MOE_LAYERS)
    full_layers = mixtral_8x7b_like().n_layers
    batch, seq, steps = FAM_MOE_BATCH, FAM_MOE_SEQ, FAM_MOE_STEPS
    emit({"phase": "families", "leg": "moe", "cut": {
        "n_layers": [full_layers, FAM_MOE_LAYERS]}, "card": card})

    def train_config(**kw):
        return TrainConfig(total_steps=steps, moe_experts=8, moe_top_k=2,
                           **kw)

    while True:
        tokens, targets = to_device(next(synthetic_token_stream(
            batch, seq, config.vocab_size, seed=seed)), "cuda")
        trainer = Trainer(config, train_config(), device="cuda")
        trainer.init(seed)
        params = trainer.state.params
        dropped = _dropped_share(trainer.model_config, params, tokens)
        trainer.step_fn.compute_grads(params, tokens, targets)  # warm
        _release()
        torch.cuda.reset_peak_memory_stats()
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        grads, metrics = trainer.step_fn.compute_grads(params, tokens,
                                                       targets)
        mid.record()
        named = dict(zip(_leaf_names(params), grads))
        kernel = {"loss": float(metrics["loss"]),
                  "aux_loss": float(metrics["aux_loss"]),
                  "leaves": {n: named[n].clone() for n in ATTENTION_LEAVES}}
        del named
        g_norm = trainer.optimizer.update(grads, trainer.state.opt_state,
                                          trainer.state.trained)
        end.record()
        torch.cuda.synchronize()
        kernel["grad_norm"] = float(g_norm)
        split = {"fwd_bwd_ms": start.elapsed_time(mid),
                 "adamw_update_ms": mid.elapsed_time(end)}
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        del grads, trainer, params
        _release()
        if step_peak <= FAM_PEAK_GB or batch == 1:
            break
        emit({"phase": "families", "leg": "moe", "batch_cut": [batch,
                                                               batch // 2],
              "peak_memory_gib": step_peak})
        batch //= 2

    before = _build.launch_counts()
    ref_trainer = Trainer(config, train_config(attention_impl="reference"),
                          device="cuda")
    ref_trainer.init(seed)
    ref = _step1(ref_trainer.step_fn.compute_grads, ref_trainer.state.params,
                 tokens, targets)
    del ref_trainer
    _release()
    if _build.launch_counts() != before:
        fail("families moe: the reference-attention step launched a kernel")
    checks = _step1_checks("moe", kernel, ref)
    del kernel, ref

    # -- the main path, counted: every count reset right before it ---------
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    final = auto_trainer.train(model=config, moe_experts=8, moe_top_k=2,
                               batch_size=batch, seq_len=seq, steps=steps,
                               log_every=1, seed=seed)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # the warmup pass and every step: under remat "nothing" the flash
    # forward runs twice a layer (forward, then its recompute), the
    # backward once
    passes = steps + 1
    want = {"flash_fwd": 2 * FAM_MOE_LAYERS * passes,
            "flash_bwd": FAM_MOE_LAYERS * passes}
    moe_config = resolve_model_config(config, train_config())
    row = {
        "phase": "families", "leg": "moe", "model": "mixtral-8x7b",
        "card": card, "layers": FAM_MOE_LAYERS, "layers_full": full_layers,
        "embed_dim": config.embed_dim, "experts": 8, "top_k": 2,
        "params": moe_config.param_count(), "batch": batch, "seq": seq,
        "steps": steps, "capacity": moe_config.capacity(seq),
        "step_ms": batch * seq / final["tokens_per_sec"] * 1e3,
        "tokens_per_sec": final["tokens_per_sec"], "mfu": final["mfu"],
        "flops_per_token_active": moe_config.flops_per_token(seq),
        "loss": final["loss"], "aux_loss": final["aux_loss"],
        "ce_loss": final["ce_loss"], "grad_norm": final["grad_norm"],
        "dropped_share_per_layer": dropped,
        "compile_seconds": final.get("compile_seconds"),
        "train_time_s": final["train_time_s"],
        "peak_memory_gib": peak_gb, "step_peak_memory_gib": step_peak,
        **split, "launches": launches, "expected_launches": want, **checks,
    }
    emit(row)
    _exact_launches("families moe", launches, want)
    if not all(math.isfinite(final[k]) for k in ("loss", "aux_loss",
                                                  "grad_norm")):
        fail(f"families moe: non-finite metrics {final}")
    return row


def _families_encoder(seed: int, card: str, leg: str) -> dict:
    """BERT-base (``make_classifier_train_step``, half the rows padded,
    then ``mlm_logits`` once) or ViT-B/16 (``make_train_step`` on 224 x
    224 x 3 images): step 1 held against the reference attention, then
    FAM_STEPS counted steps on one batch."""
    import dataclasses

    import torch

    from mlrun_tpu_torch.models import bert, vit
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training.mfu import mfu
    from mlrun_tpu_torch.training.train import AdamW

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if leg == "bert":
        config, module = bert.bert_base(), bert
        b, s = FAM_BERT_BATCH, FAM_BERT_SEQ
        tokens = torch.randint(0, config.vocab_size, (b, s), generator=gen,
                               device="cuda")
        labels = torch.randint(0, config.n_classes, (b,), generator=gen,
                               device="cuda")
        mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
        for row in range(b // 2):        # a padded tail on half the rows
            mask[row, s - 64 * (row + 1):] = 0
        batch = (tokens, labels, mask)
        make = module.make_classifier_train_step
        # remat off: the forward once a layer a step; mlm_logits once more
        want = {"flash_fwd": config.n_layers * (FAM_STEPS + 1),
                "flash_bwd": config.n_layers * FAM_STEPS}
        items = b * s
    else:
        config, module = vit.vit_b16(), vit
        b, s = FAM_VIT_BATCH, config.n_patches + 1
        images = torch.randn((b, config.image_size, config.image_size,
                              config.channels), generator=gen,
                             device="cuda")
        labels = torch.randint(0, config.n_classes, (b,), generator=gen,
                               device="cuda")
        batch = (images, labels)
        make = module.make_train_step
        # remat on: the forward twice a layer a step (and its recompute)
        want = {"flash_fwd": 2 * config.n_layers * FAM_STEPS,
                "flash_bwd": config.n_layers * FAM_STEPS}
        items = b
    params = module.init_params(config, gen, "cuda")
    optimizer = AdamW(lambda count: FAM_LR, b1=0.9, b2=0.999,
                      weight_decay=0.01)
    step = make(config, optimizer)

    kernel = _step1(step.compute_grads, params, *batch)   # builds, warms
    before = _build.launch_counts()
    ref_config = dataclasses.replace(config, attention_impl="reference")
    ref = _step1(make(ref_config, optimizer).compute_grads, params, *batch)
    if _build.launch_counts() != before:
        fail(f"families {leg}: the reference-attention step launched a "
             "kernel")
    # the same params in float32 (TF32 off): the float32 kernels against
    # the float32 reference attention
    params32 = _float32_tree(params)
    config32 = dataclasses.replace(config, dtype=torch.float32)
    kernel32 = _step1(make(config32, optimizer).compute_grads, params32,
                      *batch)
    ref32 = _step1(make(dataclasses.replace(
        config32, attention_impl="reference"), optimizer).compute_grads,
        params32, *batch)
    checks = _step1_checks(leg, kernel, ref, kernel32, ref32)
    del kernel, ref, kernel32, ref32, params32
    _release()

    opt_state = optimizer.init(params)
    torch.cuda.reset_peak_memory_stats()
    # -- the leg's path, counted: every count reset right before it --------
    _build.reset_launch_counts()
    ms, history = _timed_steps(step, params, opt_state, batch, FAM_STEPS)
    extra = {}
    if leg == "bert":
        with torch.no_grad():
            logits = bert.mlm_logits(config, params, tokens, mask)
        torch.cuda.synchronize()
        extra["mlm_logits"] = {"shape": list(logits.shape),
                               "finite": bool(torch.isfinite(logits).all())}
        del logits
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steady_ms = sum(ms[1:]) / len(ms[1:])
    row = {"phase": "families", "leg": leg, "card": card,
           "model": "bert-base" if leg == "bert" else "vit-b16",
           "layers": config.n_layers, "embed_dim": config.embed_dim,
           "params": config.param_count(), "batch": b, "seq": s,
           "steps": FAM_STEPS, "step_ms": ms, "steady_step_ms": steady_ms,
           "losses": [m["loss"] for m in history],
           "peak_memory_gib": peak_gb, "launches": launches,
           "expected_launches": want, **checks, **extra}
    if leg == "bert":
        row["tokens_per_sec"] = items / steady_ms * 1e3
    else:
        row["images_per_sec"] = items / steady_ms * 1e3
        row["grad_norms"] = [m["grad_norm"] for m in history]
        row["mfu"] = mfu(row["images_per_sec"], config.flops_per_image(),
                         device="cuda")
    emit(row)
    _exact_launches(f"families {leg}", launches, want)
    if not all(math.isfinite(m["loss"]) for m in history):
        fail(f"families {leg}: non-finite loss {row['losses']}")
    if leg == "bert" and not extra["mlm_logits"]["finite"]:
        fail("families bert: non-finite mlm_logits")
    del params, opt_state, step
    _release()
    return row


def _families_t5(seed: int, card: str) -> dict:
    """T5-base ``make_train_step`` (encoder 512, decoder 128): no kernel
    on its path (its biased attention is plain, as in the reference), so
    its step-1 loss is held in float32 on the card against the port's CPU
    loss on the same params and batch instead."""
    import torch

    from mlrun_tpu_torch.models import t5
    from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training.mfu import mfu
    from mlrun_tpu_torch.training.train import AdamW

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    config32 = t5.t5_base(dtype=torch.float32)

    def batch_of(b):
        return tuple(torch.randint(0, config32.vocab_size, (b, n),
                                   generator=gen, device="cuda")
                     for n in (FAM_T5_ENC, FAM_T5_DEC, FAM_T5_DEC))

    # float32 on the card (TF32 off) against the CPU
    params32 = t5.init_params(config32, gen, "cuda")
    check = batch_of(FAM_T5_CHECK_BATCH)
    with torch.no_grad():
        card_loss = float(t5.seq2seq_loss(config32, params32, *check)[0])
        cpu_params = params_from_numpy(params_to_numpy(params32), "cpu")
        cpu_loss = float(t5.seq2seq_loss(config32, cpu_params,
                                         *(x.cpu() for x in check))[0])
    del params32, cpu_params
    _release()
    f32_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)

    config = t5.t5_base()
    params = t5.init_params(config, gen, "cuda")
    optimizer = AdamW(lambda count: FAM_LR, b1=0.9, b2=0.999,
                      weight_decay=0.01)
    step = t5.make_train_step(config, optimizer)
    batch = batch_of(FAM_T5_BATCH)
    opt_state = optimizer.init(params)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ms, history = _timed_steps(step, params, opt_state, batch, FAM_STEPS)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steady_ms = sum(ms[1:]) / len(ms[1:])
    dec_tokens = FAM_T5_BATCH * FAM_T5_DEC
    row = {"phase": "families", "leg": "t5", "model": "t5-base",
           "card": card, "enc_layers": config.n_enc_layers,
           "dec_layers": config.n_dec_layers, "params": config.param_count(),
           "batch": FAM_T5_BATCH, "enc_len": FAM_T5_ENC,
           "dec_len": FAM_T5_DEC, "steps": FAM_STEPS, "step_ms": ms,
           "steady_step_ms": steady_ms,
           "tokens_per_sec": FAM_T5_BATCH * (FAM_T5_ENC + FAM_T5_DEC)
           / steady_ms * 1e3,
           "decoder_tokens_per_sec": dec_tokens / steady_ms * 1e3,
           "mfu": mfu(dec_tokens / steady_ms * 1e3,
                      config.flops_per_token(FAM_T5_ENC, FAM_T5_DEC),
                      device="cuda"),
           "losses": [m["loss"] for m in history],
           "grad_norms": [m["grad_norm"] for m in history],
           "peak_memory_gib": peak_gb, "launches": launches,
           "f32_step1_loss_card": card_loss, "f32_step1_loss_cpu": cpu_loss,
           "f32_step1_loss_rel_err": f32_rel,
           "f32_step1_loss_rel_tol": FAM_T5_F32_REL_TOL}
    emit(row)
    _exact_launches("families t5", launches, {})
    if not all(math.isfinite(m["loss"]) for m in history):
        fail(f"families t5: non-finite loss {row['losses']}")
    if not f32_rel <= FAM_T5_F32_REL_TOL:
        fail(f"families t5: float32 loss on the card {card_loss} vs the CPU "
             f"{cpu_loss}: relative error {f32_rel} > {FAM_T5_F32_REL_TOL}")
    del params, opt_state, step
    _release()
    return row


def phase_families(seed: int, card: str) -> dict:
    """The four legs; returns the flash launches of the three that reach
    the kernels."""
    started = time.perf_counter()
    rows = {"moe": _families_moe(seed, card)}
    _release()
    for leg in ("bert", "vit"):
        rows[leg] = _families_encoder(seed, card, leg)
    rows["t5"] = _families_t5(seed, card)
    launches = {name: sum(rows[leg]["launches"][name]
                          for leg in ("moe", "bert", "vit"))
                for name in TRAINING_KERNELS}
    emit({"phase": "families", "card": card, "launches": launches,
          "phase_s": time.perf_counter() - started})
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 13: where users enter the two main paths
# ---------------------------------------------------------------------------

EP_SHARD_BYTES = 5 * 10 ** 9        # transformers' default shard size
EP_TRAIN_STEPS, EP_LOG_EVERY, EP_EPOCH_STEPS = 8, 4, 2
# patience 1 and an improvement no loss can make: the second epoch's end
# (step 4) stops the run
EP_EARLY_STOP = {"monitor": "loss", "patience": 1, "min_delta": 1e3}
EP_STOP_STEP = 4
EP_CHECKPOINT_EVERY = 2
EP_EVAL_STEPS = 2
EP_TOKEN_CHUNKS = 64                # the tokens .npy: 64 sequences of 2048
# HuggingFaceModelServer's float32 pipeline on the card vs on the CPU (TF32
# off): a classifier's softmax scores
EP_PIPELINE_TOL = 1e-4


def _hf_tensors(config, params) -> list:
    """(HF name, tensor in HF layout [out, in]) of a Llama param tree, in
    the order transformers writes them."""
    layers = params["layers"]
    out = [("model.embed_tokens.weight", params["embedding"])]
    for i in range(config.n_layers):
        pre = f"model.layers.{i}."
        out += [
            (pre + "input_layernorm.weight", layers["attn_norm_scale"][i]),
            (pre + "self_attn.q_proj.weight", layers["wq"][i].t()),
            (pre + "self_attn.k_proj.weight", layers["wk"][i].t()),
            (pre + "self_attn.v_proj.weight", layers["wv"][i].t()),
            (pre + "self_attn.o_proj.weight", layers["wo"][i].t()),
            (pre + "post_attention_layernorm.weight",
             layers["mlp_norm_scale"][i]),
            (pre + "mlp.gate_proj.weight", layers["w_gate"][i].t()),
            (pre + "mlp.up_proj.weight", layers["w_up"][i].t()),
            (pre + "mlp.down_proj.weight", layers["w_down"][i].t()),
        ]
    out.append(("model.norm.weight", params["final_norm_scale"]))
    if "lm_head" in params:
        out.append(("lm_head.weight", params["lm_head"].t()))
    return out


def _write_hf_checkpoint(directory: str, config, params) -> tuple:
    """Write ``params`` (bf16) as an HF safetensors checkpoint: sharded
    files of about ``EP_SHARD_BYTES``, ``model.safetensors.index.json``
    and a ``config.json`` stating every field. Each shard's header is
    planned from the shapes, then its tensors are copied to the host and
    written one at a time. Returns (bytes of tensor data, shards)."""
    import struct

    import torch

    tensors = _hf_tensors(config, params)
    shards, current, size = [], [], 0
    for name, tensor in tensors:
        nbytes = tensor.numel() * tensor.element_size()
        if current and size + nbytes > EP_SHARD_BYTES:
            shards.append(current)
            current, size = [], 0
        current.append((name, tensor))
        size += nbytes
    shards.append(current)
    weight_map, total = {}, 0
    for index, shard in enumerate(shards):
        fname = f"model-{index + 1:05d}-of-{len(shards):05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name, tensor in shard:
            if tensor.dtype != torch.bfloat16:
                fail(f"hf writer: {name} is {tensor.dtype}, not bf16")
            nbytes = tensor.numel() * 2
            header[name] = {"dtype": "BF16", "shape": list(tensor.shape),
                            "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(directory, fname), "wb") as fp:
            fp.write(struct.pack("<Q", len(raw)))
            fp.write(raw)
            for name, tensor in shard:
                host = tensor.contiguous().cpu()
                fp.write(host.view(torch.uint8).numpy())
                del host
        total += offset
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as fp:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, fp)
    with open(os.path.join(directory, "config.json"), "w") as fp:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": config.vocab_size,
            "hidden_size": config.embed_dim,
            "num_hidden_layers": config.n_layers,
            "num_attention_heads": config.n_heads,
            "num_key_value_heads": config.n_kv_heads,
            "head_dim": config.head_dim,
            "intermediate_size": config.mlp_dim,
            "rope_theta": config.rope_theta,
            "rms_norm_eps": config.norm_eps,
            "tie_word_embeddings": config.tie_embeddings,
            "torch_dtype": "bfloat16"}, fp)
    return total, len(shards)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as fp:
        return int(fp.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _PeakRss:
    """The process's peak resident set while the block runs, sampled
    every millisecond by a thread."""

    def __enter__(self):
        import threading

        self.before = self.peak = _rss_bytes()
        self._done = threading.Event()

        def sample():
            while not self._done.wait(1e-3):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss_bytes())


def _word_tokenizer(directory: str, vocab: int):
    """A word-level tokenizer over the whole vocabulary (``t0`` ..
    ``t<vocab-1>``, so every id decodes and re-encodes), built with
    ``tokenizers`` and saved as a ``PreTrainedTokenizerFast``; None, with
    the skip line, where ``transformers`` is not installed."""
    try:
        import transformers
    except ImportError:
        emit({"phase": "entry_points", "leg": "tokenizer",
              "skipped": "transformers not installed"})
        return None
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({f"t{i}": i for i in range(vocab)},
                                     unk_token="t0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="t0").save_pretrained(directory)
    return transformers.AutoTokenizer.from_pretrained(directory)


def _same_bits(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


def _ep_sharded_reload(directory: str, params, card: str) -> dict:
    """The 8B checkpoint reloaded with ``shardings=`` (the port's
    ``tree_shardings`` placements) for a one-rank mesh {"fsdp": 1} on a
    world-size-1 NCCL group: every leaf a DTensor whose local tensor is
    bit-equal to the params written."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mlrun_tpu_torch.frameworks import huggingface as hf
    from mlrun_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from mlrun_tpu_torch.parallel.sharding import tree_shardings
    from mlrun_tpu_torch.training.train import tree_leaves, tree_map

    existed = dist.is_initialized()
    initialize_distributed(device="cuda")
    try:
        mesh = make_mesh({"fsdp": 1}, "cuda")
        torch.cuda.synchronize()
        started = time.perf_counter()
        _, placed = hf.load_hf_weights_into_llama(
            directory, shardings=tree_shardings(params, mesh))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - started
        all_dtensors = all(isinstance(leaf, DTensor)
                           for leaf in tree_leaves(placed))
        equal = _same_bits(tree_map(lambda t: t.to_local(), placed), params)
        del placed
    finally:
        if not existed:
            dist.destroy_process_group()
    row = {"phase": "entry_points", "leg": "hf_shardings", "card": card,
           "mesh": {"fsdp": 1}, "load_s": load_s,
           "leaves_dtensor": all_dtensors, "leaves_bit_equal": equal}
    emit(row)
    if not (all_dtensors and equal):
        fail(f"entry_points hf shardings=: {row}")
    return row


def _ep_serve_leg(seed: int, card: str) -> dict:
    """LLMModelServer(hf_model=) at Llama-3-8B from a checkpoint this leg
    writes of the serve phase's seeded params; its leaves against the
    written ones, its streams against the preset server's; the tokenizer
    leg on the same server."""
    import shutil
    import tempfile

    import torch

    from mlrun_tpu_torch.frameworks import huggingface as hf
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.llm import LLMModelServer

    config = llama.MODEL_PRESETS["llama3-8b"]()
    prompts = _prompts(seed, config.vocab_size)
    generator = torch.Generator(device="cuda")
    generator.manual_seed(seed)
    params = llama.init_params(config, generator, "cuda")
    directory = tempfile.mkdtemp(prefix="mlt-hf-")
    tok_dir = os.path.join(directory, "tokenizer")
    os.makedirs(tok_dir)
    server_kw = dict(continuous_batching=True, paged=True, slots=4,
                     max_len=MAX_LEN, page_size=PAGE, max_new_tokens=MAX_NEW)
    try:
        need = sum(t.numel() * t.element_size()
                   for _, t in _hf_tensors(config, params))
        free = shutil.disk_usage(directory).free
        emit({"phase": "entry_points", "leg": "hf_checkpoint",
              "directory_free_gb": free / 1e9, "checkpoint_gb": need / 1e9,
              "card": card})
        if free < need + (1 << 30):
            fail(f"entry_points: {free / 1e9:.2f} GB free under "
                 f"{directory}, the checkpoint needs {need / 1e9:.2f} GB")
        started = time.perf_counter()
        # the bytes handed to the OS (its page cache), not flushed to disk
        written, shards = _write_hf_checkpoint(directory, config, params)
        write_s = time.perf_counter() - started
        tokenizer = _word_tokenizer(tok_dir, config.vocab_size)

        # -- the main path, counted: every count reset right before it -----
        timing = {}
        loader = hf.load_hf_weights_into_llama

        def timed_loader(*args, **kwargs):
            with _PeakRss() as rss:
                t0 = time.perf_counter()
                out = loader(*args, **kwargs)
                torch.cuda.synchronize()
                timing["load_weights_s"] = time.perf_counter() - t0
            timing["rss"] = rss
            return out

        hf.load_hf_weights_into_llama = timed_loader
        _build.reset_launch_counts()
        try:
            started = time.perf_counter()
            server = LLMModelServer(
                name="llama3-8b-hf", hf_model=directory,
                tokenizer=tok_dir if tokenizer is not None else None,
                **server_kw)
            server.post_init()
            load_s = time.perf_counter() - started
        finally:
            hf.load_hf_weights_into_llama = loader
        if not server.ready:
            fail(f"LLMModelServer(hf_model=) failed to load: {server.error}")

        def submit(batch):
            return server.do_event(_Event({"inputs": batch})).body["outputs"]

        t0 = time.perf_counter()
        hf_out = _serve_events(submit, prompts)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = _build.launch_counts()
        stats = server.engine.stats
        leaves_equal = _same_bits(server.engine.params, params)
        loaded_config = server.engine.config
        tok_row = None
        if tokenizer is not None:
            _build.reset_launch_counts()
            texts = [" ".join(f"t{i}" for i in p) for p in prompts]
            replies = submit(texts)
            tok_launches = _build.launch_counts()
            ids = [tokenizer(text)["input_ids"] for text in replies]
            tok_row = {
                "phase": "entry_points", "leg": "tokenizer", "card": card,
                "requests": len(texts), "launches": tok_launches,
                "prompts_encode_to_ids": [tokenizer(t)["input_ids"] == p
                                          for t, p in zip(texts, prompts)],
                "outputs_round_trip": [
                    isinstance(r, str) and len(i) == MAX_NEW
                    and tokenizer.decode(i) == r
                    for r, i in zip(replies, ids)],
                "outputs_equal_id_streams_share": sum(
                    i == o for i, o in zip(ids, hf_out)) / len(ids),
            }
        server.close()
        del server
        _release()
        _ep_sharded_reload(directory, params, card)
        del params
        _release()
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    # the same traffic on the preset server with the same seed
    started = time.perf_counter()
    preset = LLMModelServer(name="llama3-8b", model_preset="llama3-8b",
                            seed=seed, **server_kw)
    preset.post_init()
    preset_load_s = time.perf_counter() - started
    if not preset.ready:
        fail(f"the preset LLMModelServer failed to load: {preset.error}")
    preset_out = _serve_events(
        lambda batch: preset.do_event(_Event({"inputs": batch}))
        .body["outputs"], prompts)
    preset.close()
    del preset
    _release()

    rss = timing["rss"]
    row = {
        "phase": "entry_points", "leg": "hf_serve", "model": "llama3-8b",
        "layers": loaded_config.n_layers, "card": card,
        "checkpoint_gb": written / 1e9, "shards": shards,
        "write_s": write_s, "write_gb_s": written / 1e9 / write_s,
        "load_weights_s": timing["load_weights_s"],
        "load_gb_s": written / 1e9 / timing["load_weights_s"],
        "load_rss_before_gb": rss.before / 1e9,
        "load_peak_rss_gb": rss.peak / 1e9,
        "load_rss_rise_gb": (rss.peak - rss.before) / 1e9,
        "load_s": load_s, "preset_load_s": preset_load_s,
        "serve_s": serve_s, "requests": len(hf_out),
        "leaves_bit_equal": leaves_equal,
        "config_rope_theta": loaded_config.rope_theta,
        "config_norm_eps": loaded_config.norm_eps,
        "streams_equal_preset": hf_out == preset_out,
        "launches": launches,
        "attn_kernel_ticks": stats["attn_kernel_ticks"],
        "prefill_kernel_chunks": stats["prefill_kernel_chunks"],
        "prefix_hit_rate": stats.get("prefix_hit_rate"),
    }
    emit(row)
    if not leaves_equal:
        fail("entry_points: a loaded leaf differs from the written one")
    if (loaded_config.rope_theta, loaded_config.norm_eps) != (
            config.rope_theta, config.norm_eps):
        fail(f"entry_points: config.json read as {loaded_config}")
    _check_launches(launches, SERVING_KERNELS, "entry_points hf serve")
    if stats["prefill_gather_admissions"] or stats["attn_gather_ticks"]:
        fail("entry_points: the hf server fell back to a gather path")
    if not row["streams_equal_preset"]:
        fail("entry_points: the hf server's token streams differ from the "
             "preset server's")
    if tok_row is not None:
        emit(tok_row)
        if not (all(tok_row["prompts_encode_to_ids"])
                and all(tok_row["outputs_round_trip"])):
            fail(f"entry_points tokenizer: {tok_row}")
        _check_launches(tok_row["launches"], SERVING_KERNELS,
                        "entry_points tokenizer")
        for name in SERVING_KERNELS:
            launches[name] += tok_row["launches"][name]
    return launches


def _ep_pipeline_leg(seed: int, card: str):
    """HuggingFaceModelServer with no device argument on a tiny random
    BERT classifier: its pipeline runs on the card and answers as the
    same server asked for the CPU (scores within EP_PIPELINE_TOL). Where
    ``transformers`` is not installed, one skip line."""
    import shutil
    import tempfile

    try:
        import transformers
    except ImportError:
        emit({"phase": "entry_points", "leg": "hf_pipeline",
              "skipped": "transformers not installed"})
        return
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers

    from mlrun_tpu_torch.frameworks.huggingface import HuggingFaceModelServer

    words = ["[UNK]", "[PAD]", "good", "bad", "movie", "plot", "dull"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    torch.manual_seed(seed)
    model = transformers.BertForSequenceClassification(
        transformers.BertConfig(vocab_size=len(words), hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=64, num_labels=2,
                                max_position_embeddings=32))
    directory = tempfile.mkdtemp(prefix="mlt-pipe-")
    try:
        model.save_pretrained(directory)
        transformers.PreTrainedTokenizerFast(
            tokenizer_object=tok, unk_token="[UNK]",
            pad_token="[PAD]").save_pretrained(directory)
        body = {"inputs": ["good movie", "bad plot", "dull dull movie"]}
        outputs, devices = [], []
        for kw in ({}, {"device": "cpu"}):
            server = HuggingFaceModelServer(
                name="clf", task="text-classification",
                model_name=directory, **kw)
            server.post_init()
            if not server.ready:
                fail(f"entry_points hf_pipeline: {server.error}")
            devices.append(str(server.model.device))
            outputs.append(server.do_event(_Event(dict(body)))
                           .body["outputs"])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    card_out, cpu_out = outputs
    gap = max(abs(a[0]["score"] - b[0]["score"])
              for a, b in zip(card_out, cpu_out))
    labels_equal = [a[0]["label"] for a in card_out] == [
        b[0]["label"] for b in cpu_out]
    emit({"phase": "entry_points", "leg": "hf_pipeline", "card": card,
          "devices": devices, "labels_equal_cpu": labels_equal,
          "max_score_gap": gap, "tol": EP_PIPELINE_TOL})
    if not devices[0].startswith("cuda"):
        fail(f"entry_points hf_pipeline: the default server ran on "
             f"{devices[0]}, not the card")
    if not (labels_equal and gap <= EP_PIPELINE_TOL):
        fail(f"entry_points hf_pipeline: card {card_out} vs cpu {cpu_out}")


def _ep_train_leg(seed: int, card: str, train_step_ms) -> dict:
    """auto_trainer.train at Llama-3.2-1B on a tokens .npy with early
    stopping on epochs, a checkpoint every 2 steps and a recording
    callback; then evaluate from that checkpoint against a direct
    loss_fn over the trained params."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mlrun_tpu_torch.frameworks._common import Callback
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training.data import array_token_stream, to_device

    config = llama.MODEL_PRESETS["llama3-1b"]()

    class Recorder(Callback):
        """The hooks' sequence; off the log points, the type and device of
        the metrics it is handed; then it reads the loss (a host sync),
        as a callback that reads a value does."""

        def __init__(self):
            self.events, self.handed, self.stamps = [], {}, []

        def on_train_begin(self):
            self.events.append("train_begin")

        def on_epoch_begin(self, epoch):
            self.events.append(["epoch_begin", epoch])

        def on_step_end(self, step, metrics):
            loss = metrics["loss"]
            self.handed[step] = (type(loss).__name__,
                                 str(getattr(loss, "device", "host")))
            float(loss)
            self.stamps.append(time.perf_counter())
            self.events.append(["step", step])

        def on_epoch_end(self, epoch, metrics):
            self.events.append(["epoch_end", epoch])

        def on_train_end(self, metrics):
            self.events.append("train_end")

    work = tempfile.mkdtemp(prefix="mlt-train-")
    try:
        dataset = os.path.join(work, "tokens.npy")
        np.save(dataset, np.random.default_rng(seed).integers(
            0, config.vocab_size, EP_TOKEN_CHUNKS * TRAIN_SEQ + 1,
            dtype=np.int32))
        checkpoints = os.path.join(work, "checkpoints")
        recorder = Recorder()

        # -- the main path, counted: every count reset right before it -----
        _build.reset_launch_counts()
        final = auto_trainer.train(
            model="llama3-1b", dataset=dataset, batch_size=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, steps=EP_TRAIN_STEPS, log_every=EP_LOG_EVERY,
            epoch_steps=EP_EPOCH_STEPS, early_stop=dict(EP_EARLY_STOP),
            callbacks=[recorder], checkpoint_dir=checkpoints,
            checkpoint_every=EP_CHECKPOINT_EVERY, seed=seed)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        saved = sorted(int(p) for p in os.listdir(checkpoints)
                       if p.isdigit())
        stamps = recorder.stamps
        # steps 0->1 and 2->3 hold no checkpoint write (those follow the
        # recorder at steps 1 and 3)
        step_ms = sorted((stamps[i + 1] - stamps[i]) * 1e3 for i in (0, 2)
                         if i + 1 < len(stamps))
        passes = EP_STOP_STEP + 1   # the warmup's pass and every step
        want = {"flash_fwd": 2 * config.n_layers * passes,
                "flash_bwd": config.n_layers * passes}
        events = [["epoch_begin", 0], ["step", 0], ["step", 1],
                  ["epoch_end", 0], ["epoch_begin", 1], ["step", 2],
                  ["step", 3], ["epoch_end", 1]]
        row = {
            "phase": "entry_points", "leg": "callbacks_train",
            "model": "llama3-1b", "layers": config.n_layers, "card": card,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": EP_TRAIN_STEPS,
            "log_every": EP_LOG_EVERY, "epoch_steps": EP_EPOCH_STEPS,
            "stopped_early": final.get("stopped_early"),
            "step": final.get("step"), "loss": final.get("loss"),
            "events": recorder.events, "handed_off_log_points": {
                str(k): v for k, v in recorder.handed.items()},
            "checkpoint_steps": saved,
            "callback_step_ms": step_ms,
            "checkpoint_interval_ms": (stamps[2] - stamps[1]) * 1e3
            if len(stamps) > 2 else None,
            "window_step_ms": TRAIN_BATCH * TRAIN_SEQ
            / final["tokens_per_sec"] * 1e3,
            "train_phase_step_ms": train_step_ms,
            "train_time_s": final["train_time_s"],
            "launches": launches, "expected_launches": want,
        }
        emit(row)
        if not (final.get("stopped_early") is True
                and final.get("step") == EP_STOP_STEP):
            fail(f"entry_points train: expected an early stop at step "
                 f"{EP_STOP_STEP}, got {final}")
        if recorder.events != ["train_begin"] + events + ["train_end"]:
            fail(f"entry_points train: hooks {recorder.events}")
        for step, (kind, device) in recorder.handed.items():
            log_point = (step + 1) % EP_LOG_EVERY == 0
            if not log_point and (kind != "Tensor"
                                  or not device.startswith("cuda")):
                fail(f"entry_points train: step {step} handed {kind} on "
                     f"{device}, not the raw metrics on the card")
        if saved != [2, 4]:
            fail(f"entry_points train: checkpoints {saved}, expected [2, 4]")
        _exact_launches("entry_points train", launches, want)
        trainer = recorder.trainer
        del recorder

        # -- evaluate from that checkpoint, counted on its own -------------
        _build.reset_launch_counts()
        with _PeakRss() as eval_rss:
            evaluated = auto_trainer.evaluate(
                model="llama3-1b", checkpoint_dir=checkpoints,
                dataset=dataset, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                steps=EP_EVAL_STEPS, seed=seed)
            torch.cuda.synchronize()
        eval_launches = _build.launch_counts()
        step_dir = os.path.join(checkpoints, str(saved[-1]))
        checkpoint_bytes = sum(os.path.getsize(os.path.join(step_dir, name))
                               for name in os.listdir(step_dir))
        params_bytes = os.path.getsize(os.path.join(step_dir, "params.pt"))
        eval_rss_rise = eval_rss.peak - eval_rss.before
        stream = array_token_stream(np.load(dataset), TRAIN_BATCH, TRAIN_SEQ,
                                    seed=seed)
        direct = []
        with torch.no_grad():
            for _ in range(EP_EVAL_STEPS):
                tokens, targets = to_device(next(stream), "cuda")
                direct.append(float(llama.loss_fn(
                    trainer.model_config, trainer.state.params, tokens,
                    targets)[1]["loss"]))
        direct_loss = sum(direct) / len(direct)
        rel = abs(evaluated["eval_loss"] - direct_loss) / abs(direct_loss)
        eval_want = {"flash_fwd": config.n_layers * EP_EVAL_STEPS,
                     "flash_bwd": 0}
        eval_row = {
            "phase": "entry_points", "leg": "evaluate", "model": "llama3-1b",
            "card": card, "steps": EP_EVAL_STEPS, **evaluated,
            "direct_loss": direct_loss, "eval_loss_rel_err": rel,
            "eval_loss_rel_tol": TRAIN_LOSS_REL_TOL,
            "checkpoint_gb": checkpoint_bytes / 1e9,
            "params_file_gb": params_bytes / 1e9,
            "rss_rise_gb": eval_rss_rise / 1e9,
            "launches": eval_launches, "expected_launches": eval_want,
        }
        emit(eval_row)
        # the checkpoint holds params and both moments; evaluate reads the
        # params alone, a leaf at a time, so the host never holds them all
        if eval_rss_rise >= params_bytes:
            fail(f"entry_points evaluate: host RSS rose {eval_rss_rise} "
                 f"bytes restoring {params_bytes} bytes of params from a "
                 f"{checkpoint_bytes}-byte checkpoint")
        if not (math.isfinite(evaluated["eval_loss"]) and
                rel <= TRAIN_LOSS_REL_TOL):
            fail(f"entry_points evaluate: eval_loss {evaluated['eval_loss']}"
                 f" vs a direct loss_fn {direct_loss}: relative error {rel} "
                 f"> {TRAIN_LOSS_REL_TOL}")
        _exact_launches("entry_points evaluate", eval_launches, eval_want)
        del trainer
        _release()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {name: launches.get(name, 0) + eval_launches.get(name, 0)
            for name in TRAINING_KERNELS}


def phase_entry_points(seed: int, card: str, train_step_ms=None) -> dict:
    """The hf serve and tokenizer legs at 8B, then the callbacks train
    and evaluate legs at 1B; returns every kernel's launches on them."""
    started = time.perf_counter()
    launches = _ep_serve_leg(seed, card)
    _ep_pipeline_leg(seed, card)
    launches.update(_ep_train_leg(seed, card, train_step_ms))
    emit({"phase": "entry_points", "card": card, "launches": launches,
          "phase_s": time.perf_counter() - started})
    return launches


# ---------------------------------------------------------------------------
# phase 14: training on many GPUs, at world size 1 on this card: the
# sharded step, the sharded checkpoint with resume, and the ring's hops
# ---------------------------------------------------------------------------

PAR_STEPS = 4
PAR_SAVE_STEP = 2
PAR_MESH = {"data": 1, "fsdp": 1}
# the 1B model's attention: 4 sequence shards of 2048
RING_SHARDS, RING_SEQ, RING_HEADS, RING_KV, RING_HEAD_DIM = 4, 8192, 32, 8, 64
# ring dq/dk/dv against the flash backward over the whole sequence (bf16,
# the same q, k, v, dO and the ring's own o and lse). The full kernel
# rounds one float32 sum X to bf16 once: within half a bf16 ulp of X plus
# the float32 order floor (the kernels phase's bound). The ring adds n
# float32-summed partials, each already rounded to bf16 by its hop's
# kernel (half an ulp of the partial each), then rounds the sum once. A
# partial is taken to be no larger than the tensor's largest gradient
# ``top``. So |ring - full| <= 2 half ulps of |full| (both final
# roundings) + n half ulps of top + two floors of top, where n is the
# number of hops summed into that shard: rank r's dq sums r + 1 hops,
# shard s's dk/dv the P - s ranks at or after it.
RING_GRAD_FLOORS = 2


def _par_trainer(config, mesh_shape, seed, **train_kw):
    from mlrun_tpu_torch.training import TrainConfig, Trainer

    train_kw.setdefault("total_steps", PAR_STEPS)
    trainer = Trainer(config, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, loss_chunk=LOSS_CHUNK,
        mesh_shape=mesh_shape, **train_kw), device="cuda")
    trainer.init(seed)
    return trainer


def _counted_fit(trainer, batches, batch: int, seq: int, want: dict,
                 path: str) -> dict:
    """Warm ``trainer`` up, then fit it on ``batches`` with every launch
    count reset right before: the history, the launches (exactly
    ``want``) and the peak memory of the fit."""
    import torch

    from mlrun_tpu_torch.ops import _build

    trainer.warmup(batch, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path, counted: every count reset right before it --------
    _build.reset_launch_counts()
    trainer.fit(iter(batches), len(batches), log_every=1, prefetch=2)
    torch.cuda.synchronize()
    run = {"history": trainer.metrics_history,
           "launches": _build.launch_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    _exact_launches(path, run["launches"], want)
    return run


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def _par_sharded_leg(seed: int, card: str, train_step_ms, work: str
                     ) -> dict:
    """(a) Trainer.fit at Llama-3.2-1B on the mesh {"data": 1, "fsdp": 1}
    (a world-size-1 NCCL group) against the no-mesh Trainer on the same
    seed and batches; (b) the sharded state saved at step 2 through DCP
    and resumed by the environment directive in a fresh Trainer, whose
    steps 3-4 must equal the uninterrupted run's. Returns the flash
    launches of both main paths."""
    import shutil

    import torch
    from torch.distributed.tensor import DTensor

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import CheckpointManager
    from mlrun_tpu_torch.training.checkpoint import (
        RESUME_CHECKPOINT_ENV,
        RESUME_STEP_ENV,
    )
    from mlrun_tpu_torch.training.data import synthetic_token_stream
    from mlrun_tpu_torch.training.train import tree_leaves

    config = MODEL_PRESETS["llama3-1b"]()
    stream = synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ, config.vocab_size,
                                    seed=seed)
    batches = [next(stream) for _ in range(PAR_STEPS)]
    per_pass = config.n_layers * PAR_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    runs = {"no_mesh": [], "mesh": []}
    # in turns (no mesh, mesh, mesh, no mesh): the first trainer of a
    # process also pays the allocator's growth, so one pair would not
    # tell the sharded path's overhead from the order
    for leg, shape in (("no_mesh", None), ("mesh", PAR_MESH),
                       ("mesh", PAR_MESH), ("no_mesh", None)):
        trainer = _par_trainer(config, shape, seed)
        trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
        # -- the main path, counted: every count reset right before it -----
        _build.reset_launch_counts()
        trainer.fit(iter(batches), PAR_STEPS, log_every=1, prefetch=2)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        history = trainer.metrics_history
        run = {
            "losses": [m["loss"] for m in history],
            "grad_norms": [m["grad_norm"] for m in history],
            "step_ms": tokens_per_step / history[-1]["tokens_per_sec"] * 1e3,
            "launches": launches,
            "dtensor_state": all(isinstance(leaf, DTensor) for leaf in
                                 tree_leaves(trainer.state.params)),
        }
        _exact_launches(f"parallel {leg}", launches, want)
        if leg == "no_mesh" and not runs[leg]:
            # the single-device checkpoint of the same state, for the DCP
            # save's comparison on this card
            plain_dir = os.path.join(work, "plain")
            started = time.perf_counter()
            CheckpointManager(plain_dir).save(PAR_STEPS, trainer.state)
            run["torch_save_s"] = time.perf_counter() - started
            run["torch_save_bytes"] = _dir_bytes(plain_dir)
            shutil.rmtree(plain_dir, ignore_errors=True)
        runs[leg].append(run)
        del trainer, history
        _release()
    plain, mesh = runs["no_mesh"][0], runs["mesh"][0]
    others = runs["no_mesh"] + runs["mesh"]
    bit_equal = all(r["losses"] == plain["losses"]
                    and r["grad_norms"] == plain["grad_norms"]
                    for r in others)
    loss_rel = max(abs(a - b) / abs(a) for r in others
                   for a, b in zip(plain["losses"], r["losses"]))
    mesh_ms = [r["step_ms"] for r in runs["mesh"]]
    plain_ms = [r["step_ms"] for r in runs["no_mesh"]]
    row = {"phase": "parallel", "leg": "sharded_step", "model": "llama3-1b",
           "layers": config.n_layers, "card": card, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "mesh": PAR_MESH, "backend": "nccl",
           "world_size": 1, "steps": PAR_STEPS,
           "losses_no_mesh": plain["losses"], "losses_mesh": mesh["losses"],
           "grad_norms_no_mesh": plain["grad_norms"],
           "grad_norms_mesh": mesh["grad_norms"], "bit_equal": bit_equal,
           "loss_rel_err": loss_rel, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
           "state_is_dtensor": all(r["dtensor_state"]
                                   for r in runs["mesh"]),
           "order": ["no_mesh", "mesh", "mesh", "no_mesh"],
           "step_ms_mesh": mesh_ms, "step_ms_no_mesh": plain_ms,
           "mesh_overhead_ms": sum(mesh_ms) / 2 - sum(plain_ms) / 2,
           "train_phase_step_ms": train_step_ms,
           "launches": mesh["launches"], "expected_launches": want}
    emit(row)
    if not row["state_is_dtensor"]:
        fail("parallel: the mesh trainer's params are not DTensors")
    if not bit_equal and not loss_rel <= TRAIN_LOSS_REL_TOL:
        fail(f"parallel: mesh losses {mesh['losses']} vs no mesh "
             f"{plain['losses']}: relative error {loss_rel}")

    # -- (b) the sharded checkpoint and the resume directive ----------------
    directory = os.path.join(work, "dcp")
    manager = CheckpointManager(directory)
    _build.reset_launch_counts()
    first = _par_trainer(config, PAR_MESH, seed)
    first.fit(iter(batches[:PAR_SAVE_STEP]), PAR_SAVE_STEP, log_every=1,
              prefetch=2)
    torch.cuda.synchronize()
    started = time.perf_counter()
    manager.save(PAR_SAVE_STEP, first.state, force=True)
    save_s = time.perf_counter() - started
    save_bytes = _dir_bytes(os.path.join(directory, str(PAR_SAVE_STEP)))
    first_losses = [m["loss"] for m in first.metrics_history]
    del first
    _release()
    os.environ[RESUME_CHECKPOINT_ENV] = directory
    os.environ[RESUME_STEP_ENV] = str(PAR_SAVE_STEP)
    try:
        second = _par_trainer(config, PAR_MESH, seed)
        second.fit(iter(batches[PAR_SAVE_STEP:]), PAR_STEPS - PAR_SAVE_STEP,
                   log_every=1, prefetch=2, checkpoint_manager=manager)
        torch.cuda.synchronize()
    finally:
        os.environ.pop(RESUME_CHECKPOINT_ENV, None)
        os.environ.pop(RESUME_STEP_ENV, None)
    resume_launches = _build.launch_counts()
    resumed = [m["loss"] for m in second.metrics_history]
    badput = second.goodput.summary()["badput"]
    ck_row = {"phase": "parallel", "leg": "sharded_checkpoint",
              "model": "llama3-1b", "card": card, "mesh": PAR_MESH,
              "save_step": PAR_SAVE_STEP, "final_step": second.state.step,
              "dcp_save_s": save_s, "dcp_bytes": save_bytes,
              "dcp_restore_s": badput.get("checkpoint"),
              "torch_save_s": plain["torch_save_s"],
              "torch_save_bytes": plain["torch_save_bytes"],
              "losses_before_save": first_losses, "losses_resumed": resumed,
              "losses_uninterrupted": mesh["losses"],
              "resumed_bit_equal": resumed == mesh["losses"][PAR_SAVE_STEP:],
              "launches": resume_launches, "expected_launches": want}
    emit(ck_row)
    del second
    _release()
    if first_losses != mesh["losses"][:PAR_SAVE_STEP]:
        fail(f"parallel checkpoint: steps before the save {first_losses} "
             f"differ from the uninterrupted run {mesh['losses']}")
    if not ck_row["resumed_bit_equal"] or ck_row["final_step"] != PAR_STEPS:
        fail(f"parallel checkpoint: resumed steps {resumed} (to step "
             f"{ck_row['final_step']}) differ from the uninterrupted run's "
             f"{mesh['losses'][PAR_SAVE_STEP:]}")
    _exact_launches("parallel checkpoint", resume_launches, want)
    return {name: sum(r["launches"][name] for r in runs["mesh"])
            + resume_launches[name] for name in TRAINING_KERNELS}


def _par_ring_leg(seed: int, card: str) -> dict:
    """(c) every rank's ring hops in ring order, in this process, at the
    1B attention shape, against the flash over the whole sequence."""
    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.ops import attention as at
    from mlrun_tpu_torch.ops.ring_attention import ring_hops_bwd, ring_hops_fwd

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn((1, RING_SEQ, heads, RING_HEAD_DIM), generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(RING_HEADS), randn(RING_KV), randn(RING_KV), \
        randn(RING_HEADS)
    shard = RING_SEQ // RING_SHARDS
    qs, ks, vs, dos = ([t[:, i * shard:(i + 1) * shard].contiguous()
                        for i in range(RING_SHARDS)] for t in (q, k, v, do))
    # -- the hops, counted: every count reset right before them ------------
    _build.reset_launch_counts()
    outs = ring_hops_fwd(qs, ks, vs)
    os_, lses = [o for o, _ in outs], [lse for _, lse in outs]
    dqs, dks, dvs = ring_hops_bwd(qs, ks, vs, os_, lses, dos)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    hops = RING_SHARDS * (RING_SHARDS + 1) // 2
    want = {"flash_fwd": hops, "flash_bwd": hops}
    o, lse = torch.cat(os_, dim=1), torch.cat(lses, dim=2)
    o_full, lse_full = at.flash_fwd(q, k, v, True)
    errs = {"o": _err(o, o_full), "lse": _err(lse, lse_full)}
    full = at.flash_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    grad_errs, over = {}, {}
    for name, parts, ref in (("dq", dqs, full[0]), ("dk", dks, full[1]),
                             ("dv", dvs, full[2])):
        top = float(ref.abs().max())
        worst, err = 0.0, 0.0
        for i, got in enumerate(parts):
            n = i + 1 if name == "dq" else RING_SHARDS - i
            part = ref[:, i * shard:(i + 1) * shard].float()
            bound = (part.abs() * 2 * BF16_HALF_ULP
                     + (n * BF16_HALF_ULP + RING_GRAD_FLOORS
                        * BF16_GRAD_FLOOR) * top)
            diff = (got.float() - part).abs()
            worst = max(worst, float((diff / bound).max()))
            err = max(err, float(diff.max()))
        grad_errs[name], over[name] = err, worst
    ring_fwd_ms = time_ms(lambda: ring_hops_fwd(qs, ks, vs), iters=5)
    full_fwd_ms = time_ms(lambda: at.flash_fwd(q, k, v, True), iters=5)
    ring_bwd_ms = time_ms(lambda: ring_hops_bwd(qs, ks, vs, os_, lses, dos),
                          iters=5)
    full_bwd_ms = time_ms(lambda: at.flash_bwd(q, k, v, o, lse, do, True),
                          iters=5)
    row = {"phase": "parallel", "leg": "ring_hops", "card": card,
           "B": 1, "S": RING_SEQ, "shards": RING_SHARDS, "H": RING_HEADS,
           "Hkv": RING_KV, "D": RING_HEAD_DIM, "dtype": "bf16",
           "launches": launches, "expected_launches": want,
           "errs": errs, "tol": TOL["bf16"], "grad_max_abs_err": grad_errs,
           "grad_err_over_bound": over,
           "ring_fwd_ms": ring_fwd_ms, "full_fwd_ms": full_fwd_ms,
           "ring_bwd_ms": ring_bwd_ms, "full_bwd_ms": full_bwd_ms}
    emit(row)
    _exact_launches("parallel ring hops", launches, want)
    _check(f"ring hops S {RING_SEQ} as {RING_SHARDS} shards", "bf16", errs)
    for name, worst in over.items():
        if not worst <= 1.0:
            fail(f"ring hops {name}: error {worst} x its bound "
                 f"(max_abs_err {grad_errs[name]})")
    return launches


# (a) one Llama-3-8B-width layer on tensor ranks, in one process
TP_SIZES = (2, 8)
TP_BATCH, TP_SEQ = 1, 2048
def _rel(got, ref) -> float:
    """||got - ref|| / ||ref|| in float32."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm())


def _local_head_times(config, tensor: int, gen) -> dict:
    """The training flash forward and backward at a tensor rank's local
    head counts (every rank of the leg runs these shapes), beside SDPA
    on the same inputs, with their bounds."""
    import torch
    import torch.nn.functional as F

    from mlrun_tpu_torch.ops import attention as at

    h, hkv, d = config.n_heads // tensor, config.n_kv_heads // tensor, \
        config.head_dim

    def randn(heads):
        return torch.randn((TP_BATCH, TP_SEQ, heads, d), generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(h), randn(hkv), randn(hkv), randn(h)
    o, lse = at.flash_fwd(q, k, v, True)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, leaves, dot)

    pairs = _train_pairs(True, TP_BATCH, TP_SEQ, h)
    item = q.element_size()
    fwd_bound, fwd_by = bound_ms((2 * q.numel() + 2 * k.numel()) * item
                                 + lse.numel() * 4, 4 * d * pairs, "bf16")
    bwd_bound, bwd_by = bound_ms((4 * q.numel() + 4 * k.numel()) * item
                                 + lse.numel() * 4, 10 * d * pairs, "bf16")
    return {
        "H": h, "Hkv": hkv, "D": d, "B": TP_BATCH, "S": TP_SEQ,
        "flash_fwd_ms": time_ms(lambda: at.flash_fwd(q, k, v, True),
                                iters=10),
        "flash_bwd_ms": time_ms(
            lambda: at.flash_bwd(q, k, v, o, lse, do, True), iters=10),
        "sdpa_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
        "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, iters=10),
        "flash_fwd_bound_ms": fwd_bound, "flash_fwd_bound_by": fwd_by,
        "flash_bwd_bound_ms": bwd_bound, "flash_bwd_bound_by": bwd_by}


def _tp_graph(config, weights, x, dout, cos, sin, tensor=None):
    """Forward and backward of one layer on fresh leaf copies: whole
    (``tensor`` None) or as ``tensor`` ranks' halves on their shards in
    rank order, the partials summed where the all-reduce stands. Returns
    (output, input gradient, {leaf: gradient})."""
    from mlrun_tpu_torch.models.llama import (
        _layer_body,
        attention_half,
        mlp_half,
    )
    from mlrun_tpu_torch.parallel.tensor import tensor_shard

    ws = {k: w.detach().clone().requires_grad_(True)
          for k, w in weights.items()}
    xs = x.detach().clone().requires_grad_(True)
    if tensor is None:
        out = _layer_body(config, xs, ws, cos, sin)
    else:
        shards = [{k: tensor_shard(k, w, t, tensor) for k, w in ws.items()}
                  for t in range(tensor)]
        partial = None
        for t in range(tensor):
            part = attention_half(config, xs, shards[t], cos, sin)
            partial = part if partial is None else partial + part
        mid = xs + partial
        partial = None
        for t in range(tensor):
            part = mlp_half(config, mid, shards[t])
            partial = part if partial is None else partial + part
        out = mid + partial
    out.backward(dout)
    return out.detach(), xs.grad, {k: w.grad for k, w in ws.items()}


def _par_tensor_leg(seed: int, card: str) -> dict:
    """(a) One Llama-3-8B-width layer (B 1, S 2048) on ``tensor`` ranks in
    turn: each rank's attention half and MLP half on its shards, the
    partials summed in rank order where the all-reduce stands, one
    autograd graph for forward and backward, held against the unsharded
    layer the way the train phase holds the flash path: in bf16 (the
    counted run) the norms of the output, the input gradient and every
    shard's gradient against the full gradient's slice within
    TRAIN_LEAF_NORM_REL_TOL; in float32, where the two differ in
    summation order only, each one's relative error within
    TRAIN_F32_LEAF_REL_TOL. Each rank's flash at its local head counts
    is timed beside SDPA."""
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, normal_init
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.ops.rotary import rope_table
    from mlrun_tpu_torch.parallel.tensor import check_divisible, tensor_shard

    config = MODEL_PRESETS["llama3-8b"]()
    config32 = MODEL_PRESETS["llama3-8b"](dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    normal = normal_init(gen, "cuda", config.dtype)
    e, h, kv, m = (config.embed_dim, config.qkv_dim, config.kv_dim,
                   config.mlp_dim)
    ones = torch.ones((e,), dtype=config.dtype, device="cuda")
    weights = {"attn_norm_scale": ones, "wq": normal(e, (e, h)),
               "wk": normal(e, (e, kv)), "wv": normal(e, (e, kv)),
               "wo": normal(h, (h, e)), "mlp_norm_scale": ones.clone(),
               "w_gate": normal(e, (e, m)), "w_up": normal(e, (e, m)),
               "w_down": normal(m, (m, e))}
    x = torch.randn((TP_BATCH, TP_SEQ, e), generator=gen,
                    device="cuda").to(config.dtype)
    dout = torch.randn(x.shape, generator=gen,
                       device="cuda").to(config.dtype)
    cos, sin = rope_table(torch.arange(TP_SEQ, device="cuda"),
                          config.head_dim, config.rope_theta)
    weights32 = {k: w.float() for k, w in weights.items()}
    full = _tp_graph(config, weights, x, dout, cos, sin)
    full32 = _tp_graph(config32, weights32, x.float(), dout.float(), cos,
                       sin)

    def gaps(got, ref, tensor, measure):
        out = {"out": measure(got[0], ref[0]), "dx": measure(got[1], ref[1])}
        for name in weights:
            out[name] = max(measure(tensor_shard(name, got[2][name], t,
                                                 tensor),
                                    tensor_shard(name, ref[2][name], t,
                                                 tensor))
                            for t in range(tensor))
        return out

    def norm_gap(a, b):
        return abs(float(a.float().norm()) / float(b.float().norm()) - 1.0)

    launches = {name: 0 for name in TRAINING_KERNELS}
    for tensor in TP_SIZES:
        check_divisible(config, tensor)
        # -- the ranks' halves, counted: every count reset right before --
        _build.reset_launch_counts()
        sharded = _tp_graph(config, weights, x, dout, cos, sin, tensor)
        torch.cuda.synchronize()
        counted = _build.launch_counts()
        want = {"flash_fwd": tensor, "flash_bwd": tensor}
        _exact_launches(f"parallel tensor={tensor}", counted, want)
        sharded32 = _tp_graph(config32, weights32, x.float(), dout.float(),
                              cos, sin, tensor)
        norms = gaps(sharded, full, tensor, norm_gap)
        rel = gaps(sharded, full, tensor, _rel)
        rel32 = gaps(sharded32, full32, tensor, _rel)
        row = {"phase": "parallel", "leg": "tensor", "card": card,
               "model": "llama3-8b layer", "tensor": tensor,
               "bf16_norm_rel_errs": norms,
               "bf16_norm_rel_tol": TRAIN_LEAF_NORM_REL_TOL,
               "bf16_rel_errs": rel, "f32_rel_errs": rel32,
               "f32_rel_tol": TRAIN_F32_LEAF_REL_TOL, "launches": counted,
               "expected_launches": want,
               "per_rank": _local_head_times(config, tensor, gen)}
        emit(row)
        for errs, tol, what in ((norms, TRAIN_LEAF_NORM_REL_TOL, "bf16 norm"),
                                (rel32, TRAIN_F32_LEAF_REL_TOL, "f32")):
            worst = max(errs, key=errs.get)
            if not errs[worst] <= tol:
                fail(f"parallel tensor={tensor}: {worst} {what} relative "
                     f"error {errs[worst]} > {tol}")
        for name in TRAINING_KERNELS:
            launches[name] += counted[name]
        del sharded, sharded32
        _release()
    return launches


# (b) Llama-3.2-1B as GPipe stages in one process
PP_STAGES, PP_MICRO = 4, 4


def _par_pipe_leg(seed: int, card: str) -> dict:
    """(b) The full Llama-3.2-1B (16 layers) as 4 stages of 4 layers, 4
    microbatches of the train phase's batch, run in the GPipe order in
    this process (a LocalLink stands where the send / recv would), held
    against the unpipelined loss_fn on the same weights and batch: the
    loss within TRAIN_LOSS_REL_TOL, the global gradient norm within
    TRAIN_GRAD_NORM_REL_TOL and every leaf's within
    TRAIN_LEAF_NORM_REL_TOL; stage times by CUDA events."""
    import torch

    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.parallel.pipeline import (
        LocalLink,
        Stage,
        run_in_process,
        split_layers_for_stages,
    )
    from mlrun_tpu_torch.training.data import synthetic_token_stream
    from mlrun_tpu_torch.training.train import tree_leaves

    config = MODEL_PRESETS["llama3-1b"]()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(config, gen, "cuda")
    tokens, targets = (torch.from_numpy(a).to("cuda") for a in next(
        synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ, config.vocab_size,
                               seed=seed)))
    names = _leaf_names(params)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loss, _ = llama.loss_fn(config, params, tokens, targets,
                            loss_chunk=LOSS_CHUNK)
    ref = dict(zip(names, torch.autograd.grad(loss, leaves)))
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    split = split_layers_for_stages(
        {k: w.detach() for k, w in params["layers"].items()}, PP_STAGES)
    link = LocalLink()
    stages, views, events = [], [], []
    for p in range(PP_STAGES):
        view = {k: w.detach().requires_grad_(True)
                for k, w in params.items() if k != "layers"}
        view["layers"] = {k: w[p].requires_grad_(True)
                          for k, w in split.items()}
        stage = Stage(config, view, tokens, targets, p, PP_STAGES, PP_MICRO,
                      link, LOSS_CHUNK)
        timed = {"fwd": [], "bwd": []}
        for kind in timed:
            stage_fn = getattr(stage, "forward" if kind == "fwd"
                               else "backward")

            def run(m, stage_fn=stage_fn, marks=timed[kind]):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                stage_fn(m)
                b.record()
                marks.append((a, b))

            setattr(stage, "forward" if kind == "fwd" else "backward", run)
        stages.append(stage)
        views.append(view)
        events.append(timed)
    del params, leaves
    # -- the stages, counted: every count reset right before them ---------
    _build.reset_launch_counts()
    start.record()
    run_in_process(stages, PP_MICRO)
    end.record()
    torch.cuda.synchronize()
    counted = _build.launch_counts()
    per_pass = config.n_layers * PP_MICRO
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    sums = sum(stage.sums() for stage in stages)
    got_loss = float(sums[0] / sums[2])
    grads = {}
    for name in ref:
        key = name.split(".")[-1]
        if name.startswith("layers."):
            grads[name] = torch.cat([v["layers"][key].grad for v in views])
        elif key == "embedding":
            grads[name] = views[0][key].grad + views[-1][key].grad
        else:
            grads[name] = views[-1][key].grad
    norm = lambda gs: float(torch.sqrt(sum(  # noqa: E731
        torch.sum(g.float() * g.float()) for g in gs)))
    ref_norm, got_norm = norm(ref.values()), norm(grads.values())
    leaf_rel = {name: abs(norm([grads[name]]) - norm([g])) / norm([g])
                for name, g in ref.items()}
    row = {"phase": "parallel", "leg": "pipe", "card": card,
           "model": "llama3-1b", "layers": config.n_layers,
           "stages": PP_STAGES, "microbatches": PP_MICRO,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": "bf16",
           "loss_pipelined": got_loss, "loss_unpipelined": float(loss),
           "loss_rel_err": abs(got_loss - float(loss)) / abs(float(loss)),
           "grad_norm_pipelined": got_norm, "grad_norm_unpipelined": ref_norm,
           "grad_norm_rel_err": abs(got_norm - ref_norm) / ref_norm,
           "leaf_norm_rel_err_max": max(leaf_rel.values()),
           "leaf_rel_err": {name: _rel(grads[name], g)
                            for name, g in ref.items()},
           "handoffs": link.handoffs, "launches": counted,
           "expected_launches": want,
           "stage_fwd_ms": [sum(a.elapsed_time(b) for a, b in t["fwd"])
                            for t in events],
           "stage_bwd_ms": [sum(a.elapsed_time(b) for a, b in t["bwd"])
                            for t in events],
           "pipeline_ms": start.elapsed_time(end),
           "unpipelined_fwd_bwd_ms": plain_ms,
           "note": "the stages run one after another in one process, so "
                   "the fill/drain bubble is not observable here"}
    emit(row)
    _exact_launches("parallel pipe", counted, want)
    if not row["loss_rel_err"] <= TRAIN_LOSS_REL_TOL:
        fail(f"parallel pipe: loss {got_loss} vs {float(loss)}")
    if not row["grad_norm_rel_err"] <= TRAIN_GRAD_NORM_REL_TOL:
        fail(f"parallel pipe: grad norm {got_norm} vs {ref_norm}")
    if not row["leaf_norm_rel_err_max"] <= TRAIN_LEAF_NORM_REL_TOL:
        fail(f"parallel pipe: leaf gradient norms {leaf_rel}")
    del stages, views, grads, ref
    _release()
    return counted


# (c) the per-layer-gather step at world size 1
W1_MESH = {"data": 1, "fsdp": 1, "tensor": 1}
W1_STEPS = 2


def _par_world1_leg(seed: int, card: str) -> dict:
    """(c) Trainer.fit at Llama-3.2-1B for 2 steps on {"data": 1, "fsdp":
    1, "tensor": 1} (the per-layer-gather step) against no mesh, and
    the whole-gather sharded step (every leaf gathered for the step, each
    gradient reduced once: make_loss_step on the same mesh): losses and
    norms bit-equal, each run's torch.cuda.max_memory_allocated."""
    import torch

    from mlrun_tpu_torch.models import llama
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.parallel.sharding import shard_pytree
    from mlrun_tpu_torch.training import TrainConfig
    from mlrun_tpu_torch.training.data import synthetic_token_stream
    from mlrun_tpu_torch.training.train import make_loss_step, make_optimizer

    config = MODEL_PRESETS["llama3-1b"]()
    stream = synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ, config.vocab_size,
                                    seed=seed)
    batches = [next(stream) for _ in range(W1_STEPS)]
    per_pass = config.n_layers * W1_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    runs = {}
    for leg, shape in (("no_mesh", None), ("per_layer", W1_MESH)):
        trainer = _par_trainer(config, shape, seed)
        run = _counted_fit(trainer, batches, TRAIN_BATCH, TRAIN_SEQ, want,
                           f"parallel world size 1 {leg}")
        history = run.pop("history")
        runs[leg] = {"losses": [h["loss"] for h in history],
                     "grad_norms": [h["grad_norm"] for h in history],
                     **run}
        del trainer, history
        _release()
    # the whole-gather step on the same mesh, seed and batches
    mesh = make_mesh(W1_MESH, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = shard_pytree(llama.init_params(config, gen, "cuda"), mesh)
    optimizer = make_optimizer(TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=PAR_STEPS))
    opt_state = optimizer.init(params)

    def loss(p, tokens, targets):
        return llama.loss_fn(config, p, tokens, targets,
                             loss_chunk=LOSS_CHUNK)

    step = make_loss_step(loss, optimizer, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []
    for tokens, targets in batches:
        params, opt_state, metrics = step(
            params, opt_state, *(torch.from_numpy(a).to("cuda")
                                 for a in (tokens, targets)))
        history.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    torch.cuda.synchronize()
    runs["whole_gather"] = {"losses": [a for a, _ in history],
                            "grad_norms": [b for _, b in history],
                            "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, opt_state, step
    _release()
    plain = runs["no_mesh"]
    row = {"phase": "parallel", "leg": "world_size_1", "card": card,
           "model": "llama3-1b", "mesh": W1_MESH, "steps": W1_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "bit_equal": {leg: r["losses"] == plain["losses"]
                         and r["grad_norms"] == plain["grad_norms"]
                         for leg, r in runs.items()},
           "losses": {leg: r["losses"] for leg, r in runs.items()},
           "max_memory_allocated_gib": {leg: r["peak_bytes"] / 2 ** 30
                                        for leg, r in runs.items()},
           "launches": runs["per_layer"]["launches"],
           "expected_launches": want}
    emit(row)
    if not all(row["bit_equal"].values()):
        fail(f"parallel world size 1: losses {row['losses']} differ")
    return runs["per_layer"]["launches"]


# (d) MoE at Mixtral-8x7B width on an expert axis
MOE_MESH = {"expert": 1, "fsdp": 1}
MOE_STEPS = 2
MOE_EP_SIZES = (2, 4, 8)


def _par_moe_mesh_leg(seed: int, card: str) -> dict:
    """(d) Trainer.fit with moe_experts=8 at Mixtral-8x7B width (depth
    FAM_MOE_LAYERS, B 4 x 2048) for 2 steps on {"expert": 1, "fsdp": 1}
    (the MoE mesh step, make_moe_rules placements) against no mesh:
    losses, aux losses and grad norms bit-equal, each run's peak memory,
    the flash launched the counted times on the mesh run."""
    from mlrun_tpu_torch.models.moe import mixtral_8x7b_like
    from mlrun_tpu_torch.training.data import synthetic_token_stream

    config = mixtral_8x7b_like(n_layers=FAM_MOE_LAYERS)
    stream = synthetic_token_stream(FAM_MOE_BATCH, FAM_MOE_SEQ,
                                    config.vocab_size, seed=seed)
    batches = [next(stream) for _ in range(MOE_STEPS)]
    want = {"flash_fwd": 2 * FAM_MOE_LAYERS * MOE_STEPS,
            "flash_bwd": FAM_MOE_LAYERS * MOE_STEPS}
    runs = {}
    for leg, shape in (("no_mesh", None), ("expert_mesh", MOE_MESH)):
        trainer = _par_trainer(config, shape, seed, total_steps=MOE_STEPS,
                               moe_experts=8, moe_top_k=2)
        run = _counted_fit(trainer, batches, FAM_MOE_BATCH, FAM_MOE_SEQ,
                           want, f"parallel moe {leg}")
        history = run.pop("history")
        runs[leg] = {key: [h[key] for h in history]
                     for key in ("loss", "aux_loss", "grad_norm")}
        runs[leg].update(run, step_ms=[FAM_MOE_BATCH * FAM_MOE_SEQ
                                       / h["tokens_per_sec"] * 1e3
                                       for h in history[1:]])
        if shape is not None:
            gate = trainer.state.params["layers"]["experts_gate"]
            runs[leg]["experts_gate_placements"] = [str(p) for p in
                                                    gate.placements]
        del trainer, history
        _release()
    plain, mesh = runs["no_mesh"], runs["expert_mesh"]
    equal = all(plain[k] == mesh[k] for k in ("loss", "aux_loss",
                                               "grad_norm"))
    row = {"phase": "parallel", "leg": "moe_expert_mesh", "card": card,
           "model": "mixtral-8x7b", "layers": FAM_MOE_LAYERS,
           "mesh": MOE_MESH, "steps": MOE_STEPS, "batch": FAM_MOE_BATCH,
           "seq": FAM_MOE_SEQ, "bit_equal": equal,
           "runs": {leg: {k: v for k, v in r.items() if k != "peak_bytes"}
                    for leg, r in runs.items()},
           "max_memory_allocated_gib": {leg: r["peak_bytes"] / 2 ** 30
                                        for leg, r in runs.items()},
           "launches": mesh["launches"], "expected_launches": want}
    emit(row)
    if not equal:
        fail(f"parallel moe: the expert mesh's run {mesh} differs from no "
             f"mesh's {plain}")
    return mesh["launches"]


def _ep_graph(config, weights, x, dout, ranks=None):
    """Forward and backward of one layer's expert MLP on fresh leaf
    copies: whole (``_moe_mlp``) or as ``ranks`` expert ranks' bodies on
    the full rows (each its n_experts / ranks experts), the float32
    partials summed in rank order where the group's sum stands. Returns
    (output, input gradient, {leaf: gradient}, ms)."""
    import torch

    from mlrun_tpu_torch.models.moe import (
        EXPERT_LEAVES,
        _moe_mlp,
        expert_partial,
        route,
    )

    ws = {k: w.detach().clone().requires_grad_(True)
          for k, w in weights.items()}
    xs = x.detach().clone().requires_grad_(True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    if ranks is None:
        out, _ = _moe_mlp(config, xs, ws)
    else:
        dispatch, combine, _ = route(config, xs, ws["router"])
        per = config.n_experts // ranks
        total = None
        for r in range(ranks):
            lo, hi = r * per, (r + 1) * per
            part = expert_partial(xs, dispatch[:, :, lo:hi],
                                  combine[:, :, lo:hi],
                                  *(ws[name][lo:hi] for name in EXPERT_LEAVES))
            total = part if total is None else total + part
        out = total.to(x.dtype)
    out.backward(dout)
    end.record()
    torch.cuda.synchronize()
    return (out.detach(), xs.grad, {k: w.grad for k, w in ws.items()},
            start.elapsed_time(end))


def _par_expert_leg(seed: int, card: str) -> dict:
    """(d) One Mixtral-8x7B-width layer's expert MLP (B 4 x 2048, 8
    experts, top 2) as the bodies of 2, 4 and 8 expert ranks in this
    process against the unsharded ``_moe_mlp``: in bf16 the norms of the
    output, the input gradient, the router's gradient and every rank's
    shard of each expert leaf's gradient within TRAIN_LEAF_NORM_REL_TOL;
    in float32 their relative errors within TRAIN_F32_LEAF_REL_TOL. The
    bytes of one rank's expert leaves a layer (and at full depth)."""
    import torch

    from mlrun_tpu_torch.models.moe import EXPERT_LEAVES, mixtral_8x7b_like

    config = mixtral_8x7b_like(n_layers=1)
    config32 = mixtral_8x7b_like(n_layers=1, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e, m, E = config.embed_dim, config.mlp_dim, config.n_experts

    def normal(fan_in, shape, dtype=config.dtype):
        return (torch.randn(shape, generator=gen, device="cuda")
                * fan_in ** -0.5).to(dtype)

    weights = {"router": normal(e, (e, E), torch.float32),
               "experts_gate": normal(e, (E, e, m)),
               "experts_up": normal(e, (E, e, m)),
               "experts_down": normal(m, (E, m, e))}
    x = torch.randn((FAM_MOE_BATCH, FAM_MOE_SEQ, e), generator=gen,
                    device="cuda").to(config.dtype)
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(config.dtype)
    full = _ep_graph(config, weights, x, dout)

    def norm_gap(a, b):
        return abs(float(a.float().norm()) / float(b.float().norm()) - 1.0)

    def gaps(got, ref, ranks, measure):
        out = {"out": measure(got[0], ref[0]), "dx": measure(got[1], ref[1]),
               "router": measure(got[2]["router"], ref[2]["router"])}
        per = E // ranks
        for name in EXPERT_LEAVES:
            out[name] = max(measure(got[2][name][r * per:(r + 1) * per],
                                    ref[2][name][r * per:(r + 1) * per])
                            for r in range(ranks))
        return out

    rows = {}
    for ranks in MOE_EP_SIZES:
        sharded = _ep_graph(config, weights, x, dout, ranks)
        norms = gaps(sharded, full, ranks, norm_gap)
        del sharded
        _release()
        rows[ranks] = {"bf16_norm_rel_errs": norms}
    full_ms = full[3]
    del full
    _release()
    weights32 = {k: w.float() for k, w in weights.items()}
    del weights
    _release()
    full32 = _ep_graph(config32, weights32, x.float(), dout.float())
    for ranks in MOE_EP_SIZES:
        sharded32 = _ep_graph(config32, weights32, x.float(), dout.float(),
                              ranks)
        rows[ranks]["f32_rel_errs"] = gaps(sharded32, full32, ranks, _rel)
        rows[ranks]["f32_ms"] = sharded32[3]
        del sharded32
        _release()
    layer_bytes = 3 * e * m * 2   # one expert's gate, up and down in bf16
    for ranks, row in rows.items():
        row.update(
            {"phase": "parallel", "leg": "expert_ranks", "card": card,
             "model": "mixtral-8x7b layer", "expert_ranks": ranks,
             "experts_per_rank": E // ranks, "batch": FAM_MOE_BATCH,
             "seq": FAM_MOE_SEQ,
             "bf16_norm_rel_tol": TRAIN_LEAF_NORM_REL_TOL,
             "f32_rel_tol": TRAIN_F32_LEAF_REL_TOL,
             "rank_expert_bytes_per_layer": layer_bytes * E // ranks,
             "rank_expert_bytes_32_layers": 32 * layer_bytes * E // ranks,
             "unsharded_f32_fwd_bwd_ms": full32[3]})
        emit(row)
        for errs, tol, what in ((row["bf16_norm_rel_errs"],
                                 TRAIN_LEAF_NORM_REL_TOL, "bf16 norm"),
                                (row["f32_rel_errs"], TRAIN_F32_LEAF_REL_TOL,
                                 "f32")):
            worst = max(errs, key=errs.get)
            if not errs[worst] <= tol:
                fail(f"parallel expert ranks={ranks}: {worst} {what} "
                     f"relative error {errs[worst]} > {tol}")
    emit({"phase": "parallel", "leg": "expert_ranks", "card": card,
          "unsharded_bf16_fwd_bwd_ms": full_ms})
    del full32, weights32
    _release()
    return {name: 0 for name in TRAINING_KERNELS}


# (e) the families' sharded steps at world size 1
FAM_W1_MESH = {"data": 1, "fsdp": 1, "tensor": 1}
FAM_W1_STEPS = 2


def _par_families_leg(seed: int, card: str) -> dict:
    """(e) BERT-base's classifier, ViT-B/16 and T5-base, each 2 steps of
    its sharded step on {"data": 1, "fsdp": 1, "tensor": 1} (plain trees
    placed by the step) against its no-mesh step from the same params and
    batch: losses (and grad norms) bit-equal; the flash launched the
    counted times on the sharded runs (T5's biased attention is plain)."""
    import torch

    from mlrun_tpu_torch.models import bert, t5, vit
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.training.train import AdamW, tree_map

    mesh = make_mesh(FAM_W1_MESH, "cuda")
    launches = {name: 0 for name in TRAINING_KERNELS}
    for leg in ("bert", "vit", "t5"):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if leg == "bert":
            config, make = bert.bert_base(), bert.make_classifier_train_step
            b, s = FAM_BERT_BATCH, FAM_BERT_SEQ
            batch = (torch.randint(0, config.vocab_size, (b, s),
                                   generator=gen, device="cuda"),
                     torch.randint(0, config.n_classes, (b,), generator=gen,
                                   device="cuda"),
                     torch.ones((b, s), dtype=torch.int32, device="cuda"))
            params = bert.init_params(config, gen, "cuda")
            want = {"flash_fwd": config.n_layers * FAM_W1_STEPS,
                    "flash_bwd": config.n_layers * FAM_W1_STEPS}
        elif leg == "vit":
            config, make = vit.vit_b16(), vit.make_train_step
            batch = (torch.randn((FAM_VIT_BATCH, config.image_size,
                                  config.image_size, config.channels),
                                 generator=gen, device="cuda"),
                     torch.randint(0, config.n_classes, (FAM_VIT_BATCH,),
                                   generator=gen, device="cuda"))
            params = vit.init_params(config, gen, "cuda")
            want = {"flash_fwd": 2 * config.n_layers * FAM_W1_STEPS,
                    "flash_bwd": config.n_layers * FAM_W1_STEPS}
        else:
            config, make = t5.t5_base(), t5.make_train_step
            batch = tuple(torch.randint(0, config.vocab_size, (FAM_T5_BATCH, n),
                                        generator=gen, device="cuda")
                          for n in (FAM_T5_ENC, FAM_T5_DEC, FAM_T5_DEC))
            params = t5.init_params(config, gen, "cuda")
            want = {}
        runs = {}
        for key, on_mesh in (("no_mesh", None), ("mesh", mesh)):
            optimizer = AdamW(lambda count: FAM_LR, b1=0.9, b2=0.999,
                              weight_decay=0.01)
            start = tree_map(torch.clone, params)
            step = make(config, optimizer, on_mesh)
            state = optimizer.init(start)
            torch.cuda.synchronize()
            # -- the leg's path, counted: every count reset right before it
            _build.reset_launch_counts()
            ms, history = _timed_steps(step, start, state, batch,
                                       FAM_W1_STEPS)
            runs[key] = {"losses": [h["loss"] for h in history],
                         "grad_norms": [h.get("grad_norm")
                                        for h in history],
                         "step_ms": ms, "launches": _build.launch_counts()}
            del start, state, step
            _release()
        equal = all(runs["mesh"][k] == runs["no_mesh"][k]
                    for k in ("losses", "grad_norms"))
        row = {"phase": "parallel", "leg": f"family_{leg}", "card": card,
               "mesh": FAM_W1_MESH, "steps": FAM_W1_STEPS,
               "bit_equal": equal, "runs": runs, "expected_launches": want}
        emit(row)
        _exact_launches(f"parallel family {leg}", runs["mesh"]["launches"],
                        want)
        if not equal:
            fail(f"parallel family {leg}: the sharded step's run "
                 f"{runs['mesh']} differs from no mesh's {runs['no_mesh']}")
        for name in TRAINING_KERNELS:
            launches[name] += runs["mesh"]["launches"][name]
        del params, batch
        _release()
    return launches


# (f) LoRA rank 16 on the tensor axis
LORA_TP_RANK = 16
LORA_W1_STEPS = 2


def _lora_graph(config, weights, lora, x, dout, cos, sin, tensor=None):
    """Forward and backward of one layer with a LoRA adapter on a frozen
    base, on fresh adapter copies: whole or as ``tensor`` ranks' halves
    (each on its base shards and its adapter half) in rank order, the
    partials summed where the all-reduce stands. Returns (output, input
    gradient, {target.leaf: adapter gradient})."""
    from mlrun_tpu_torch.models.llama import (
        _layer_body,
        attention_half,
        mlp_half,
    )
    from mlrun_tpu_torch.parallel.tensor import adapter_half, tensor_shard

    ls = {t: {k: v.detach().clone().requires_grad_(True)
              for k, v in parts.items()} for t, parts in lora.items()}
    xs = x.detach().clone().requires_grad_(True)
    if tensor is None:
        out = _layer_body(config, xs, weights, cos, sin, ls)
    else:
        halves = [({k: tensor_shard(k, w, t, tensor)
                    for k, w in weights.items()},
                   {target: adapter_half(target, parts, t, tensor)
                    for target, parts in ls.items()})
                  for t in range(tensor)]
        partial = None
        for shards, adapter in halves:
            part = attention_half(config, xs, shards, cos, sin, adapter)
            partial = part if partial is None else partial + part
        mid = xs + partial
        partial = None
        for shards, adapter in halves:
            part = mlp_half(config, mid, shards, adapter)
            partial = part if partial is None else partial + part
        out = mid + partial
    out.backward(dout)
    return out.detach(), xs.grad, {f"{t}.{k}": v.grad
                                   for t, parts in ls.items()
                                   for k, v in parts.items()}


def _par_lora_tensor_leg(seed: int, card: str) -> dict:
    """(f) One Llama-3-8B-width layer (B 1 x 2048) with a rank-16 adapter
    on wq/wk/wv/wo (B nonzero) as 2 and 8 tensor ranks' halves against
    the unsharded adapted layer: bf16 norms of the output, the input
    gradient and every adapter factor's gradient within
    TRAIN_LEAF_NORM_REL_TOL, float32 relative errors of all of them and
    of the per-layer ``scaling`` gradients within TRAIN_F32_LEAF_REL_TOL;
    one flash forward and backward a rank. A ``scaling`` gradient is one
    scalar, a sum of a whole projection's cancelling products that bf16
    rounds once per rank's partial, so its bf16 gap is reported and held
    in float32 only."""
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, normal_init
    from mlrun_tpu_torch.models.lora import init_lora_nonzero
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.ops.rotary import rope_table

    config = MODEL_PRESETS["llama3-8b"](n_layers=1)
    config32 = MODEL_PRESETS["llama3-8b"](n_layers=1, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    normal = normal_init(gen, "cuda", config.dtype)
    e, h, kv, m = (config.embed_dim, config.qkv_dim, config.kv_dim,
                   config.mlp_dim)
    ones = torch.ones((e,), dtype=config.dtype, device="cuda")
    weights = {"attn_norm_scale": ones, "wq": normal(e, (e, h)),
               "wk": normal(e, (e, kv)), "wv": normal(e, (e, kv)),
               "wo": normal(h, (h, e)), "mlp_norm_scale": ones.clone(),
               "w_gate": normal(e, (e, m)), "w_up": normal(e, (e, m)),
               "w_down": normal(m, (m, e))}
    lora = {t: {k: v[0] for k, v in parts.items()}
            for t, parts in init_lora_nonzero(
                config, gen, rank=LORA_TP_RANK, device="cuda").items()}
    x = torch.randn((TP_BATCH, TP_SEQ, e), generator=gen,
                    device="cuda").to(config.dtype)
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(config.dtype)
    cos, sin = rope_table(torch.arange(TP_SEQ, device="cuda"),
                          config.head_dim, config.rope_theta)
    weights32 = {k: w.float() for k, w in weights.items()}
    full = _lora_graph(config, weights, lora, x, dout, cos, sin)
    full32 = _lora_graph(config32, weights32, lora, x.float(), dout.float(),
                         cos, sin)

    def norm_gap(a, b):
        return abs(float(a.float().norm()) / float(b.float().norm()) - 1.0)

    def gaps(got, ref, measure):
        out = {"out": measure(got[0], ref[0]), "dx": measure(got[1], ref[1])}
        out.update({k: measure(g, ref[2][k]) for k, g in got[2].items()})
        return out

    launches = {name: 0 for name in TRAINING_KERNELS}
    for tensor in TP_SIZES:
        _build.reset_launch_counts()
        sharded = _lora_graph(config, weights, lora, x, dout, cos, sin,
                              tensor)
        torch.cuda.synchronize()
        counted = _build.launch_counts()
        want = {"flash_fwd": tensor, "flash_bwd": tensor}
        _exact_launches(f"parallel lora tensor={tensor}", counted, want)
        sharded32 = _lora_graph(config32, weights32, lora, x.float(),
                                dout.float(), cos, sin, tensor)
        norms = gaps(sharded, full, norm_gap)
        row = {"phase": "parallel", "leg": "lora_tensor", "card": card,
               "model": "llama3-8b layer", "tensor": tensor,
               "lora_rank": LORA_TP_RANK,
               "bf16_norm_rel_errs": {k: v for k, v in norms.items()
                                      if not k.endswith(".scaling")},
               "bf16_scaling_norm_rel_errs": {
                   k: v for k, v in norms.items() if k.endswith(".scaling")},
               "bf16_norm_rel_tol": TRAIN_LEAF_NORM_REL_TOL,
               "f32_rel_errs": gaps(sharded32, full32, _rel),
               "f32_rel_tol": TRAIN_F32_LEAF_REL_TOL, "launches": counted,
               "expected_launches": want}
        emit(row)
        for errs, tol, what in ((row["bf16_norm_rel_errs"],
                                 TRAIN_LEAF_NORM_REL_TOL, "bf16 norm"),
                                (row["f32_rel_errs"], TRAIN_F32_LEAF_REL_TOL,
                                 "f32")):
            worst = max(errs, key=errs.get)
            if not errs[worst] <= tol:
                fail(f"parallel lora tensor={tensor}: {worst} {what} "
                     f"relative error {errs[worst]} > {tol}")
        for name in TRAINING_KERNELS:
            launches[name] += counted[name]
        del sharded, sharded32
        _release()
    del full, full32, weights, weights32
    _release()
    return launches


def _par_lora_world1_leg(seed: int, card: str) -> dict:
    """(f) A rank-16 LoRA adapter on the frozen Llama-3.2-1B, 2 steps on
    {"tensor": 1} against no mesh: losses and norms bit-equal."""
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.training.data import synthetic_token_stream

    config = MODEL_PRESETS["llama3-1b"]()
    stream = synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ, config.vocab_size,
                                    seed=seed)
    batches = [next(stream) for _ in range(LORA_W1_STEPS)]
    per_pass = config.n_layers * LORA_W1_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    runs = {}
    for leg, shape in (("no_mesh", None), ("tensor_mesh", {"tensor": 1})):
        trainer = _par_trainer(config, shape, seed,
                               total_steps=LORA_W1_STEPS,
                               lora_rank=LORA_TP_RANK)
        run = _counted_fit(trainer, batches, TRAIN_BATCH, TRAIN_SEQ, want,
                           f"parallel lora {leg}")
        history = run.pop("history")
        runs[leg] = {"losses": [h["loss"] for h in history],
                     "grad_norms": [h["grad_norm"] for h in history],
                     "launches": run["launches"]}
        del trainer, history
        _release()
    equal = all(runs["no_mesh"][k] == runs["tensor_mesh"][k]
                for k in ("losses", "grad_norms"))
    emit({"phase": "parallel", "leg": "lora_world_size_1", "card": card,
          "model": "llama3-1b", "lora_rank": LORA_TP_RANK,
          "steps": LORA_W1_STEPS, "bit_equal": equal, "runs": runs,
          "expected_launches": want})
    if not equal:
        fail(f"parallel lora world size 1: {runs}")
    return runs["tensor_mesh"]["launches"]


# (g) the 1B fit fed by the native token-shard loader
LOADER_SHARDS, LOADER_SHARD_TOKENS = 2, 64 * 2 ** 20
LOADER_STEPS = 6


def _par_loader_leg(seed: int, card: str, train_step_ms, work: str) -> dict:
    """(g) The train phase's Llama-3.2-1B fit (B 4 x 2048, 6 steps) fed by
    TokenShardLoader over two uint16 shards of 64 Mi tokens each, written
    from the seed: the step time against the synthetic stream's (the
    train phase's), the loader's consumer waits after the first batch and
    its mean ring occupancy at each pull; the flash launched the counted
    times."""
    import numpy as np
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training.data import TokenShardLoader

    config = MODEL_PRESETS["llama3-1b"]()
    rng = np.random.default_rng(seed)
    started = time.perf_counter()
    paths = []
    for i in range(LOADER_SHARDS):
        path = os.path.join(work, f"tokens{i}.bin")
        rng.integers(0, min(config.vocab_size, 2 ** 16), LOADER_SHARD_TOKENS,
                     dtype=np.uint16).tofile(path)
        paths.append(path)
    write_s = time.perf_counter() - started
    loader = TokenShardLoader(paths, TRAIN_BATCH, TRAIN_SEQ, dtype="uint16",
                              seed=seed)
    pulls = []

    def watched():
        while True:
            pulls.append(loader.stats())
            yield next(loader)

    trainer = _par_trainer(config, None, seed, total_steps=LOADER_STEPS)
    trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    # -- the main path, counted: every count reset right before it --------
    _build.reset_launch_counts()
    trainer.fit(watched(), LOADER_STEPS, log_every=1)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    final = loader.stats()
    loader.close()
    history = trainer.metrics_history
    per_pass = config.n_layers * LOADER_STEPS
    want = {"flash_fwd": 2 * per_pass, "flash_bwd": per_pass}
    step_ms = TRAIN_BATCH * TRAIN_SEQ / history[-1]["tokens_per_sec"] * 1e3
    row = {"phase": "parallel", "leg": "token_shard_loader", "card": card,
           "model": "llama3-1b", "shards": LOADER_SHARDS,
           "shard_tokens": LOADER_SHARD_TOKENS, "dtype": "uint16",
           "write_s": write_s, "total_tokens": LOADER_SHARDS
           * LOADER_SHARD_TOKENS, "steps": LOADER_STEPS,
           "step_ms": step_ms, "synthetic_step_ms": train_step_ms,
           "input_wait_seconds": history[-1]["input_wait_seconds"],
           "losses": [h["loss"] for h in history],
           "consumer_waits_after_step_1": final["consumer_waits"]
           - pulls[min(1, len(pulls) - 1)]["consumer_waits"],
           "consumer_waits_total": final["consumer_waits"],
           "ring_occupancy_mean": sum(p["ring_occupancy"] for p in pulls)
           / len(pulls), "pulls": len(pulls), "loader_stats": final,
           "launches": launches, "expected_launches": want}
    emit(row)
    _exact_launches("parallel token_shard_loader", launches, want)
    if not all(math.isfinite(x) for x in row["losses"]):
        fail(f"parallel token_shard_loader: non-finite loss {row['losses']}")
    del trainer, history
    _release()
    return launches


def phase_parallel(seed: int, card: str, train_step_ms=None) -> dict:
    """The sharded step, checkpoint and per-layer-gather step, the MoE
    expert-mesh step, the families' sharded steps and a LoRA step on a
    tensor mesh at world size 1 on an NCCL group, then the ring's hops,
    one 8B layer on tensor ranks (with and without an adapter), the 1B
    model as pipeline stages, one Mixtral layer's experts as expert
    ranks, and the 1B fit on the native token-shard loader; returns the
    flash launches of every leg."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mlrun_tpu_torch.parallel.mesh import initialize_distributed

    started = time.perf_counter()
    initialize_distributed(device="cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"parallel: expected a world-size-1 NCCL group, got "
             f"{dist.get_backend()} x {dist.get_world_size()}")
    work = tempfile.mkdtemp(prefix="mlt-parallel-")
    try:
        launches = _par_sharded_leg(seed, card, train_step_ms, work)
        legs = [_par_world1_leg(seed, card), _par_moe_mesh_leg(seed, card),
                _par_families_leg(seed, card),
                _par_lora_world1_leg(seed, card)]
    finally:
        dist.destroy_process_group()
    try:
        legs += [_par_ring_leg(seed, card), _par_tensor_leg(seed, card),
                 _par_pipe_leg(seed, card), _par_expert_leg(seed, card),
                 _par_lora_tensor_leg(seed, card),
                 _par_loader_leg(seed, card, train_step_ms, work)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {name: launches[name] + sum(leg[name] for leg in legs)
                for name in TRAINING_KERNELS}
    emit({"phase": "parallel", "leg": "ulysses", "card": card,
          "note": "at world size 1 Ulysses' all-to-alls are copies and its "
                  "attention is flash_attention_mlt over the whole "
                  "sequence, the train phase's flash path: no check of "
                  "its own"})
    emit({"phase": "parallel", "leg": "elastic", "card": card,
          "note": "a reshard moves the state between meshes over "
                  "different ranks; with one card there is one rank, "
                  "so no slice can fail and leave survivors: the "
                  "elastic loop is checked over gloo ranks on the CPU "
                  "(tests/test_torch_elastic.py)"})
    emit({"phase": "parallel", "card": card, "launches": launches,
          "phase_s": time.perf_counter() - started})
    return launches


# ---------------------------------------------------------------------------
# phase 15: observe — in-process captures on the two main paths, the
# engines' sample tap, the kernel build cache, packaging and the GPU
# JobSet's environment
# ---------------------------------------------------------------------------

OBS_SERVE_STEPS = 8         # engine iterations in the serving capture
OBS_TRAIN_STEPS = 6
OBS_CAPTURED = 2            # fit steps in the training capture
OBS_ARM_STEP = 1            # armed at this step's end: step 2's tick claims
OBS_FIT_STEPS = 2           # steps of the JobSet leg's fit
OBS_FIT_LAYERS = 2          # its 1B depth (projects runs the full 1B pod)
# the port's __global__ functions by launch counter (bf16: the
# tensor-core bodies); one flash backward launch runs two kernels
TRACE_KERNELS = {
    "paged_decode": ("paged_decode_kernel",),
    "flash_fwd_cached": ("flash_fwd_tc_kernel",),
    "paged_prefill": ("paged_prefill_tc_kernel",),
    "flash_fwd": ("flash_fwd_tc_kernel",),
    "flash_bwd": ("flash_bwd_dq_tc_kernel", "flash_bwd_dkdv_tc_kernel"),
}


class _CaptureProbe:
    """Wraps the profiler's trace start and stop: the launch counts and
    the engine's decode-tick marks right after the start and right
    before the stop (both run on the claiming loop's thread, the only
    launcher), so the trace's kernel events can be held to the counted
    launches of exactly the captured window."""

    def __init__(self, engine=None):
        from mlrun_tpu_torch.ops import _build
        from mlrun_tpu_torch.utils import profiler

        self.profiler, self.build, self.engine = profiler, _build, engine
        self.start, self.stop = profiler._start_trace, profiler._stop_trace
        self.at = {}

    def _mark(self, key):
        self.at[key] = (self.build.launch_counts(), time.perf_counter(),
                        _tick_mark(self.engine) if self.engine is not None
                        else None)

    def __enter__(self):
        def start(output_dir):
            self.start(output_dir)
            self._mark("start")

        def stop():
            self._mark("stop")
            t = time.perf_counter()
            self.stop()
            self.at["stop_s"] = time.perf_counter() - t

        self.profiler._start_trace, self.profiler._stop_trace = start, stop
        return self

    def __exit__(self, *exc):
        self.profiler._start_trace = self.start
        self.profiler._stop_trace = self.stop
        return False

    def launches(self) -> dict:
        (a, _, _), (b, _, _) = self.at["start"], self.at["stop"]
        return {name: b[name] - a[name] for name in a}

    def window_s(self) -> float:
        return self.at["stop"][1] - self.at["start"][1]


def _trace_kernels(directory: str) -> dict:
    """The trace file's device-kernel events: counts of the port's
    __global__ functions, device seconds by kernel name, and the span."""
    import glob
    import re

    files = glob.glob(os.path.join(directory, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"observe: expected one trace file in {directory}, got {files}")
    with open(files[0]) as fp:
        events = json.load(fp)["traceEvents"]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    if not kernels:
        fail("observe: the trace holds no device-kernel events (CUPTI)")
    functions = {fn for fns in TRACE_KERNELS.values() for fn in fns}
    counts = dict.fromkeys(functions, 0)
    by_name: dict = {}
    for event in kernels:
        name = event.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + float(event.get("dur", 0))
        for fn in functions:
            if re.search(rf"(?<![A-Za-z_]){fn}(?![a-z_])", name):
                counts[fn] += 1
    start = min(float(e["ts"]) for e in kernels)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in kernels)
    busy_us = sum(by_name.values())
    port_us = sum(us for name, us in by_name.items()
                  if any(fn in name for fn in functions))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"file_bytes": os.path.getsize(files[0]), "counts": counts,
            "kernel_events": len(kernels), "device_busy_ms": busy_us / 1e3,
            "kernel_span_ms": (end - start) / 1e3,
            "port_kernels_ms": port_us / 1e3,
            "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top]}


def _trace_matches(leg: str, trace: dict, launches: dict, path_kernels):
    """Every path kernel launched in the window, and the trace holds each
    __global__ function exactly as often as its counters launched it."""
    want = {}
    for name in path_kernels:
        if launches.get(name, 0) <= 0:
            fail(f"observe ({leg}): kernel {name} was not launched in the "
                 "captured window")
        for fn in TRACE_KERNELS[name]:
            want[fn] = want.get(fn, 0) + launches[name]
    got = {fn: trace["counts"][fn] for fn in want}
    if got != want:
        fail(f"observe ({leg}): trace kernel events {got} != counted "
             f"launches {want}")
    return want


def _margin(row) -> float:
    import torch

    top2 = torch.topk(row.float().reshape(-1), 2).values
    return float(top2[0] - top2[1])


def _obs_serve_leg(seed: int, card: str, work: str) -> dict:
    """(a) the serve phase's server and traffic (5 requests, 32 greedy
    tokens) in four bursts on fresh prompts: a warm-up, the captured one
    (armed before the burst, the claim held to the iteration that admits
    it), one dark and one with a SampleRing observer."""
    import statistics
    import threading

    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving import samples
    from mlrun_tpu_torch.serving.llm import LLMModelServer
    from mlrun_tpu_torch.utils import profiler

    config = MODEL_PRESETS["llama3-8b"]()
    server = LLMModelServer(
        name="llama3-8b", model_preset="llama3-8b", continuous_batching=True,
        paged=True, slots=4, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, seed=seed)
    server.post_init()
    if not server.ready:
        fail(f"observe: LLMModelServer failed to load: {server.error}")
    engine = server.engine

    def traffic(offset):
        prompts = _prompts(seed + offset, config.vocab_size)
        return prompts + [prompts[0]]

    def burst(offset, hold=None):
        mark = _tick_mark(engine)
        futures = [engine.submit(p, max_new_tokens=MAX_NEW)
                   for p in traffic(offset)]
        if hold is not None:
            hold.set()
        outs = [f.result(timeout=600)[0] for f in futures]
        return outs, _tick_p50_since(engine, mark)

    try:
        burst(3)  # warm-up: first launches, allocator, cuBLAS handles
        # -- the captured burst: the loop is held after its tick, armed,
        # released; its next tick claims and is held again until the
        # burst is queued, so the window starts with the admissions
        gates = [threading.Event(), threading.Event()]
        reached = [threading.Event(), threading.Event()]
        expire = engine._expire_queued
        calls = []

        def held():
            if len(calls) < 2:
                i = len(calls)
                calls.append(i)
                reached[i].set()
                gates[i].wait(60)
            return expire()

        out_dir = os.path.join(work, "serve-trace")
        with _CaptureProbe(engine) as probe:
            engine._expire_queued = held
            reached[0].wait(60)
            # -- the main path, counted: every count reset right before it
            _build.reset_launch_counts()
            armed = profiler.arm_profile(steps=OBS_SERVE_STEPS,
                                         output_dir=out_dir)
            gates[0].set()
            reached[1].wait(60)
            claimed = profiler.profile_status()["active"]
            outs_captured, _ = burst(0, hold=gates[1])
            del engine._expire_queued
            for _ in range(600):
                if profiler.profile_status()["last"] is not None:
                    break
                time.sleep(0.05)
            torch.cuda.synchronize()
            burst_launches = _build.launch_counts()
        last = profiler.profile_status()["last"]
        if claimed is None or claimed["source"] != engine._obs_name \
                or last is None or last.get("reason") != "bound":
            fail(f"observe: the engine loop did not claim and finish the "
                 f"capture (armed {armed}, claimed {claimed}, last {last})")
        window = probe.launches()
        ticks = list(engine._tick_ring)[probe.at["start"][2]:
                                        probe.at["stop"][2]]
        trace = _trace_kernels(out_dir)
        want = _trace_matches("serve", trace, window, SERVING_KERNELS)
        _check_launches(burst_launches, SERVING_KERNELS, "observe serve")

        outs_dark, dark_p50 = burst(1)
        # -- the sample tap: every completion, margins from the same rows
        rows: list = []
        _record_first_logits(engine, rows)
        ring = samples.SampleRing()
        samples.set_sample_observer(ring.append)
        try:
            outs_sampled, sampled_p50 = burst(2)
        finally:
            samples.set_sample_observer(None)
            del engine._first_token
        got = ring.drain()
    finally:
        server.close()
    plain = sorted(_margin(row) for row in rows)
    margins = sorted(s["logit_margin"] for s in got)
    sample_tokens = sorted(s["tokens"] for s in got)
    checks = {
        "one_sample_per_completion": len(got) == len(outs_sampled) == 5,
        "sample_tokens_are_the_outputs":
            sample_tokens == sorted(outs_sampled),
        "margins_equal_plain_top2": margins == plain,
        "captured_outputs_full": all(len(t) == MAX_NEW
                                     for t in outs_captured + outs_dark),
    }
    row = {"phase": "observe", "leg": "serve", "card": card,
           "model": "llama3-8b", "layers": config.n_layers,
           "requests": 5, "max_new_tokens": MAX_NEW,
           "captured_iterations": OBS_SERVE_STEPS,
           "capture_wall_s": last["wall_s"], "window_s": probe.window_s(),
           "stop_s": probe.at["stop_s"], "window_launches": window,
           "trace_kernel_events": {fn: trace["counts"][fn] for fn in want},
           "trace": {k: trace[k] for k in (
               "file_bytes", "kernel_events", "device_busy_ms",
               "kernel_span_ms", "port_kernels_ms", "top_kernels_ms")},
           "tick_p50_captured_s": statistics.median(ticks) if ticks else None,
           "captured_ticks": len(ticks), "tick_p50_dark_s": dark_p50,
           "tick_p50_sampled_s": sampled_p50, "samples": len(got),
           "logit_margins": margins, "checks": checks}
    emit(row)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"observe (serve): {bad}")
    return burst_launches


class _StepClock:
    """A callback timing each fit step (synchronised at its end) and
    arming the capture at ``arm_at``'s end."""

    def __init__(self, arm_at: int, steps: int, output_dir: str):
        from mlrun_tpu_torch.frameworks._common import Callback

        clock = self

        class Hook(Callback):
            def on_train_begin(self):
                import torch

                torch.cuda.synchronize()
                clock.marks.append(time.perf_counter())

            def on_step_end(self, step, metrics):
                import torch

                from mlrun_tpu_torch.utils import profiler

                torch.cuda.synchronize()
                clock.marks.append(time.perf_counter())
                if step == arm_at:
                    profiler.arm_profile(steps=steps, output_dir=output_dir)

        self.marks: list = []
        self.hook = Hook()

    def step_ms(self) -> list:
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _obs_train_leg(seed: int, card: str, work: str) -> dict:
    """(b) the train phase's 1B fit (B 4 x 2048, 6 steps), a 2-step capture
    armed at step 1's end: step 2's tick claims, steps 3 and 4 are in it."""
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.data import synthetic_token_stream
    from mlrun_tpu_torch.utils import profiler

    config = MODEL_PRESETS["llama3-1b"]()
    batch = next(synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ,
                                        config.vocab_size, seed=seed))
    trainer = Trainer(config, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=OBS_TRAIN_STEPS,
        loss_chunk=LOSS_CHUNK), device="cuda")
    trainer.init(seed)
    trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    out_dir = os.path.join(work, "train-trace")
    clock = _StepClock(OBS_ARM_STEP, OBS_CAPTURED, out_dir)
    with _CaptureProbe() as probe:
        _build.reset_launch_counts()
        trainer.fit(iter([batch] * OBS_TRAIN_STEPS), OBS_TRAIN_STEPS,
                    log_every=OBS_TRAIN_STEPS, prefetch=2,
                    callbacks=[clock.hook])
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    last = profiler.profile_status()["last"]
    if last is None or last["source"] != trainer._profiler_source \
            or last["reason"] != "bound":
        fail(f"observe: fit did not claim and finish the capture: {last}")
    window = probe.launches()
    per_step = {"flash_fwd": 2 * config.n_layers,
                "flash_bwd": config.n_layers}
    if window != {name: (OBS_CAPTURED * per_step.get(name, 0))
                  for name in window}:
        fail(f"observe (train): the window launched {window}, expected "
             f"{OBS_CAPTURED} steps of {per_step}")
    trace = _trace_kernels(out_dir)
    want = _trace_matches("train", trace, window, TRAINING_KERNELS)
    _exact_launches("observe train", launches,
                    {name: OBS_TRAIN_STEPS * n for name, n in per_step.items()})
    step_ms = clock.step_ms()
    captured = [OBS_ARM_STEP + 1 + i for i in range(1, OBS_CAPTURED + 1)]
    claim = OBS_ARM_STEP + 1
    steady = [ms for i, ms in enumerate(step_ms)
              if i not in captured and i not in (0, claim)]
    row = {"phase": "observe", "leg": "train", "card": card,
           "model": "llama3-1b", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": OBS_TRAIN_STEPS, "captured_steps": captured,
           "claim_step": claim, "capture_wall_s": last["wall_s"],
           "window_s": probe.window_s(), "stop_s": probe.at["stop_s"],
           "window_launches": window,
           "trace_kernel_events": {fn: trace["counts"][fn] for fn in want},
           "trace": {k: trace[k] for k in (
               "file_bytes", "kernel_events", "device_busy_ms",
               "kernel_span_ms", "port_kernels_ms", "top_kernels_ms")},
           "step_ms": step_ms,
           "captured_step_ms": [step_ms[i] for i in captured],
           "uncaptured_step_ms": steady,
           "losses": [v["loss"] for v in trainer.metrics_history]}
    emit(row)
    del trainer
    return launches


def _cache_child(mode: str):
    """A child process of the cache leg: ``build`` builds the kernels into
    the cache dir its environment names; ``load`` loads them there with no
    nvcc reachable and launches the RMSNorm and paged decode op entry
    points against their plain versions. Prints one JSON line."""
    import shutil

    import torch

    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.ops import norms
    from mlrun_tpu_torch.ops import paged_attention as pa
    from mlrun_tpu_torch.utils import compile_cache

    cache = compile_cache.configure_from_mlconf()
    nvcc = None
    try:
        nvcc = _build.find_nvcc()
    except _build.KernelBuildError:
        pass
    torch.cuda.init()
    started = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - started
    out = {"mode": mode, "cache_dir": cache, "nvcc": nvcc,
           "nvcc_on_path": shutil.which("nvcc"), "seconds": seconds,
           "lib": str(_build._state.lib_path)}
    if mode == "load":
        gen = torch.Generator(device="cuda").manual_seed(0)
        dev, dtype = "cuda", torch.bfloat16
        x = (torch.randn((4, 2048, 4096), generator=gen, device=dev)
             * 3).to(dtype)
        scale = torch.randn((4096,), generator=gen, device=dev)
        rms = norms.rms_norm_pallas(x, scale, RMS_EPS)
        rms_ref = norms.rms_norm_pallas_plain(x, scale, RMS_EPS)
        pps = MAX_LEN // PAGE
        k_pages = (torch.randn((SLOTS * pps + 1, PAGE, HKV, D),
                               generator=gen, device=dev) * 0.5).to(dtype)
        v_pages = torch.randn((SLOTS * pps + 1, PAGE, HKV, D),
                              generator=gen, device=dev).to(dtype)
        q = torch.randn((SLOTS, H, D), generator=gen, device=dev).to(dtype)
        pos = torch.tensor(SERVE_POS, dtype=torch.int32, device=dev)
        table = torch.arange(SLOTS * pps, dtype=torch.int32,
                             device=dev).reshape(SLOTS, pps)
        dec = pa.paged_attention(q, k_pages, v_pages, table, pos,
                                 page_size=PAGE, impl="kernel")
        dec_ref = pa.paged_decode_reference(q, k_pages, v_pages, table, pos,
                                            PAGE)
        torch.cuda.synchronize()
        out.update({
            "launches": {k: v for k, v in _build.launch_counts().items()
                         if v},
            "rms_norm_within_1_ulp": bool(
                ((rms.float() - rms_ref.float()).abs()
                 <= _bf16_ulp(rms_ref)).all()),
            "paged_decode_max_abs_err": _err(dec, dec_ref),
            "paged_decode_tol": TOL["bf16"]["o"]})
    print(json.dumps(out), flush=True)


def _cache_process(mode: str, env: dict):
    code = (f"import sys; sys.path.insert(0, {HERE!r}); "
            f"import chip_smoke; chip_smoke._cache_child({mode!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _cache_result(mode: str, proc, started: float) -> dict:
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"observe (cache, {mode}): still running after 600 s (killed)")
    if proc.returncode != 0:
        fail(f"observe (cache, {mode}): exit {proc.returncode}\n"
             f"{err[-4000:]}")
    run = json.loads(out.strip().splitlines()[-1])
    run["process_s"] = time.perf_counter() - started
    return run


def _obs_cache_leg(card: str, work: str, beside) -> dict:
    """(c) two processes over one MLT_TRAINING__COMPILE_CACHE_DIR: the
    first builds (nvcc) while ``beside`` (the JobSet leg, another process
    of its own) runs, the second loads with no nvcc reachable."""
    from mlrun_tpu_torch.config import COMPILE_CACHE_ENV

    cache = os.path.join(work, "kernel-cache")
    base = dict(os.environ, **{COMPILE_CACHE_ENV: cache})
    no_nvcc = dict(base, CUDA_HOME=os.path.join(work, "no-cuda"), PATH=":".join(
        p for p in os.environ.get("PATH", "").split(":")
        if p and not os.path.exists(os.path.join(p, "nvcc"))))
    started = time.perf_counter()
    proc = _cache_process("build", base)
    try:
        beside()
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    runs = {"build": _cache_result("build", proc, started)}
    started = time.perf_counter()
    runs["load"] = _cache_result("load", _cache_process("load", no_nvcc),
                                 started)
    build, load = runs["build"], runs["load"]
    checks = {
        "built_under_the_cache": build["lib"].startswith(cache),
        "loaded_the_same_library": load["lib"] == build["lib"],
        "no_nvcc_in_the_loader": load["nvcc"] is None
        and load["nvcc_on_path"] is None,
        "both_kernels_launched": load["launches"] == {"paged_decode": 1,
                                                      "rms_norm": 1},
        "rms_norm_within_1_ulp": load["rms_norm_within_1_ulp"],
        "paged_decode_within_tol": load["paged_decode_max_abs_err"]
        <= load["paged_decode_tol"],
    }
    row = {"phase": "observe", "leg": "compile_cache", "card": card,
           "nvcc_build_s": build["seconds"], "load_s": load["seconds"],
           "build_process_s": build["process_s"],
           "build_beside": "the jobset leg's torchrun process",
           "load_process_s": load["process_s"],
           "paged_decode_max_abs_err": load["paged_decode_max_abs_err"],
           "checks": checks}
    emit(row)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"observe (cache): {bad}")
    return row


class _Recorder:
    """A duck-typed run context with no is_logging_worker."""

    def __init__(self):
        self.artifacts, self.results_calls, self.metrics = {}, 0, 0

    def log_artifact(self, key, local_path="", **kw):
        self.artifacts[key] = local_path

    def log_results(self, results):
        self.results_calls += 1

    def log_result(self, key, value):
        pass

    def log_metrics(self, metrics, step=None):
        self.metrics += 1


def _obs_package_leg(seed: int, card: str, work: str) -> dict:
    """(d) the 1B param tree (bf16) through TorchTreePackager to an .npz
    and back, bit for bit."""
    import torch

    from mlrun_tpu_torch.datastore import DataItem, store_manager
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.package.packagers import torch_packagers as tpk

    config = MODEL_PRESETS["llama3-1b"]()
    params = init_params(config, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    flat = tpk.flatten_tree(params)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    packager, context = tpk.TorchTreePackager(), _Recorder()
    started = time.perf_counter()
    packager.pack(context, params, "params")
    pack_s = time.perf_counter() - started
    path = context.artifacts["params"]
    store, sub = store_manager.get_or_create_store(path)
    started = time.perf_counter()
    back = tpk.flatten_tree(packager.unpack(DataItem("params", store, sub),
                                            dict))
    unpack_s = time.perf_counter() - started
    file_bytes = os.path.getsize(path)
    same = sorted(back) == sorted(flat) and all(
        back[name].dtype == leaf.dtype and torch.equal(
            back[name].view(torch.int16) if leaf.dtype == torch.bfloat16
            else back[name], (leaf.view(torch.int16)
                              if leaf.dtype == torch.bfloat16 else leaf).cpu())
        for name, leaf in flat.items())
    packager.cleanup()
    row = {"phase": "observe", "leg": "package", "card": card,
           "model": "llama3-1b", "leaves": len(flat), "bytes": nbytes,
           "npz_bytes": file_bytes, "pack_s": pack_s, "unpack_s": unpack_s,
           "pack_gb_per_s": nbytes / pack_s / 1e9,
           "unpack_gb_per_s": nbytes / unpack_s / 1e9, "bit_equal": same}
    emit(row)
    if not same:
        fail("observe (package): the 1B tree did not come back bit for bit")
    return row


def _jobset_child(result_path: str):
    """The JobSet leg's program under torchrun: the 1B fit (its width,
    OBS_FIT_LAYERS layers) for a few steps on {"data": 1} through
    auto_trainer.train in the NCCL group torchrun's env brings up, with a
    recording context."""
    import torch.distributed as dist

    from mlrun_tpu_torch.execution import is_logging_worker
    from mlrun_tpu_torch.frameworks.torch import auto_trainer

    context = _Recorder()
    metrics = auto_trainer.train(
        context=context, model="llama3-1b",
        model_overrides={"n_layers": OBS_FIT_LAYERS},
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=OBS_FIT_STEPS,
        mesh_shape={"data": 1}, log_every=1)
    out = {"rank": os.environ.get("RANK"),
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "logging_worker": is_logging_worker(),
           "log_results_calls": context.results_calls,
           "log_metrics_calls": context.metrics,
           "loss": metrics.get("loss"), "step": metrics.get("step")}
    dist.destroy_process_group()
    with open(result_path, "w") as fp:
        json.dump(out, fp)


def _obs_jobset_leg(card: str, work: str) -> dict:
    """(e) the env of build_jobset(nodes=1, gpus_per_node=1) on a torchrun
    launch of one process: MASTER_ADDR at 127.0.0.1 and a free port, the
    pod's field references resolved as pod 0 of slice 0."""
    import socket
    import stat

    from mlrun_tpu_torch.k8s import build_jobset

    result = os.path.join(work, "jobset-result.json")
    program = os.path.join(work, "jobset_child.py")
    with open(program, "w") as fp:
        fp.write(f"import sys\nsys.path.insert(0, {HERE!r})\n"
                 "import chip_smoke\n"
                 f"chip_smoke._jobset_child({result!r})\n")
    spec = build_jobset("observe", "default", {"containers": [{
        "name": "trainer", "image": "port", "args": [program]}]},
        gpu_product=card.split(",")[0], nodes=1, gpus_per_node=1)
    main = (spec["spec"]["replicatedJobs"][0]["template"]["spec"]
            ["template"]["spec"]["containers"][0])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    for entry in main["env"]:
        env[entry["name"]] = entry.get("value", "0")  # fieldRefs: pod 0
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # torchrun on PATH, from this interpreter's torch
    shim = os.path.join(work, "bin")
    os.makedirs(shim, exist_ok=True)
    torchrun = os.path.join(shim, "torchrun")
    with open(torchrun, "w") as fp:
        fp.write(f"#!/bin/sh\nexec {sys.executable} -m torch.distributed.run "
                 '"$@"\n')
    os.chmod(torchrun, os.stat(torchrun).st_mode | stat.S_IEXEC)
    env["PATH"] = f"{shim}:{env.get('PATH', '')}"
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(name, None)
    started = time.perf_counter()
    proc = subprocess.run(main["command"] + main["args"], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - started
    if proc.returncode != 0:
        fail(f"observe (jobset): torchrun exited {proc.returncode}\n"
             f"{proc.stderr[-4000:]}")
    with open(result) as fp:
        child = json.load(fp)
    checks = {
        "one_rank_nccl_group": child["world"] == 1
        and child["backend"] == "nccl" and child["rank"] == "0",
        "logging_worker": child["logging_worker"] is True,
        "one_log_results": child["log_results_calls"] == 1,
        "trained_the_steps": child["step"] == OBS_FIT_STEPS
        and math.isfinite(child["loss"]),
    }
    row = {"phase": "observe", "leg": "jobset", "card": card,
           "command": main["command"][:2] + ["..."],
           "env": {e["name"]: env[e["name"]] for e in main["env"]},
           "process_s": seconds, **child, "checks": checks}
    emit(row)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"observe (jobset): {bad}")
    return row


def phase_observe(seed: int, card: str) -> dict:
    """(a) a capture of the 8B paged engine's loop, the sample tap, (b) a
    capture of the 1B Trainer.fit, (c) the kernel build cache across two
    processes, (d) the 1B tree through the torch packager, (e) the GPU
    JobSet's env on a one-rank torchrun launch; returns the launches of
    the two main paths."""
    import gc
    import shutil
    import tempfile

    import torch

    started = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mlt-observe-")
    legs_s = {}
    try:
        t = time.perf_counter()
        launches = _obs_serve_leg(seed, card, work)
        legs_s["serve"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        for name, count in _obs_train_leg(seed, card, work).items():
            launches[name] = launches.get(name, 0) + count
        legs_s["train"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        _obs_package_leg(seed, card, work)
        legs_s["package"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        # the cache leg's nvcc build runs beside the JobSet leg's torchrun
        # process (both are child processes; neither leg's checks depend
        # on time)
        t = time.perf_counter()
        _obs_cache_leg(card, work, lambda: _obs_jobset_leg(card, work))
        legs_s["compile_cache_and_jobset"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "observe", "card": card, "legs_s": legs_s,
          "phase_s": time.perf_counter() - started,
          "launches": {k: launches[k] for k in SERVING_KERNELS
                       + TRAINING_KERNELS}})
    return launches


# ---------------------------------------------------------------------------
# gateway: the serving graph and its HTTP gateway over the 8B paged engine
# ---------------------------------------------------------------------------

# the serving graph in the SERVING_SPEC_ENV form the reference's
# ServingRuntime writes: a router with one route, the serve phase's paged
# engine at Llama-3-8B (native KV, bf16); phase_gateway sets the seed
GATEWAY_SPEC = {
    "function_uri": "smoke/gateway", "version": "v2", "parameters": {},
    "graph": {
        "kind": "flow", "class_args": {}, "after": [], "full_event": False,
        "responder": False, "engine": "sync",
        "steps": {"router": {
            "kind": "router", "name": "router", "class_name": "ModelRouter",
            "class_args": {}, "after": [], "full_event": False,
            "responder": True,
            "routes": {"llm": {
                "kind": "task", "name": "llm",
                "class_name": "mlrun_tpu_torch.serving.llm.LLMModelServer",
                "class_args": {
                    "name": "llm", "model_preset": "llama3-8b",
                    "continuous_batching": True, "paged": True,
                    "slots": SLOTS, "max_len": MAX_LEN, "page_size": PAGE,
                    "max_new_tokens": MAX_NEW, "kv_dtype": "native",
                    "seed": 0},
                "after": [], "full_event": False, "responder": False}}}}},
    "load_mode": "sync", "verbose": False, "graph_initializer": None,
    "error_stream": None, "track_models": None, "secret_sources": [],
    "default_content_type": None,
}
GW_INFER = "/v2/models/llm/infer"
GW_LAT_REQUESTS = 20        # (c): sequential requests, over HTTP and in process
GW_LAT_PROMPT = 16          # (c): the one prompt's tokens
GW_LAT_NEW = 4              # (c): tokens generated a request
GW_CLIENTS = 4              # (c): concurrent clients
GW_DRAIN_NEW = 64           # (e): the in-flight request's tokens a prompt
GW_TIMEOUT = 600.0
GW_TRACE = "5eed" * 8       # (d): the front request's trace id
GW_PROBED = ("/readyz", "/healthz", "/__stats__", "/metrics", "/debug/trace")


def _http(url: str, path: str, method: str = "GET", body=None,
          headers=None) -> tuple:
    """(status, lower-cased headers, body bytes, seconds) of one request
    through urllib."""
    import urllib.error
    import urllib.request

    headers = dict(headers or {})
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    request = urllib.request.Request(url + path, data=data, headers=headers,
                                     method=method)
    started = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=GW_TIMEOUT) as resp:
            status, head, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        with exc:
            status, head, raw = exc.code, exc.headers, exc.read()
    return (status, {k.lower(): v for k, v in head.items()}, raw,
            time.perf_counter() - started)


def _outputs(response, what: str) -> list:
    status, _, raw, _ = response
    if status != 200:
        fail(f"gateway: {what} answered {status}: {raw[:300]!r}")
    return json.loads(raw)["outputs"]


def _serve_app(app):
    """Serve ``app`` on 127.0.0.1, a free port, in a thread: (url, stop)."""
    import threading

    httpd = app.bind("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        app.close()

    return "http://127.0.0.1:%d" % httpd.server_address[1], stop


def _percentiles(seconds: list) -> dict:
    ordered = sorted(seconds)
    return {"p50_ms": 1000 * ordered[len(ordered) // 2],
            "p99_ms": 1000 * ordered[int(len(ordered) * 0.99)],
            "n": len(ordered)}


def _gateway_launches(launches: dict, before: dict, after: dict,
                      layers: int, path: str = "gateway") -> dict:
    """The serving kernels launched on a path's requests (the gateway's
    by default), as the
    engine's counters say: a paged decode a layer a kernel tick, a paged
    prefill a layer a prefix-hit dispatch (a chunk or its 1-token
    replay), the cached flash a layer a prefill chunk (every chunk here
    is longer than one token; a 1-token replay takes the dense form)."""
    _check_launches(launches, SERVING_KERNELS, path)
    ticks = after["attn_kernel_ticks"] - before["attn_kernel_ticks"]
    hits = after["prefill_kernel_chunks"] - before["prefill_kernel_chunks"]
    chunks = after["prefill_chunks"] - before["prefill_chunks"]
    if launches["paged_decode"] != layers * ticks:
        fail(f"{path}: paged decode launched {launches['paged_decode']} "
             f"times over {ticks} kernel ticks of {layers} layers")
    if launches["paged_prefill"] != layers * hits:
        fail(f"{path}: paged prefill launched {launches['paged_prefill']} "
             f"times over {hits} prefix-hit dispatches of {layers} layers")
    flash = launches["flash_fwd_cached"]
    if flash != layers * chunks:
        fail(f"{path}: cached flash launched {flash} times over {chunks} "
             f"prefill chunks of {layers} layers")
    return {"decode_ticks": ticks, "prefix_hit_dispatches": hits,
            "prefill_chunks": chunks}


def _metric(text: str, name: str, labels: str = "") -> float:
    """One sample of a Prometheus text exposition."""
    prefix = name + labels + " "
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line[len(prefix):].split()[0])
    fail(f"gateway: /metrics has no sample {name}{labels}")


def phase_gateway(seed: int, card: str) -> dict:
    """The serving graph (GATEWAY_SPEC, loaded through SERVING_SPEC_ENV by
    asgi.server_from_env) behind the port's standard-library HTTP gateway
    on a free localhost port, driven over HTTP by urllib clients: (a)
    /readyz at 503 with Retry-After until warm, (b) the serve traffic with
    every token held to a teacher-forced forward, its kernel launches as
    the engine counts them, (c) HTTP against in-process latency and 4
    concurrent clients on the one worker, (d) a front gateway's RemoteStep
    carrying a trace id, (e) a drain with a request in flight, (f)
    /metrics. Returns the launches of (b)."""
    import copy
    import gc
    import threading

    import torch

    from mlrun_tpu_torch.obs import PROBE_REQUESTS, REQUEST_LATENCY
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving import asgi
    from mlrun_tpu_torch.serving.server import GraphContext, GraphServer
    from mlrun_tpu_torch.serving.states import RootFlowStep

    started = time.perf_counter()
    spec = copy.deepcopy(GATEWAY_SPEC)
    spec["graph"]["steps"]["router"]["routes"]["llm"]["class_args"][
        "seed"] = seed
    previous = os.environ.get("SERVING_SPEC_ENV")
    os.environ["SERVING_SPEC_ENV"] = json.dumps(spec)
    try:
        t = time.perf_counter()
        server = asgi.server_from_env()
        load_s = time.perf_counter() - t
    finally:
        if previous is None:
            os.environ.pop("SERVING_SPEC_ENV")
        else:
            os.environ["SERVING_SPEC_ENV"] = previous
    route = server.graph.steps["router"].routes["llm"]._object
    if not route.ready:
        fail(f"gateway: the llm route failed to load: {route.error}")
    engine = route.engine
    config, params = engine.config, engine.params
    url, stop = _serve_app(asgi.build_serving_app(server))
    stop_front = None
    probes = dict.fromkeys(GW_PROBED, 0)
    probes_before = {p: PROBE_REQUESTS.value(path=p) for p in GW_PROBED}
    runs_before = REQUEST_LATENCY.value()["count"]
    graph_runs = 0          # GraphServer.run calls: the model gateway's
    # and the front gateway's (one process, one registry)

    def probe(path: str, **kwargs):
        probes["/debug/trace" if path.startswith("/debug/trace/")
               else path] += 1
        return _http(url, path, **kwargs)

    rows = []
    try:
        # -- (a) ready means warm ------------------------------------------
        server.begin_warmup()
        cold, health = probe("/readyz"), probe("/healthz")
        if cold[0] != 503 or "retry-after" not in cold[1] \
                or health[0] != 200:
            fail(f"gateway: warming readyz {cold[0]} {cold[1]}, healthz "
                 f"{health[0]}")
        t = time.perf_counter()
        warming = threading.Thread(target=server.warmup, daemon=True)
        warming.start()
        polls = 0
        while True:
            ready, health = probe("/readyz"), probe("/healthz")
            polls += 1
            if health[0] != 200:
                fail(f"gateway: healthz {health[0]} while warming")
            if ready[0] == 200:
                break
            if ready[0] != 503 or "retry-after" not in ready[1] \
                    or time.perf_counter() - t > 120:
                fail(f"gateway: readyz {ready[0]} {ready[1]} while warming")
            time.sleep(0.005)
        gate_s = time.perf_counter() - t
        warming.join(timeout=60)
        rows.append({"phase": "gateway", "leg": "ready", "card": card,
                     "load_and_engine_warmup_s": load_s,
                     "readyz_gate_s": gate_s, "readyz_polls": polls,
                     "cold_readyz": [cold[0], cold[1]["retry-after"]]})

        # -- (b) the serve traffic over HTTP, counted ------------------------
        prompts = _prompts(seed, config.vocab_size)
        before = engine.stats
        _build.reset_launch_counts()
        first = _http(url, GW_INFER, "POST", {"inputs": prompts})
        hit = _http(url, GW_INFER, "POST", {"inputs": [prompts[0]]})
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        after = engine.stats
        graph_runs += 2
        outputs = _outputs(first, "the serve request") + \
            _outputs(hit, "the prefix-hit request")
        counted = _gateway_launches(launches, before, after, config.n_layers)
        if not after["prefix_hits"] > before["prefix_hits"]:
            fail("gateway: the rerun of the first prompt missed the cache")
        gaps = []
        for prompt, tokens in zip(prompts + [prompts[0]], outputs):
            if len(tokens) != MAX_NEW:
                fail(f"gateway: {len(tokens)} tokens, expected {MAX_NEW}")
            logits = _teacher_logits(config, params, prompt, tokens)
            gaps.append(max(float(row.max() - row[tok]) /
                            float(row.abs().max())
                            for row, tok in zip(logits, tokens)))
        del logits
        rows.append({"phase": "gateway", "leg": "serve", "card": card,
                     "requests": 2, "prompt_lens": [len(p) for p in prompts]
                     + [len(prompts[0])], "max_new_tokens": MAX_NEW,
                     "request_s": [first[3], hit[3]], "launches": launches,
                     **counted, "worst_argmax_gap_rel": max(gaps),
                     "argmax_gap_tol": SPEC_REL_TOL})
        if max(gaps) > SPEC_REL_TOL:
            fail(f"gateway: a served token is {max(gaps)} of the largest "
                 f"logit below the teacher's argmax (> {SPEC_REL_TOL})")

        # -- (c) the gateway's overhead and the single worker ---------------
        route.max_new_tokens = GW_LAT_NEW
        small = {"inputs": [_prompts(seed + 1, config.vocab_size)[2]
                            [:GW_LAT_PROMPT]]}
        http_s, local_s, answers = [], [], []
        for _ in range(GW_LAT_REQUESTS):
            response = _http(url, GW_INFER, "POST", small)
            answers.append(_outputs(response, "a small request"))
            http_s.append(response[3])
        for _ in range(GW_LAT_REQUESTS):
            t = time.perf_counter()
            out = server.test(GW_INFER, body=copy.deepcopy(small))
            local_s.append(time.perf_counter() - t)
            answers.append(out["outputs"])
        stats = json.loads(probe("/__stats__")[2])
        barrier = threading.Barrier(GW_CLIENTS)
        concurrent: list = [None] * GW_CLIENTS

        def client(index):
            barrier.wait()
            concurrent[index] = _http(url, GW_INFER, "POST", small)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(GW_CLIENTS)]
        for thread in clients:
            thread.start()
        for thread in clients:
            thread.join(timeout=GW_TIMEOUT)
        answers += [_outputs(r, "a concurrent request") for r in concurrent]
        graph_runs += 2 * GW_LAT_REQUESTS + GW_CLIENTS
        if any(a != answers[0] or len(a[0]) != GW_LAT_NEW for a in answers):
            fail("gateway: one prompt got different greedy tokens")
        rows.append({"phase": "gateway", "leg": "overhead", "card": card,
                     "prompt_len": GW_LAT_PROMPT, "max_new_tokens":
                     GW_LAT_NEW, "http": _percentiles(http_s),
                     "in_process": _percentiles(local_s),
                     "stats": stats, "concurrent_ms": sorted(
                         1000 * r[3] for r in concurrent)})

        # -- (d) a front gateway with a RemoteStep ---------------------------
        route.max_new_tokens = MAX_NEW
        front = GraphServer(graph=RootFlowStep())
        front.graph.to(class_name="mlrun_tpu_torch.serving.remote.RemoteStep",
                       name="hop", url=url + GW_INFER,
                       timeout=GW_TIMEOUT).respond()
        front.init_states(GraphContext(server=front), {})
        front_url, stop_front = _serve_app(asgi.build_serving_app(front))
        via = _http(front_url, "/", "POST", {"inputs": [prompts[0]]},
                    headers={"X-MLT-Trace": f"{GW_TRACE}-{'ab' * 8}"})
        graph_runs += 2
        if _outputs(via, "the front gateway's request") != outputs[-1:]:
            fail("gateway: the front gateway's answer differs from the "
                 "prefix-hit request's")
        trace = json.loads(probe(f"/debug/trace/{GW_TRACE}")[2])
        spans = {s["span_id"]: s for s in trace["spans"]}
        hops = [s for s in spans.values() if s["name"] == "remote.hop"]
        joined = [s for s in spans.values() if s["name"] == "server.run"
                  and (s.get("attrs") or {}).get("path") == GW_INFER
                  and hops and s["parent_id"] == hops[0]["span_id"]]
        if len(hops) != 1 or len(joined) != 1:
            fail(f"gateway: trace {GW_TRACE} holds no model-gateway run "
                 f"under the front's remote span: {sorted(spans)}")
        rows.append({"phase": "gateway", "leg": "front", "card": card,
                     "request_s": via[3], "spans": sorted(
                         s["name"] for s in spans.values()),
                     "critical_path_s": trace["critical_path_s"]})

        # -- (e) drain with a request in flight ------------------------------
        route.max_new_tokens = GW_DRAIN_NEW
        long_prompts = _prompts(seed + 2, config.vocab_size)
        box = {}
        inflight = threading.Thread(target=lambda: box.update(
            answer=_http(url, GW_INFER, "POST", {"inputs": long_prompts})))
        inflight.start()
        t = time.perf_counter()
        while server.inflight == 0 and time.perf_counter() - t < 60:
            time.sleep(0.002)
        graph_runs += 1
        draining = threading.Thread(target=lambda: box.update(
            drain=_http(url, "/__drain__", "POST")))
        t = time.perf_counter()
        draining.start()
        while True:
            ready = probe("/readyz")
            if ready[0] == 503:
                break
            if time.perf_counter() - t > 30:
                fail("gateway: readyz never flipped on drain")
            time.sleep(0.002)
        flip_s = time.perf_counter() - t
        flipped_in_flight = inflight.is_alive()
        inflight.join(timeout=GW_TIMEOUT)
        draining.join(timeout=GW_TIMEOUT)
        drained = json.loads(box["drain"][2])
        answered = _outputs(box["answer"], "the in-flight request")
        after_drain = _http(url, GW_INFER, "POST", small)
        envelope = json.loads(after_drain[2])
        if not (flipped_in_flight and "retry-after" in ready[1]
                and drained == {"drained": True, "inflight": 0}
                and all(len(a) == GW_DRAIN_NEW for a in answered)
                and after_drain[0] == 503
                and "retry-after" in after_drain[1]
                and "draining" in envelope.get("error", "")):
            fail(f"gateway: drain: flipped in flight {flipped_in_flight}, "
                 f"drain {drained}, after {after_drain[0]} {envelope}")
        rows.append({"phase": "gateway", "leg": "drain", "card": card,
                     "readyz_flip_s": flip_s, "drain_s": box["drain"][3],
                     "inflight_request_s": box["answer"][3],
                     "after_drain": [after_drain[0], envelope,
                                     after_drain[1]["retry-after"]]})

        # -- (f) /metrics -----------------------------------------------------
        text = probe("/metrics")
        counted_probes = dict(probes)
        om = probe("/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"})
        body = text[2].decode()
        runs = _metric(body, "mlt_request_latency_seconds_count") \
            - runs_before
        seen = {p: _metric(body, "mlt_probe_requests_total",
                           f'{{path="{p}"}}') - probes_before[p]
                for p in GW_PROBED}
        if not (runs == graph_runs and seen == counted_probes
                and text[1]["content-type"].startswith("text/plain")
                and om[1]["content-type"].startswith(
                    "application/openmetrics-text")
                and om[2].endswith(b"# EOF\n")
                and b'trace_id="' in om[2]):
            fail(f"gateway: /metrics: {runs} runs against {graph_runs}, "
                 f"probes {seen} against {counted_probes}, types "
                 f"{text[1]['content-type']} / {om[1]['content-type']}")
        rows.append({"phase": "gateway", "leg": "metrics", "card": card,
                     "graph_runs": runs, "probes": seen,
                     "text_bytes": len(text[2]), "openmetrics_bytes":
                     len(om[2])})
    finally:
        if stop_front is not None:
            stop_front()
        stop()
        route.close()
    for row in rows:
        emit(row)
    del server, route, engine, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "gateway", "card": card,
          "phase_s": time.perf_counter() - started,
          "launches": {k: launches[k] for k in SERVING_KERNELS}})
    return {k: launches[k] for k in SERVING_KERNELS}


# ---------------------------------------------------------------------------
# phase 17: the serving pod fleet — JobSet replicas of the 8B paged engine,
# scaled by the fleet autoscaler over an in-memory cluster
# ---------------------------------------------------------------------------

POD_MAX_NEW = 64            # the preemption leg's requests
POD_SUFFIX = 16             # tokens after a mover's 600 (its key stays)
POD_FRESH = 400             # the preemption leg's two unseen prompts
POD_IDLE_TICKS = 20         # autoscaler ticks timed with two replicas live
POD_MAX_TICKS = 8           # a pod not joined after this many ticks fails


class _PodGone(Exception):
    """A read of a pod or JobSet the in-memory cluster does not hold."""

    status = 404


class _MemoryCluster:
    """The pod fleet's provider on a machine with no cluster: an in-memory
    stand-in with the JobSet verbs ServingPodFleet calls (``create``,
    ``delete``, ``list_serving_jobsets``) and a ``_core`` whose
    ``read_namespaced_pod`` answers a pod's phase, or raises a 404 once
    the pod is gone. Creating a JobSet makes its pods Running at once;
    ``kill_pod`` deletes one pod out of band (a preemption)."""

    namespace = "serving"

    def __init__(self):
        self.jobsets: dict = {}
        self.pods: dict = {}
        self.events: list = []
        self._core = self

    def create(self, spec: dict, run_uid: str) -> str:
        name = spec["metadata"]["name"]
        self.jobsets[name] = spec
        for job in spec["spec"]["replicatedJobs"]:
            for j in range(int(job.get("replicas", 1))):
                for i in range(int(job["template"]["spec"]["parallelism"])):
                    self.pods[f"{name}-{job['name']}-{j}-{i}"] = "Running"
        self.events.append(("create", name))
        return f"jobset/{name}"

    def delete(self, resource_id: str):
        name = resource_id.partition("/")[2]
        if self.jobsets.pop(name, None) is None:
            raise _PodGone(resource_id)
        for pod in [p for p in self.pods if p.startswith(name + "-")]:
            del self.pods[pod]
        self.events.append(("delete", name))

    def list_serving_jobsets(self) -> dict:
        from mlrun_tpu_torch.k8s.jobset import SERVING_ANNOTATION

        return {name: spec for name, spec in self.jobsets.items()
                if spec["metadata"]["annotations"].get(SERVING_ANNOTATION)
                == "true"}

    def read_namespaced_pod(self, name: str, namespace: str):
        import types

        if name not in self.pods:
            raise _PodGone(name)
        return types.SimpleNamespace(
            status=types.SimpleNamespace(phase=self.pods[name]))

    def kill_pod(self, name: str):
        del self.pods[name]
        self.events.append(("kill", name))


def _bucket_index(value: float, bounds) -> int:
    """The histogram bucket a value falls in (``le`` semantics)."""
    for index, bound in enumerate(bounds):
        if value <= bound:
            return index
    return len(bounds)


def _engine_counters(engine) -> dict:
    stats = engine.stats
    return {key: stats[key] for key in (
        "attn_kernel_ticks", "prefill_kernel_chunks", "prefill_chunks",
        "kv_imported_pages")}


def _counter_delta(engine, before: dict) -> dict:
    now = _engine_counters(engine)
    return {key: now[key] - before.get(key, 0) for key in now}


def _podfleet_check(leg: str, row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"podfleet ({leg}): {bad}")


def phase_podfleet(seed: int, card: str) -> dict:
    """The serving pod fleet over the 8B paged engine (random weights from
    the seed, bf16, native pools, prefix cache on): every pod's engine is
    built by one factory over ONE param dict, the pods are JobSets on an
    in-memory cluster, and a FleetAutoscaler (dry_run off, pods=) reads
    its signals from a MetricsAggregator and a TimeSeriesStore fed from
    the process's registry before every tick. (a) scale-up and pre-warm,
    (b) preemption with KV handoffs, (c) scale-down, (d) the signals and
    two SLOs; the paged decode, cached flash and paged prefill launches
    of the whole run held against the engines' counters."""
    import gc
    import statistics

    import numpy as np
    import torch

    from mlrun_tpu_torch.chaos import FaultPoints, always, chaos
    from mlrun_tpu_torch.models.llama import init_params
    from mlrun_tpu_torch.obs import (
        LLM_TTFT,
        REGISTRY,
        SLO,
        MetricsAggregator,
        MetricsRegistry,
        SLOEvaluator,
        TimeSeriesStore,
        get_flight_recorder,
        nearest_rank,
        parse_prometheus,
    )
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.fleet import EngineFleet
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine
    from mlrun_tpu_torch.serving.podfleet import ServingPodFleet
    from mlrun_tpu_torch.service.autoscaler import FleetAutoscaler

    phase_started = time.perf_counter()
    config = _cut_8b()
    layers = config.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(config, gen, "cuda")
    engines: list = []      # every pod engine the factory built
    warm: dict = {}         # kernel launches inside pre-warm's warmup()

    def build(role="unified"):
        engine = PagedContinuousBatchingEngine(
            config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
            seed=seed, device="cuda", request_ledger=True)
        # each pod's engine would own its process's registry; in this one
        # process its own label keeps its series apart from the others'
        # (an engine's stop retires the series of its label)
        engine.replica = f"pod-engine-{len(engines)}"
        inner = engine.warmup

        def counted_warmup():
            before = _build.launch_counts()
            inner()
            for name, count in _build.launch_counts().items():
                warm[name] = warm.get(name, 0) + count - before.get(name, 0)

        engine.warmup = counted_warmup
        engines.append(engine)
        return engine

    cluster = _MemoryCluster()
    fleet = EngineFleet(build, replicas=0, route_blocks=FLEET_ROUTE_BLOCKS)
    fleet.start()
    pods = ServingPodFleet(fleet, cluster, build, gpus_per_node=1)
    aggregator = MetricsAggregator(stale_after=3600.0)
    store = TimeSeriesStore(resolution_s=1.0, capacity=3600)
    scaler = FleetAutoscaler(
        fleet, store=store, aggregator=aggregator, pods=pods,
        ttft_window=3600.0, dry_run=False, min_replicas=1, max_replicas=2,
        hysteresis_ticks=1, cooldown_up_s=0.0, cooldown_down_s=0.0,
        drain_grace_s=60.0, queue_high=1e9, queue_low=0.0,
        free_page_frac_low=0.0, ttft_p95_high_s=0.0, failure_rate_high=1.0)
    clock0 = time.perf_counter()
    tick_ms: list = []      # (replicas in the fleet, ms) a tick

    def now() -> float:
        return time.perf_counter() - clock0 + 1.0

    def observe(at: float):
        aggregator.ingest_text("process", REGISTRY.render(), at=at)
        aggregator.snapshot_to(store, at)

    def tick() -> dict:
        at = now()
        observe(at)
        live = len(fleet.replicas)
        t0 = time.perf_counter()
        decision = scaler.tick(now=at)
        tick_ms.append((live, (time.perf_counter() - t0) * 1e3))
        return decision

    def forced(action: str):
        def effect(point, context):
            context["box"].update(action=action, reason="smoke", force=True)
        return chaos.inject(FaultPoints.obs_autoscale, always(),
                            action=effect)

    def until_joined(pod: str) -> tuple:
        phases, ticks = [pods.pods().get(pod)], 0
        while phases[-1] != "joined" and ticks < POD_MAX_TICKS:
            tick()
            ticks += 1
            phases.append(pods.pods().get(pod))
        return phases, ticks

    # the first pod comes up through the below-min repair
    first = tick()
    if first["reason"] != "below_min" or not first["acted"]:
        fail(f"podfleet: no below-min scale-up: {first}")
    pod1 = first["acted"]["pod"]
    pod1_phases, _ = until_joined(pod1)
    rid1 = pods._pods[pod1]["rid"]
    candidate, movers = _fleet_movers(fleet, config, seed)
    rng = np.random.default_rng(seed + 17)
    serve = _prompts(seed, config.vocab_size)
    preempt_prompts = [
        movers[0] + rng.integers(1, config.vocab_size,
                                 size=POD_SUFFIX).tolist(),
        movers[1] + rng.integers(1, config.vocab_size,
                                 size=POD_SUFFIX).tolist(),
        rng.integers(1, config.vocab_size, size=POD_FRESH).tolist(),
        rng.integers(1, config.vocab_size, size=POD_FRESH).tolist()]

    # the lone engine's streams (stopped before the store's baseline, so
    # its series never reach the windowed reads below)
    lone = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        seed=seed, device="cuda")
    lone.replica = "lone"
    lone_cold = [lone.generate(m, max_new_tokens=MAX_NEW) for m in movers]
    lone_hit = [lone.generate(m, max_new_tokens=MAX_NEW) for m in movers]
    lone_preempt = [lone.generate(p, max_new_tokens=POD_MAX_NEW)[0]
                    for p in preempt_prompts]
    lone.stop()
    lone = None
    torch.cuda.synchronize()

    # -- the counted window starts here --------------------------------------
    # the store's windowed reads count increases after a series' first
    # point: the TTFT series of the pod engines (those to come included)
    # start from recorded zeros at the baseline
    baseline_at = now()
    observe(baseline_at)
    zero = MetricsRegistry()
    shape = zero.histogram(LLM_TTFT.name, "", labels=LLM_TTFT.labelnames,
                           buckets=LLM_TTFT.buckets)
    for index in range(3):
        shape.observe(0.0, replica=f"pod-engine-{index}", adapter="")
    for (name, labels), _ in parse_prometheus(zero.render())[0].items():
        store.record(name, 0.0, baseline_at,
                     labels={**dict(labels), "source": "process"},
                     kind="counter")
    _build.reset_launch_counts()
    warm.clear()
    counter_base = {id(e): _engine_counters(e) for e in engines}
    get_flight_recorder().clear()

    # -- (a) traffic on one pod, then a forced scale-up and its pre-warm ------
    traffic = [fleet.generate(p, max_new_tokens=MAX_NEW)
               for p in serve + movers]
    reassigned = [p for _, p, _ in fleet.reassigned_hot_keys(candidate)]
    t_up = time.perf_counter()
    with forced("up"):
        up = tick()
    if not up["acted"] or "pod" not in up["acted"]:
        fail(f"podfleet: the forced scale-up did not act: {up}")
    pod2 = up["acted"]["pod"]
    pod2_phases, pod2_ticks = until_joined(pod2)
    join_s = time.perf_counter() - t_up
    rid2 = pods._pods[pod2]["rid"]
    engine2 = engines[-1]
    prewarm = [e for e in get_flight_recorder().events(kind="pod.prewarm")
               if e.get("pod") == pod2][-1]
    prewarm_pages = engine2.stats["kv_imported_pages"]
    before_launch = _build.launch_counts()
    before_counters = _engine_counters(engine2)
    moved, moved_stats = fleet.generate(movers[0], max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    moved_launch = {name: count - before_launch.get(name, 0)
                    for name, count in _build.launch_counts().items()}
    moved_counters = _counter_delta(engine2, before_counters)
    touched, touched_stats = fleet.generate(movers[1],
                                            max_new_tokens=MAX_NEW)
    cached = moved_stats["timing"].get("cached_prefix", 0)
    row = {"phase": "podfleet", "leg": "scale_up_prewarm", "card": card,
           "model": "llama3-8b", "layers": layers,
           "first_pod_phases": pod1_phases,
           "pod": pod2, "replica": rid2, "phases": pod2_phases,
           "ticks_scale_up_to_joined": pod2_ticks + 1,
           "seconds_scale_up_to_joined": join_s,
           "reassigned_hot_keys": len(reassigned),
           "prewarm_s": prewarm["wall_s"],
           "prewarm_fetched_keys": prewarm["fetched_keys"],
           "prewarm_replayed_keys": prewarm["replayed_keys"],
           "prewarm_pages": prewarm_pages,
           "prewarm_ms_per_page": (1e3 * prewarm["wall_s"] / prewarm_pages
                                   if prewarm_pages else None),
           "moved_key": {"replica": moved_stats["replica"],
                         "cached_prefix": cached,
                         "suffix_tokens": len(movers[0]) - cached,
                         "ttft_s": moved_stats["ttft_s"],
                         "fetch_hop": "fetch" in moved_stats["timing"][
                             "phases"],
                         "launches": moved_launch,
                         "engine_counters": moved_counters},
           # the same prompt cold on the first (warm) pod, and on the lone
           # engine cold and as its prefix hit
           "cold_ttft_s": traffic[len(serve)][1]["ttft_s"],
           "lone_cold_ttft_s": lone_cold[0][1]["ttft_s"],
           "lone_hit_ttft_s": lone_hit[0][1]["ttft_s"],
           "traffic_replicas": [s["replica"] for _, s in traffic],
           "checks": {
               "first_pod_one_transition_a_tick": pod1_phases == [
                   "pending", "warming", "ready", "joined"],
               "one_transition_a_tick": pod2_phases == [
                   "pending", "warming", "ready", "joined"],
               "new_replica_is_the_candidate": rid2 == candidate,
               "movers_reassigned": all(m in reassigned for m in movers),
               "prewarm_warm": prewarm["warm"] is True,
               "prewarm_covered_reassigned_keys":
               prewarm["fetched_keys"] + prewarm["replayed_keys"]
               == len(reassigned) > 0,
               "prewarm_imported_pages": prewarm["fetched_keys"] == 0
               or prewarm_pages > 0,
               "moved_key_on_new_pod": moved_stats["replica"] == rid2,
               "moved_key_prefix_hit": cached >= FLEET_SHARED,
               "paged_prefill_moved": moved_launch["paged_prefill"]
               == layers * moved_counters["prefill_kernel_chunks"] > 0,
               "flash_only_suffix_chunks":
               moved_launch["flash_fwd_cached"]
               == layers * moved_counters["prefill_chunks"],
               "moved_tokens_equal_lone_hit": moved == lone_hit[0][0],
               "touched_tokens_equal_lone_hit":
               touched == lone_hit[1][0]
               and touched_stats["replica"] == rid2,
           }}
    _podfleet_check("scale_up_prewarm", row)
    rows = [row]

    # -- (b) preemption: in-flight requests leave the dead pod as handoffs ---
    owners = [fleet._ring.lookup(fleet.routing_key(p))
              for p in preempt_prompts]
    done_at: dict = {}
    futures = []
    firsts = sum(len(e._ttft_ring) for e in engines)
    for index, prompt in enumerate(preempt_prompts):
        future = fleet.submit(prompt, max_new_tokens=POD_MAX_NEW)
        future.add_done_callback(
            lambda f, i=index: done_at.__setitem__(i, time.perf_counter()))
        futures.append(future)
    # every request's first token is out (and in the store) before the
    # pod dies; each is still decoding its 64 tokens
    waited = time.perf_counter()
    while sum(len(e._ttft_ring) for e in engines) < firsts + len(futures):
        if time.perf_counter() - waited > 120:
            fail("podfleet: the preemption requests never started")
        time.sleep(0.01)
    observe(now())
    pod2_samples = list(engine2._ttft_ring)
    in_flight = sum(not f.done() for f in futures)
    t_kill = time.perf_counter()
    cluster.kill_pod(pod2)
    after_kill = tick()
    results = [f.result(timeout=600) for f in futures]
    per_token = _kv_bytes_per_token(config, engine2._pool["k"].element_size())
    on_pod = [i for i, owner in enumerate(owners) if owner == rid2]
    row = {"phase": "podfleet", "leg": "preemption", "card": card,
           "prompt_lens": [len(p) for p in preempt_prompts],
           "max_new_tokens": POD_MAX_NEW, "owners": owners,
           "served_by": [s["replica"] for _, s in results],
           "resumed_via_handoff": [bool(s.get("resumed_via_handoff"))
                                   for _, s in results],
           "handoff_bytes": [s.get("handoff_bytes") for _, s in results],
           "handoff_cached_prefix": [s.get("cached_prefix")
                                     for _, s in results],
           "resume_ttft_s": [s["ttft_s"] if s.get("resumed_via_handoff")
                             else None for _, s in results],
           "done_after_kill_s": [done_at[i] - t_kill
                                 for i in range(len(futures))],
           "in_flight_at_kill": in_flight,
           "pods_after": pods.pods(),
           "checks": {
               "some_on_the_new_pod": len(on_pod) >= 2,
               "all_in_flight_at_kill": in_flight == len(futures),
               "no_request_lost": all(len(t) == POD_MAX_NEW
                                      for t, _ in results),
               "pod_requests_resumed_via_handoff": all(
                   results[i][1].get("resumed_via_handoff")
                   and results[i][1]["replica"] == rid1 for i in on_pod),
               "handoff_bytes_are_prompt_kv": all(
                   results[i][1]["handoff_bytes"]
                   == len(preempt_prompts[i]) * per_token for i in on_pod),
               "pod_removed": pod2 not in pods.pods()
               and rid2 not in [r.id for r in fleet.replicas],
               "jobset_deleted": pod2.rsplit("-slice", 1)[0]
               not in cluster.jobsets,
               "no_repair_needed": after_kill["acted"] is None,
           }}
    preempt_streams = [(p, t) for p, (t, _) in zip(preempt_prompts, results)]
    rows.append(row)
    _podfleet_check("preemption", row)

    # -- (c) scale up again, then the load drops and the autoscaler drains ---
    with forced("up"):
        again = tick()
    pod3 = again["acted"]["pod"]
    pod3_phases, _ = until_joined(pod3)
    idle_from = len(tick_ms)
    for _ in range(POD_IDLE_TICKS):
        tick()
    two_live = sorted(ms for live, ms in tick_ms[idle_from:] if live == 2)
    scaler.queue_low = 1.0
    down = tick()
    victim = (down["acted"] or {}).get("replica")
    victim_pod = next((name for name, rec in pods._pods.items()
                       if rec.get("rid") == victim), None)
    rendered = REGISTRY.render()
    row = {"phase": "podfleet", "leg": "scale_down", "card": card,
           "pod": pod3, "phases": pod3_phases, "decision": {
               k: down[k] for k in ("action", "reason", "acted",
                                    "removed")},
           "victim": victim, "pods_after": pods.pods(),
           "jobsets_after": sorted(cluster.jobsets),
           "autoscaler_tick_ms_two_replicas": {
               "p50": statistics.median(two_live),
               "p99": two_live[int(0.99 * (len(two_live) - 1))],
               "n": len(two_live)},
           "checks": {
               "third_pod_joined": pod3_phases[-1] == "joined",
               "drained_idle": down["action"] == "down"
               and down["reason"] == "idle"
               and (down["acted"] or {}).get("action") == "drain",
               "swept_and_removed": down["removed"] == [victim],
               "victim_pod_gone": victim_pod is None and victim not in [
                   r.id for r in fleet.replicas],
               "jobset_deleted": pod1.rsplit("-slice", 1)[0]
               not in cluster.jobsets and victim == rid1,
               "no_series_of_the_replica": f'replica="{victim}"'
               not in rendered and 'replica="pod-engine-0"' not in rendered,
               "two_live_ticks_timed": len(two_live) == POD_IDLE_TICKS,
           }}
    rows.append(row)
    _podfleet_check("scale_down", row)

    # -- the launches of the whole window against the engines' counters ------
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    _check_launches(launches, SERVING_KERNELS, "podfleet")
    total = {"attn_kernel_ticks": 0, "prefill_kernel_chunks": 0,
             "prefill_chunks": 0}
    for engine in engines:
        delta = _counter_delta(engine, counter_base.get(id(engine), {}))
        for key in total:
            total[key] += delta[key]
    expect = {
        "paged_decode": layers * total["attn_kernel_ticks"]
        + warm.get("paged_decode", 0),
        "paged_prefill": layers * total["prefill_kernel_chunks"]
        + warm.get("paged_prefill", 0),
        "flash_fwd_cached": layers * total["prefill_chunks"]
        + warm.get("flash_fwd_cached", 0)}
    row = {"phase": "podfleet", "leg": "launches", "card": card,
           "launches": {k: launches[k] for k in SERVING_KERNELS},
           "engine_counters": total, "warmup_launches": warm,
           "expected": expect, "engines": len(engines),
           "checks": {f"{name}_matches_counters": launches[name]
                      == expect[name] for name in SERVING_KERNELS}}
    rows.append(row)
    _podfleet_check("launches", row)

    # -- (d) the signals: p95 TTFT from the store, and two SLOs ---------------
    at = now()
    observe(at)
    signals = scaler.signals(at)
    # the engines' own TTFTs: every sample of the pods' rings, the dead
    # pod's as of the store's last read before its engine stopped (its
    # grace-window exports observed after that read died with its series)
    samples = sorted([s for e in engines if e is not engine2
                      for s in e._ttft_ring] + pod2_samples)
    own_p95 = nearest_rank(samples, 0.95)
    own_p50 = statistics.median(samples)
    bounds = LLM_TTFT.buckets
    store_p95 = signals["ttft_p95_s"]
    direct_p95 = store.quantile(LLM_TTFT.name, 0.95, scaler.ttft_window, at)
    low = own_p50 / 2
    high = 1.5 * bounds[min(_bucket_index(samples[-1], bounds),
                            len(bounds) - 1)]
    span = at - baseline_at + 1.0
    evaluator = SLOEvaluator(
        store, [SLO("ttft-below-p50", "latency", target=low, q=0.95),
                SLO("ttft-above-max", "latency", target=high, q=0.95)],
        fast_window=span, slow_window=2 * span, fast_burn=1.0,
        slow_burn=1.0)
    statuses = evaluator.evaluate(at)
    row = {"phase": "podfleet", "leg": "signals", "card": card,
           "ttft_samples": len(samples), "engine_ttft_p50_s": own_p50,
           "engine_ttft_p95_s": own_p95, "store_ttft_p95_s": store_p95,
           "store_bucket": (_bucket_index(store_p95, bounds)
                            if store_p95 is not None else None),
           "engine_bucket": _bucket_index(own_p95, bounds),
           "signals": signals,
           "slos": [{"name": s["name"], "target": s["target"],
                     "burn": s["burn"], "breaching": s.breaching}
                    for s in statuses],
           "checks": {
               "autoscaler_read_the_store": direct_p95 is not None
               and store_p95 == direct_p95,
               "store_p95_within_one_bucket": store_p95 is not None
               and abs(_bucket_index(store_p95, bounds)
                       - _bucket_index(own_p95, bounds)) <= 1,
               "aggregated_queue_signal": signals["load_total"] == 0.0,
               "exactly_one_slo_breaches":
               [s.breaching for s in statuses] == [True, False],
           }}
    rows.append(row)
    _podfleet_check("signals", row)

    # the streams, teacher-forced after the counted window closed
    pod_kinds = [e["kind"] for e in get_flight_recorder().events()
                 if e["kind"].startswith("pod.") and e.get("pod") == pod2]
    chain = ["pod.scale_up", "pod.prewarm", "pod.join", "pod.kill",
             "pod.redispatch", "pod.delete"]
    positions, cursor = [], 0
    for kind in chain:
        cursor = pod_kinds.index(kind, cursor) if kind in pod_kinds[
            cursor:] else -1
        positions.append(cursor)
        if cursor < 0:
            break
    streams = [_stream_check(config, params, p, t, lt)
               for (p, t), lt in zip(preempt_streams, lone_preempt)]
    row = {"phase": "podfleet", "leg": "streams", "card": card,
           "preempted_vs_lone": streams, "flight_chain": pod_kinds,
           "checks": {
               "preempted_equal_lone_until_near_tie": all(
                   s["tie_at_departure_rel"] is None
                   or s["tie_at_departure_rel"] <= SPEC_REL_TOL
                   for s in streams),
               "flight_chain_ordered": -1 not in positions
               and positions == sorted(positions),
           }}
    rows.append(row)
    _podfleet_check("streams", row)
    fleet.stop()
    fleet = pods = scaler = engines = None
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "podfleet", "card": card,
          "phase_s": time.perf_counter() - phase_started})
    return {name: rows[3]["launches"][name] for name in SERVING_KERNELS}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: the run stack — tpujob runs of the 1B trainer into a run db
# ---------------------------------------------------------------------------

RUNS_STEPS = 4              # (a): steps of the tpujob run
# (c): steps an iteration (the third step's loss is the first one the
# learning rate moves: the first update's learning rate is 0)
RUNS_HYPER_STEPS = 3
RUNS_LRS = (1e-3, 1e-4)     # (c): the two iterations' learning rates
RUNS_PROJECT = "smoke"
RUNS_MODEL = "llama-1b"     # the model artifact's key


def _runs_check(leg: str, row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"runs ({leg}): {bad}")


def _runs_tpujob_leg(seed: int, card: str, db, work: str,
                     train_step_ms) -> dict:
    """(a) the 1B trainer as a tpujob run on the card: its JobSet, then
    the run through the local launcher into the run db."""
    import torch

    from mlrun_tpu_torch import new_function
    from mlrun_tpu_torch.artifacts import ModelArtifact, get_model
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.model import RunObject, new_task
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build

    config = MODEL_PRESETS["llama3-1b"]()
    fn = new_function("train", kind="tpujob", project=RUNS_PROJECT)
    fn.with_gpus(nodes=1, gpus_per_node=1)
    params = {"model": "llama3-1b", "batch_size": TRAIN_BATCH,
              "seq_len": TRAIN_SEQ, "steps": RUNS_STEPS,
              "log_every": RUNS_STEPS, "seed": seed,
              "model_name": RUNS_MODEL,
              "checkpoint_dir": os.path.join(work, "checkpoints")}

    # the JobSet the service would submit for this run
    probe = RunObject.from_template(new_task(
        name="train", project=RUNS_PROJECT, params=params))
    probe.metadata.uid = "0123456789abcdef"
    jobset = fn.generate_jobset(probe)
    job = jobset["spec"]["replicatedJobs"][0]["template"]["spec"]
    main = job["template"]["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in main["env"]}
    jobset_checks = {
        "one_node": job["parallelism"] == job["completions"] == 1
        and jobset["spec"]["replicatedJobs"][0]["replicas"] == 1,
        "one_gpu": main["resources"]["limits"].get("nvidia.com/gpu") == 1
        and fn.total_gpus == 1,
        "torchrun_env": "torchrun" in " ".join(main["command"])
        and env.get("NNODES") == "1" and env.get("NPROC_PER_NODE") == "1"
        and {"MASTER_ADDR", "MASTER_PORT", "NODE_RANK"} <= set(env),
        "exec_config_round_trips": json.loads(env["MLT_EXEC_CONFIG"])
        == json.loads(json.dumps(probe.to_dict(), default=str)),
    }

    def print_loss(step, metrics, trainer):
        print(f"tpujob step {step} loss {float(metrics['loss']):.6f}")

    # -- the main path, counted: every count reset right before it ---------
    _build.reset_launch_counts()
    started = time.perf_counter()
    run = fn.run(handler=auto_trainer.train,
                 params={**params, "callbacks": [print_loss]},
                 artifact_path=os.path.join(work, "artifacts"), local=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - started
    launches = _build.launch_counts()
    uid = run.metadata.uid
    stored = db.read_run(uid, RUNS_PROJECT) or {}
    log_state, log = db.get_log(uid, RUNS_PROJECT)
    model_uri = f"store://models/{RUNS_PROJECT}/{RUNS_MODEL}"
    model_file, spec, _ = get_model(model_uri)
    results = run.status.results or {}
    passes = RUNS_STEPS + 1     # the warmup's pass and every step
    want = {"flash_fwd": 2 * config.n_layers * passes,
            "flash_bwd": config.n_layers * passes}
    step_ms = (TRAIN_BATCH * TRAIN_SEQ / results["tokens_per_sec"] * 1e3
               if results.get("tokens_per_sec") else None)
    row = {
        "phase": "runs", "leg": "tpujob", "card": card, "model": "llama3-1b",
        "layers": config.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": RUNS_STEPS, "uid": uid, "state": run.state(),
        "error": run.status.error, "results": results,
        "step_ms": step_ms, "train_phase_step_ms": train_step_ms,
        "run_s": run_s, "log": log.decode(errors="replace")[-400:],
        "model_uri": model_uri, "model_file": model_file,
        "model_spec_kind": type(spec).__name__,
        "launches": launches, "expected_launches": want,
        "jobset_checks": jobset_checks,
        "checks": {
            **jobset_checks,
            "completed": run.state() == "completed"
            and stored.get("status", {}).get("state") == "completed"
            and log_state == "completed",
            "db_results_equal_the_runs":
            stored.get("status", {}).get("results") == results,
            "results_logged": {"loss", "tokens_per_sec", "mfu",
                               "train_time_s", "compile_seconds"}
            <= set(results)
            and math.isfinite(results.get("loss", float("nan"))),
            "log_holds_the_handlers_stdout":
            f"tpujob step {RUNS_STEPS - 1} loss".encode() in log,
            "model_resolves_to_the_checkpoint":
            isinstance(spec, ModelArtifact)
            and os.path.abspath(model_file) == os.path.abspath(
                params["checkpoint_dir"])
            and spec.spec.target_path == os.path.abspath(
                params["checkpoint_dir"]),
            "flash_launches": launches == {**{k: 0 for k in launches},
                                           **want},
        }}
    _runs_check("tpujob", row)
    return row


def _runs_failing_leg(seed: int, card: str, db) -> dict:
    """(b) the same function with a preset the handler refuses: the run
    ends in error, the service's run_failed event goes into the db, and a
    JobFailed alert fires once through a console notification."""
    import io
    from contextlib import redirect_stdout

    from mlrun_tpu_torch import new_function
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.service.alerts import (
        get_alert_template,
        process_event,
    )

    config = get_alert_template("JobFailed")
    config.update(name="train-failed", entity_id="train",
                  notifications=[{"kind": "console"}])
    db.store_alert_config("train-failed", config, RUNS_PROJECT)
    fn = new_function("train", kind="tpujob", project=RUNS_PROJECT)
    fn.with_gpus(nodes=1, gpus_per_node=1)
    _build.reset_launch_counts()
    run = fn.run(handler=auto_trainer.train, params={
        "model": "llama3-1b-nope", "steps": 1, "seed": seed}, local=True)
    launches = _build.launch_counts()
    event = {"entity_id": run.metadata.name, "uid": run.metadata.uid,
             "error": run.status.error}
    out = io.StringIO()
    with redirect_stdout(out):
        db.emit_event("run_failed", event, RUNS_PROJECT)
        fired = process_event(db, RUNS_PROJECT, "run_failed", event)
    printed = out.getvalue()
    print(printed, end="")
    stored = db.read_run(run.metadata.uid, RUNS_PROJECT) or {}
    alert = db.get_alert_config("train-failed", RUNS_PROJECT)
    events = db.list_events(RUNS_PROJECT, kind="run_failed")
    row = {
        "phase": "runs", "leg": "failing_run", "card": card,
        "state": run.state(), "error": run.status.error, "fired": fired,
        "alert_count": alert.get("count"), "alert_state": alert.get("state"),
        "events": len(events), "notification": printed.strip(),
        "launches": launches,
        "checks": {
            "ended_in_error": run.state() == "error"
            and stored.get("status", {}).get("state") == "error",
            "reason_in_status_error": "unknown model preset 'llama3-1b-nope'"
            in (run.status.error or ""),
            "job_failed_fired_once": fired == ["train-failed"]
            and alert.get("count") == 1,
            "event_in_the_db": len(events) == 1
            and events[0].get("uid") == run.metadata.uid,
            "console_notification": "alert 'train-failed' fired" in printed,
            "no_kernel_launched": not any(launches.values()),
        }}
    _runs_check("failing_run", row)
    return row


ADAPTER_FEATURES, ADAPTER_HIDDEN = 16, 64    # a 5,313-parameter MLP
ADAPTER_BATCHES, ADAPTER_BATCH, ADAPTER_EPOCHS = 4, 32, 2


def _adapter_mlp():
    from torch import nn

    return nn.Sequential(nn.Linear(ADAPTER_FEATURES, ADAPTER_HIDDEN),
                         nn.ReLU(), nn.Linear(ADAPTER_HIDDEN, ADAPTER_HIDDEN),
                         nn.ReLU(), nn.Linear(ADAPTER_HIDDEN, 1))


def _runs_torch_adapter_leg(seed: int, card: str, db) -> dict:
    """(e) user torch code through the torch adapter: a seeded MLP on the
    card trains through frameworks.torch.train inside a local run (host
    batches, moved to the model's device by the loop), its state dict a
    model artifact in the run db; TorchModelServer with its default
    device loads that artifact on the card and predicts a batch, equal to
    the in-memory model's outputs on the same inputs."""
    import torch
    from torch import nn

    from mlrun_tpu_torch import new_function
    from mlrun_tpu_torch.frameworks.torch import TorchModelServer, train

    started = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(ADAPTER_BATCHES * ADAPTER_BATCH, ADAPTER_FEATURES,
                    generator=gen)
    y = x.sum(dim=1, keepdim=True)
    loader = [(x[i:i + ADAPTER_BATCH], y[i:i + ADAPTER_BATCH])
              for i in range(0, len(x), ADAPTER_BATCH)]
    trained = {}

    def handler(context):
        torch.manual_seed(seed)
        model = _adapter_mlp().to("cuda")
        trained["model"] = model
        trained["params_on_cuda"] = all(
            p.is_cuda for p in model.parameters())
        train(model, nn.MSELoss(),
              torch.optim.Adam(model.parameters(), lr=1e-2), loader,
              context=context, epochs=ADAPTER_EPOCHS, model_name="torch-mlp")
        trained["params_on_cuda"] &= all(
            p.is_cuda for p in model.parameters())

    fn = new_function("torch-mlp", kind="local", handler=handler,
                      project=RUNS_PROJECT)
    run = fn.run(local=True)
    train_s = time.perf_counter() - started
    uri = (run.status.artifact_uris or {}).get("torch-mlp", "")
    server = TorchModelServer(None, name="torch-mlp", model_path=uri,
                              model_factory=_adapter_mlp)
    server.post_init()
    if not server.ready:
        fail(f"runs (torch_adapter): TorchModelServer failed to load: "
             f"{server.error}")
    inputs = x[:ADAPTER_BATCH]
    reply = server.do_event(_Event({"inputs": inputs.tolist()})).body
    served = torch.tensor(reply["outputs"], dtype=torch.float32)
    with torch.no_grad():
        direct = server.model(inputs.to("cuda"))
        expected = trained["model"].eval()(inputs.to("cuda"))
    err = float((served - expected.cpu()).abs().max())
    stored = db.read_run(run.metadata.uid, RUNS_PROJECT) or {}
    row = {
        "phase": "runs", "leg": "torch_adapter", "card": card,
        "state": run.state(), "error": run.status.error,
        "results": run.status.results, "model_uri": uri,
        "parameters": sum(p.numel() for p in trained["model"].parameters()),
        "served_max_abs_err": err, "served_tol": 1e-6,
        "train_s": train_s, "seconds": time.perf_counter() - started,
        "launches": {},
        "checks": {
            "completed": run.state() == "completed"
            and stored.get("status", {}).get("state") == "completed",
            "model_artifact_in_the_db": bool(uri) and "torch-mlp" in (
                stored.get("status", {}).get("artifact_uris") or {}),
            "params_on_cuda": trained["params_on_cuda"],
            "served_params_on_cuda": all(
                p.is_cuda for p in server.model.parameters()),
            "served_outputs_on_cuda": direct.is_cuda,
            "served_equal_in_memory": err <= 1e-6
            and served.shape == expected.shape,
            "under_10_s": time.perf_counter() - started < 10.0,
        }}
    _runs_check("torch_adapter", row)
    return row


def _runs_hyper_leg(seed: int, card: str, db) -> dict:
    """(c) a two-iteration hyper-parameter run over the learning rate,
    selected by min.loss (the first update's learning rate is 0, so the
    losses part at the third step)."""
    import torch

    from mlrun_tpu_torch import new_function
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build

    config = MODEL_PRESETS["llama3-1b"]()
    fn = new_function("train", kind="tpujob", project=RUNS_PROJECT)
    fn.with_gpus(nodes=1, gpus_per_node=1)
    _build.reset_launch_counts()
    started = time.perf_counter()
    run = fn.run(handler=auto_trainer.train, params={
        "model": "llama3-1b", "batch_size": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": RUNS_HYPER_STEPS,
        "log_every": RUNS_HYPER_STEPS, "seed": seed},
        hyperparams={"learning_rate": list(RUNS_LRS)},
        hyper_param_options={"selector": "min.loss"}, local=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - started
    launches = _build.launch_counts()
    uid = run.metadata.uid
    children = [db.read_run(uid, RUNS_PROJECT, iter=i) or {}
                for i in range(1, len(RUNS_LRS) + 1)]
    losses = [c.get("status", {}).get("results", {}).get("loss")
              for c in children]
    best = (run.status.results or {}).get("best_iteration")
    passes = len(RUNS_LRS) * (RUNS_HYPER_STEPS + 1)
    want = {"flash_fwd": 2 * config.n_layers * passes,
            "flash_bwd": config.n_layers * passes}
    finite = all(isinstance(x, float) and math.isfinite(x) for x in losses)
    row = {
        "phase": "runs", "leg": "hyper", "card": card,
        "learning_rates": list(RUNS_LRS), "steps": RUNS_HYPER_STEPS,
        "state": run.state(), "iteration_losses": losses,
        "best_iteration": best, "iterations": run.status.iterations,
        "run_s": run_s, "launches": launches, "expected_launches": want,
        "checks": {
            "completed": run.state() == "completed",
            "both_iterations_in_the_db": [
                c.get("status", {}).get("state") for c in children]
            == ["completed"] * len(RUNS_LRS),
            "best_is_the_lower_loss": finite and len(set(losses)) > 1
            and best == 1 + losses.index(min(losses)),
            "parent_results_are_the_best": finite
            and (run.status.results or {}).get("loss") == min(losses),
            "flash_launches": launches == {**{k: 0 for k in launches},
                                           **want},
        }}
    _runs_check("hyper", row)
    return row


def _runs_slo_leg(seed: int, card: str, db) -> dict:
    """(d) SLOEvaluator.process over a TimeSeriesStore fed from the
    registry around a burst of the serve traffic on a 1B paged server: a
    TTFT target below the burst's p50 fires SLOBurnRate once, a second
    call within refire_after fires nothing, the breach event is in the
    db."""
    import statistics

    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.obs import (
        REGISTRY,
        SLO,
        MetricsAggregator,
        SLOEvaluator,
        TimeSeriesStore,
    )
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.service.alerts import get_alert_template
    from mlrun_tpu_torch.serving.llm import LLMModelServer

    config = MODEL_PRESETS["llama3-1b"]()
    prompts = _prompts(seed, config.vocab_size)
    server = LLMModelServer(
        name="llama3-1b", model_preset="llama3-1b", continuous_batching=True,
        paged=True, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        max_new_tokens=MAX_NEW, seed=seed)
    server.post_init()
    if not server.ready:
        fail(f"runs (slo): LLMModelServer failed to load: {server.error}")

    def submit(batch):
        return server.do_event(_Event({"inputs": batch})).body["outputs"]

    aggregator = MetricsAggregator(stale_after=3600.0)
    # 0.1 s points: the burst's two reads land in different points even
    # when it takes under a second
    store = TimeSeriesStore(resolution_s=0.1, capacity=36000)
    clock0 = time.perf_counter()

    def observe() -> float:
        at = time.perf_counter() - clock0 + 1.0
        aggregator.ingest_text("process", REGISTRY.render(), at=at)
        aggregator.snapshot_to(store, at)
        return at

    # one request first, so the engine's TTFT series exists at the baseline
    submit([prompts[2][:64]])
    engine = server.engine
    ring_mark = len(engine._ttft_ring)
    start_at = observe()
    before = _engine_counters(engine)
    # -- the burst, counted: every count reset right before it -------------
    _build.reset_launch_counts()
    outputs = _serve_events(submit, prompts)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    counted = _gateway_launches(launches, before, _engine_counters(engine),
                                config.n_layers, path="runs (slo)")
    at = observe()
    samples = list(engine._ttft_ring)[ring_mark:]
    server.close()
    p50 = statistics.median(samples)
    target = p50 / 2
    span = at - start_at + 1.0
    alert = get_alert_template("SLOBurnRate")
    alert["name"] = "ttft-burn"
    db.store_alert_config("ttft-burn", alert, RUNS_PROJECT)
    evaluator = SLOEvaluator(
        store, [SLO("ttft-below-p50", "latency", target=target, q=0.95)],
        fast_window=span, slow_window=2 * span, fast_burn=1.0,
        slow_burn=1.0, refire_after=60.0, project=RUNS_PROJECT)
    first = evaluator.process(db, at=at)
    status = evaluator.status()[0]
    second = evaluator.process(db, at=at + 1.0)
    events = db.list_events(RUNS_PROJECT, kind="slo_burn_rate")
    stored = db.get_alert_config("ttft-burn", RUNS_PROJECT)
    row = {
        "phase": "runs", "leg": "slo", "card": card, "model": "llama3-1b",
        "layers": config.n_layers, "requests": len(outputs),
        "ttft_samples": len(samples), "ttft_p50_s": p50,
        "target_s": target, "window_s": span, "burn_fast": status.burn_fast,
        "burn_slow": status.burn_slow, "fired": first, "refired": second,
        "events": len(events), "alert_count": stored.get("count"),
        "launches": launches, **counted,
        "checks": {
            "tokens": all(len(o) == MAX_NEW for o in outputs),
            "fired_once": first == ["ttft-burn"] and status.breaching,
            "damped_within_refire_after": second == []
            and evaluator.status()[0].breaching,
            "breach_event_in_the_db": len(events) == 1
            and events[0].get("slo") == "ttft-below-p50"
            and stored.get("count") == 1,
        }}
    _runs_check("slo", row)
    return row


def phase_runs(seed: int, card: str, train_step_ms=None) -> dict:
    """The run stack on the card, over a temporary SQLite run db and
    artifact path: (a) the 1B trainer as a tpujob run, (b) a failing run
    and its JobFailed alert, (c) a two-iteration hyper-parameter run, (d)
    SLOEvaluator.process after a burst on a 1B paged server, (e) user
    torch code through frameworks.torch's train and TorchModelServer.
    Returns the kernels' launches on the legs."""
    import shutil
    import tempfile

    from mlrun_tpu_torch.datastore import store_manager
    from mlrun_tpu_torch.db import SQLiteRunDB, set_run_db

    work = tempfile.mkdtemp(prefix="mlt-runs-")
    db = SQLiteRunDB(os.path.join(work, "runs.sqlite"),
                     logs_dir=os.path.join(work, "logs"))
    set_run_db(db)
    store_manager.set(db=db)
    started = time.perf_counter()
    launches: dict = {}
    try:
        rows = [_runs_tpujob_leg(seed, card, db, work, train_step_ms)]
        _release()
        rows.append(_runs_failing_leg(seed, card, db))
        rows.append(_runs_hyper_leg(seed, card, db))
        _release()
        rows.append(_runs_slo_leg(seed, card, db))
        _release()
        rows.append(_runs_torch_adapter_leg(seed, card, db))
        for row in rows:
            for name, count in row["launches"].items():
                launches[name] = launches.get(name, 0) + count
        emit({"phase": "runs", "card": card,
              "seconds": time.perf_counter() - started,
              "step_ms": rows[0]["step_ms"],
              "train_phase_step_ms": train_step_ms,
              "launches": launches,
              "runs_in_db": len(db.list_runs(project=RUNS_PROJECT,
                                             iter=True))})
    finally:
        set_run_db(None)
        store_manager._db = None
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase: tuning — the continuous-tuning loop on the card (model_monitoring/
# controller.py ContinuousTuningController): natural drift → a LoRA retrain
# run → a canary hash split → promote; a second tenant's retrain → a
# degraded canary → rollback; a restart mid-canary
# ---------------------------------------------------------------------------

TUNE_PROJECT = "tuning"
TUNE_RANK = 16              # the lora phase's rank and four targets
TUNE_STEPS = 4              # the retrain run's LoRA fit steps at B4 x 2048
TUNE_LR = 5e-3
TUNE_TICK_S = 10.0          # the loop's fake clock step
TUNE_REFERENCE = 32         # (a): the default reference_min
TUNE_WINDOW = 16            # (a): the default window_min
TUNE_REF_NEW, TUNE_DRIFT_NEW = 16, 48   # (a): tokens a request
TUNE_FRACTION = 0.5         # (c): the canary's share of the tenant
TUNE_CANARY = 32            # (c): requests with distinct request keys
TUNE_CANARY_NEW = 16
TUNE_BASELINE = 8           # requests timed before the controller starts
TUNE_T2_PROMPT = 90         # (d): a prompt of no full page (never cached)
TUNE_SHARED = 256           # the shared prefix: two pages
TUNE_LENS = (64, 600)       # (a)'s prompt lengths
TUNE_CANARY_LENS = (200, 600)   # the eight prompts of (c)'s baseline,
                                # the promoted streams and (f)
TUNE_T2_LENS = (64, 400)    # (d)'s traffic
TUNE_RESTART_KEYS = 64      # (e): request keys whose sides are compared
TUNE_PROBES = 3             # (e): keys a side served across the restart
TUNE_MAX_TICKS = 8          # a stage not concluded after this many fails
TUNE_TICK_WINDOW = 16384    # engine ticks kept for the p50s (all of them)

# the retrain handler's inputs and what it measured, set by phase_tuning
_TUNE: dict = {}


def _tune_handler(context, tenant: str = "", output_path: str = "",
                  canary_id: str = "", **kwargs):
    """The LoRA fine-tune the loop submits as a run (user code, as in the
    reference's own loop tests): rank 16 on the base weights the server
    holds, B4 x 2048 for TUNE_STEPS steps, the adapter written through
    ``serving.adapters.save_adapter`` to the controller's output path."""
    import torch

    from mlrun_tpu_torch.serving.adapters import save_adapter
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.train import tree_leaves

    config, params, batch = _TUNE["config"], _TUNE["params"], _TUNE["batch"]

    def checksum(tree):
        with torch.no_grad():
            return [float(leaf.double().sum()) for leaf in tree_leaves(tree)]

    def repeated():
        while True:
            yield batch

    started = time.perf_counter()
    trainer = Trainer(config, TrainConfig(
        learning_rate=TUNE_LR, warmup_steps=0, total_steps=TUNE_STEPS,
        loss_chunk=LOSS_CHUNK, lora_rank=TUNE_RANK), device="cuda")
    trainer.init(_TUNE["seed"] + len(_TUNE["runs"]), params=params)
    same_base = checksum(trainer.state.params) == _TUNE["base_checksum"]
    warm = trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    trainer.fit(repeated(), TUNE_STEPS, log_every=1, prefetch=2)
    torch.cuda.synchronize()
    history = trainer.metrics_history
    losses = [float(view["loss"]) for view in history]
    step_ms = TRAIN_BATCH * TRAIN_SEQ / history[-1]["tokens_per_sec"] * 1e3
    save_adapter(output_path, trainer.state.lora)
    frozen = checksum(trainer.state.params) == _TUNE["base_checksum"]
    run = {"tenant": tenant, "canary": canary_id, "losses": losses,
           "output_path": output_path,
           "step_ms": step_ms, "compile_seconds": warm["compile_seconds"],
           "trained_on_the_served_base": same_base,
           "base_unchanged": frozen, "run_s": time.perf_counter() - started}
    _TUNE["runs"].append(run)
    del trainer
    context.log_results({"loss": losses[-1], "step_ms": step_ms,
                         "adapter": output_path})


def _tune_check(leg: str, row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"tuning ({leg}): {bad}")


def _tune_prompts(seed: int, vocab: int, n: int, lo: int, hi: int,
                  shared: list, every: int = 3) -> list:
    """``n`` prompts of ``lo``-``hi`` tokens, every ``every``-th one
    opening with the ``shared`` prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        head = list(shared) if i % every == 0 and length > len(shared) \
            else []
        out.append(head + rng.integers(1, vocab,
                                       size=length - len(head)).tolist())
    return out


def _tune_burst(engine, prompts, tenant, max_new, keys=None) -> list:
    futures = [engine.submit(p, max_new_tokens=max_new, adapter=tenant,
                             request_key=None if keys is None else keys[i])
               for i, p in enumerate(prompts)]
    return [f.result(timeout=600)[0] for f in futures]


def _page_bound(prompt, history) -> int:
    """The most prompt tokens a prefix cache could hold for ``prompt`` from
    the earlier prompts of the same identity: the longest common prefix,
    in whole pages."""
    best = 0
    for earlier in history:
        common = len(os.path.commonprefix([prompt, earlier]))
        best = max(best, common // PAGE * PAGE)
    return best


def _record_prefix_owners(engine) -> list:
    """Record, for every prefix match the engine makes from now on, the
    adapter ids whose radix roots own the matched pages (read from the
    prefix cache itself, not from the id the engine searched under).
    Wraps this engine's cache instance; ``del engine._prefix.match``
    restores it."""
    cache = engine._prefix
    real = cache.match
    calls = []

    def pages_under(root) -> set:
        out, stack = set(), [root]
        while stack:
            node = stack.pop()
            if node.page_id >= 0:
                out.add(node.page_id)
            stack.extend(node.children.values())
        return out

    def match(prompt, adapter=""):
        pages, nodes = real(prompt, adapter=adapter)
        owners = sorted(name for name, root in list(cache._roots.items())
                        if pages_under(root) & set(pages))
        calls.append({"pages": len(pages), "owners": owners})
        return pages, nodes

    cache.match = match
    return calls


class _WarningRecords(logging.Handler):
    """The warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _peek_samples(controller) -> list:
    """The samples the tap handed the controller since its last tick (a
    copy: the tick still drains them)."""
    with controller.ring._lock:
        return list(controller.ring._ring)


def _until(controller, clock, action: str, tenant: str, serve=None,
           after=()) -> tuple:
    """Tick the loop until it takes ``action`` for ``tenant`` (serving
    ``serve()`` before each tick), unless one of the ticks ``after``
    already took it (a local retrain run completes inside the tick that
    submits it, so that tick's poll starts the canary): (the tick
    outputs, the new clock)."""
    if any(a["action"] == action for a in _actions(after, tenant)):
        return [], clock
    outs = []
    for _ in range(TUNE_MAX_TICKS):
        if serve is not None:
            serve()
        clock += TUNE_TICK_S
        outs.append(controller.tick(clock))
        if any(a["action"] == action and a["tenant"] == tenant
               for a in outs[-1]["actions"]):
            return outs, clock
    fail(f"tuning: no '{action}' for {tenant} within {TUNE_MAX_TICKS} "
         f"ticks: {[o['actions'] for o in outs]}")


def _actions(outs, tenant=None) -> list:
    return [a for o in outs for a in o["actions"]
            if tenant is None or a["tenant"] == tenant]


class _LLMWithContext:
    """User code of the endpoint leg: a graph step class whose ``__init__``
    names ``context`` gets the graph context, and hands it to the
    LLMModelServer it wraps, so the route's model logger pushes to the
    tracked graph's stream. The step gives the bare LLMModelServer no
    context, in this package as in the reference."""

    def __init__(self, context=None, **class_args):
        from mlrun_tpu_torch.serving.llm import LLMModelServer

        self.server = LLMModelServer(context=context, **class_args)

    def __getattr__(self, name):
        if name == "server":
            raise AttributeError(name)
        return getattr(self.server, name)


def _tuning_endpoint_leg(seed: int, card: str, db, prompts) -> dict:
    """(f) the endpoint path (the card's machine has pandas and pyarrow): a
    GraphServer with ``track_models`` over a 1B LLMModelServer, given the
    graph context by ``_LLMWithContext``, pushes one event a request to the project's monitoring stream; the stream
    processor writes the endpoint's parquet window and its record in the
    run db; the application controller writes the latency results into
    the record and the metric series (MLT_HOME's metrics.db)."""
    import copy

    import torch

    from mlrun_tpu_torch.model_monitoring import (
        EventStreamProcessor,
        MonitoringApplicationController,
    )
    from mlrun_tpu_torch.model_monitoring.tsdb import get_metrics_tsdb
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.server import GraphContext, GraphServer

    spec = copy.deepcopy(GATEWAY_SPEC)
    spec["function_uri"] = f"{TUNE_PROJECT}/endpoint"
    spec["track_models"] = True
    route_spec = spec["graph"]["steps"]["router"]["routes"]["llm"]
    route_spec["class_name"] = "LLMWithContext"
    route_spec["class_args"].update(
        model_preset="llama3-1b", max_new_tokens=TUNE_CANARY_NEW, seed=seed)
    server = GraphServer.from_dict(spec)
    server.init_states(GraphContext(server=server),
                       {"LLMWithContext": _LLMWithContext})
    route = server.graph.steps["router"].routes["llm"]._object
    if not route.ready:
        fail(f"tuning (endpoint): the llm route failed to load: "
             f"{route.error}")
    engine = route.engine
    try:
        # the leg's path, counted: every count reset right before it
        _build.reset_launch_counts()
        before = _engine_counters(engine)
        outputs = [server.test("/v2/models/llm/infer",
                               body={"inputs": [p]})["outputs"][0]
                   for p in prompts]
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        counted = _gateway_launches(launches, before,
                                    _engine_counters(engine),
                                    engine.config.n_layers,
                                    path="tuning (endpoint)")
    finally:
        route.close()
    started = time.perf_counter()
    processed = EventStreamProcessor(TUNE_PROJECT, db=db).run_once()
    results = MonitoringApplicationController(TUNE_PROJECT,
                                              db=db).run_once()
    endpoint_id = f"{TUNE_PROJECT}-endpoint.llm"
    record = db.get_model_endpoint(TUNE_PROJECT, endpoint_id)
    series = {s["metric"]: s["points"] for s in get_metrics_tsdb().query(
        TUNE_PROJECT, endpoint_id)}
    p50 = series.get("latency_p50_microsec", [{}])[-1].get("value")
    row = {
        "phase": "tuning", "leg": "endpoint", "card": card,
        "requests": len(prompts), "processed": processed,
        "pipeline_s": time.perf_counter() - started,
        "results": {k: [r.name for r in v] for k, v in results.items()},
        "endpoint_metrics": record.get("metrics"),
        "series": sorted(series), "latency_p50_microsec": p50,
        "launches": launches, **counted,
        "checks": {
            "tokens": all(len(o) == TUNE_CANARY_NEW for o in outputs),
            "every_event_processed": processed == len(prompts),
            "endpoint_record": record.get("metrics", {}).get("requests")
            == len(prompts),
            "latency_series": p50 is not None and p50 > 0
            and "latency_p95_microsec" in series,
        }}
    _tune_check("endpoint", row)
    return row


def phase_tuning(seed: int, card: str) -> dict:
    """The continuous-tuning loop on Llama-3.2-1B at full width and depth:
    one paged engine (page 128, prefix cache, 4 slots, max_len 2048) with
    a rank-16 adapter bank holding tenants t1 and t2, under one
    ContinuousTuningController whose retrains are local runs of
    ``_tune_handler`` in a temporary run db, with its canary journal live.
    (a) natural drift on t1 submits one retrain; (b) the retrain is a LoRA
    fit on the card; (c) its adapter canaries at a hash split and is
    promoted; (d) a retrain of t2 canaries worse and rolls back; (e) a
    restarted controller adopts a live split; (f) the endpoint path of a
    tracked graph into the stream processor, the application controller
    and the metric series. Returns the launches."""
    import shutil
    import statistics
    import tempfile

    import torch

    from mlrun_tpu_torch.chaos import FaultPoints, chaos
    from mlrun_tpu_torch.config import SERVING_FLEET_DEFAULTS
    from mlrun_tpu_torch.datastore import store_manager
    from mlrun_tpu_torch.db import SQLiteRunDB, set_run_db
    from mlrun_tpu_torch.model_monitoring import ContinuousTuningController
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.models.lora import init_lora_nonzero, merge_lora
    from mlrun_tpu_torch.obs import CANARY_REQUESTS, get_flight_recorder
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.adapters import load_adapter
    from mlrun_tpu_torch.serving.canary import set_canary_router, split_key_for
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine
    from mlrun_tpu_torch.serving.samples import set_sample_observer
    from mlrun_tpu_torch.training.data import synthetic_token_stream, to_device
    from mlrun_tpu_torch.training.train import tree_leaves

    phase_started = time.perf_counter()
    config = MODEL_PRESETS["llama3-1b"]()
    vocab = config.vocab_size
    work = tempfile.mkdtemp(prefix="mlt-tuning-")
    db = SQLiteRunDB(os.path.join(work, "runs.sqlite"),
                     logs_dir=os.path.join(work, "logs"))
    set_run_db(db)
    store_manager.set(db=db)
    saved_env = {key: os.environ.get(key)
                 for key in ("MLT_ARTIFACT_PATH", "MLT_HOME")}
    os.environ["MLT_ARTIFACT_PATH"] = os.path.join(work, "artifacts")
    os.environ["MLT_HOME"] = os.path.join(work, "home")
    saved_journal = SERVING_FLEET_DEFAULTS.get("journal_dir", "")
    SERVING_FLEET_DEFAULTS["journal_dir"] = os.path.join(work, "journal")
    recorder = get_flight_recorder()
    recorder.configure(directory=os.path.join(work, "flight"))
    recorder.clear()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(config, gen, "cuda")
    gen.manual_seed(seed + 3)
    adapters = {name: init_lora_nonzero(config, gen, rank=TUNE_RANK,
                                        alpha=LORA_ALPHA,
                                        b_scale=LORA_B_SCALE, device="cuda")
                for name in ("t1", "t2")}
    tokens, targets = next(synthetic_token_stream(
        TRAIN_BATCH, TRAIN_SEQ, vocab, seed=seed + 7))
    _TUNE.update(config=config, params=params, seed=seed, runs=[],
                 batch=(tokens, targets))
    with torch.no_grad():
        _TUNE["base_checksum"] = [float(leaf.double().sum())
                                  for leaf in tree_leaves(params)]
    shared = _tune_prompts(seed + 11, vocab, 1, TUNE_SHARED, TUNE_SHARED,
                           [])[0]
    ref_prompts = _tune_prompts(seed + 12, vocab, TUNE_REFERENCE,
                                *TUNE_LENS, shared)
    drift_prompts = [_tune_prompts(seed + 13 + w, vocab, TUNE_WINDOW,
                                   *TUNE_LENS, shared) for w in range(2)]
    canary_base = _tune_prompts(seed + 20, vocab, TUNE_CANARY // 4,
                                *TUNE_CANARY_LENS, shared)
    # (c)'s requests: each its own prompt, every one opening with the
    # shared head that t1's stable pages already hold, so that a page of
    # either side is there to be hit by the other
    canary_prompts = _tune_prompts(seed + 21, vocab, TUNE_CANARY,
                                   TUNE_SHARED + 1, TUNE_CANARY_LENS[1],
                                   shared, every=1)
    canary_keys = [f"user-{seed}-{i}" for i in range(TUNE_CANARY)]
    t2_prompt = _tune_prompts(seed + 30, vocab, 1, TUNE_T2_PROMPT,
                              TUNE_T2_PROMPT, [])[0]
    t2_prompts = _tune_prompts(seed + 31, vocab, 16, *TUNE_T2_LENS, shared)

    engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        adapters=adapters, seed=seed, device="cuda",
        latency_window=TUNE_TICK_WINDOW)
    overrides = dict(project=TUNE_PROJECT, retrain_kind="local",
                     retrain_handler=_tune_handler, fraction=TUNE_FRACTION,
                     warmup_s=0.0, vocab_size=vocab)
    controllers = []
    injection = None
    rows = []
    promoted_streams = None
    try:
        # -- the main path, counted: every count reset right before it -----
        _build.reset_launch_counts()
        before = _engine_counters(engine)
        # t2's stream before the loop (no full page: never a prefix hit),
        # and the dark tick baseline on the canary burst's prompts
        t2_before = engine.generate(t2_prompt, max_new_tokens=MAX_NEW,
                                    adapter="t2")[0]
        mark = _tick_mark(engine)
        for prompt in canary_prompts[:TUNE_BASELINE]:
            engine.generate(prompt, max_new_tokens=TUNE_CANARY_NEW,
                            adapter="t2")
        dark_tick_p50 = _tick_p50_since(engine, mark)
        stable_history = {"t1": [], "t2": list(
            canary_prompts[:TUNE_BASELINE])}

        controller = ContinuousTuningController(engine, **overrides).start()
        controllers.append(controller)
        clock = 0.0

        # (a) natural drift: 32 reference requests, two windows of longer
        # outputs; the drift verdicts stay natural
        started = time.perf_counter()
        _tune_burst(engine, ref_prompts, "t1", TUNE_REF_NEW)
        stable_history["t1"] += ref_prompts
        clock += TUNE_TICK_S
        outs = [controller.tick(clock)]
        window_stats = []
        first_drift_at = None
        for window in drift_prompts:
            _tune_burst(engine, window, "t1", TUNE_DRIFT_NEW)
            stable_history["t1"] += window
            clock += TUNE_TICK_S
            outs.append(controller.tick(clock))
            ev = outs[-1]["evaluated"]["t1"]
            window_stats.append({**{k: ev["stats"].get(k) for k in (
                "length_psi", "token_psi", "token_kld", "sample_count")},
                "drifted": ev["drifted"]})
            if ev["drifted"] and first_drift_at is None:
                first_drift_at = (len(outs), time.perf_counter())
        retrains = [a for a in _actions(outs, "t1")
                    if a["action"] == "retrain"]
        submitted_tick = next((i + 1 for i, o in enumerate(outs)
                               if any(a["action"] == "retrain"
                                      for a in o["actions"])), None)
        runs = db.list_runs(project=TUNE_PROJECT)
        run_t1 = _TUNE["runs"][0] if _TUNE["runs"] else {}
        row_a = {
            "phase": "tuning", "leg": "drift", "card": card,
            "model": "llama3-1b", "layers": config.n_layers,
            "reference_requests": TUNE_REFERENCE,
            "window_requests": TUNE_WINDOW,
            "max_new_tokens": [TUNE_REF_NEW, TUNE_DRIFT_NEW],
            "reference_tick": outs[0]["evaluated"]["t1"]["drifted"],
            "windows": window_stats,
            "ticks_first_drift_to_submission":
            None if submitted_tick is None or first_drift_at is None
            else submitted_tick - first_drift_at[0],
            "actions": [a["action"] for a in retrains],
            "checks": {
                "reference_tick_has_no_verdict":
                outs[0]["evaluated"]["t1"]["drifted"] is None,
                "length_psi_over_0.2_both_windows": all(
                    (w["length_psi"] or 0) >= 0.2 and w["drifted"]
                    for w in window_stats),
                "exactly_one_retrain": [a["action"] for a in retrains]
                == ["retrain"] and len(runs) == 1,
            }}
        _tune_check("drift", row_a)
        rows.append(row_a)

        # (b) the retrain run: a completed LoRA run on the card
        stored = db.read_run(retrains[0]["uid"], TUNE_PROJECT) or {}
        results = stored.get("status", {}).get("results", {})
        row_b = {
            "phase": "tuning", "leg": "retrain", "card": card,
            "rank": TUNE_RANK, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TUNE_STEPS, **run_t1,
            "state": stored.get("status", {}).get("state"),
            "results": results,
            "checks": {
                "completed_with_results":
                stored.get("status", {}).get("state") == "completed"
                and {"loss", "step_ms", "adapter"} <= set(results),
                "trained_on_the_served_base":
                run_t1.get("trained_on_the_served_base") is True,
                "base_unchanged": run_t1.get("base_unchanged") is True,
                "finite_loss": all(math.isfinite(x)
                                   for x in run_t1.get("losses", [])),
                "adapter_written": os.path.isfile(
                    run_t1.get("output_path", "")),
            }}
        _tune_check("retrain", row_b)
        rows.append(row_b)

        # (c) canary: the next tick loads the artifact and splits t1
        def pin(stable_id, stable_q, canary_q, drift):
            """Pin the quality stat of ``stable_id`` and of its tenant's
            other versioned ids (the canary) through the monitor.drift
            box; ``drift`` also forces the stable id's verdict."""
            prefix = stable_id.split("@")[0] + "@"

            def action(point, ctx):
                box, adapter = ctx["box"], ctx["adapter"]
                if adapter == stable_id:
                    if drift:
                        box["drifted"] = True
                    box["stats"]["quality_mean"] = stable_q
                elif adapter.startswith(prefix):
                    box["stats"]["quality_mean"] = canary_q
            return chaos.inject(FaultPoints.monitor_drift, action=action)

        injection = pin("t1", 0.5, 0.9, drift=False)
        outs_c, clock = _until(controller, clock, "canary_start", "t1",
                               after=outs)
        canary_started = time.perf_counter()
        split = controller.router.split("t1")
        counted = {side: CANARY_REQUESTS.value(adapter="t1", side=side)
                   for side in ("stable", "canary")}
        mark = _tick_mark(engine)
        sides, prefix_rows = [], []
        canary_history = []
        matches = _record_prefix_owners(engine)
        try:
            for prompt, key in zip(canary_prompts, canary_keys):
                want = controller.router.resolve(
                    "t1", split_key_for(prompt, key))
                seen = len(_peek_samples(controller))
                cached = engine.stats["prefix_cached_tokens"]
                first_match = len(matches)
                engine.generate(prompt, max_new_tokens=TUNE_CANARY_NEW,
                                adapter="t1", request_key=key)
                sample = _peek_samples(controller)[seen:]
                got = sample[-1]["adapter"] if sample else None
                history = canary_history if want[1] == "canary" \
                    else stable_history["t1"]
                hit = engine.stats["prefix_cached_tokens"] - cached
                owners = sorted({o for m in matches[first_match:]
                                 for o in m["owners"]})
                prefix_rows.append({"side": want[1], "id": want[0],
                                    "cached": hit, "owners": owners,
                                    "bound": _page_bound(prompt, history)})
                history.append(prompt)
                sides.append((want, got))
        finally:
            del engine._prefix.match
        armed_tick_p50 = _tick_p50_since(engine, mark)
        metered = {side: CANARY_REQUESTS.value(adapter="t1", side=side)
                   - counted[side] for side in counted}
        outs_p, clock = _until(controller, clock, "promote", "t1")
        promote_s = time.perf_counter()
        decisions = [o["evaluated"].get("t1", {}).get("canary")
                     for o in outs_c + outs_p]
        injection.remove()
        injection = None
        resident = engine._adapters.resident_names()
        promoted_streams = [engine.generate(p, max_new_tokens=MAX_NEW,
                                            adapter="t1")[0]
                            for p in canary_base[:4]]
        per_side = {side: [r for r in prefix_rows if r["side"] == side]
                    for side in ("stable", "canary")}
        row_c = {
            "phase": "tuning", "leg": "canary", "card": card,
            "split": None if split is None else [split.canary,
                                                 split.fraction],
            "requests": TUNE_CANARY,
            "sides": {side: len(rs) for side, rs in per_side.items()},
            "metered": metered,
            "prefix_cached_tokens": {side: sum(r["cached"] for r in rs)
                                     for side, rs in per_side.items()},
            "prefix_page_owners": {side: sorted({o for r in rs
                                                 for o in r["owners"]})
                                   for side, rs in per_side.items()},
            "decisions": decisions,
            "ticks_canary_to_promote": len(outs_p),
            "dark_tick_p50_s": dark_tick_p50,
            "armed_tick_p50_s": armed_tick_p50,
            "detection_to_promotion_s":
            promote_s - first_drift_at[1] if first_drift_at else None,
            "canary_to_promotion_s": promote_s - canary_started,
            "stable_id": controller.router.stable_id("t1"),
            "resident": sorted(resident),
            "checks": {
                "split_installed": split is not None
                and split.canary == "t1@v1"
                and split.fraction == TUNE_FRACTION,
                "sides_equal_the_hash": all(
                    got == want[0] for want, got in sides),
                "both_sides_served": all(per_side.values()),
                "metered_by_side": metered == {
                    side: float(len(rs)) for side, rs in per_side.items()},
                "distinct_prompts": len({tuple(p) for p in canary_prompts})
                == TUNE_CANARY,
                "no_prefix_page_across_sides": all(
                    r["cached"] <= r["bound"]
                    and set(r["owners"]) <= {r["id"]}
                    for r in prefix_rows),
                "own_side_prefix_hits": all(
                    sum(r["cached"] for r in rs) > 0
                    for rs in per_side.values()),
                "promoted_after_promote_ticks":
                decisions[-controller.promote_ticks:]
                == ["better"] * controller.promote_ticks,
                "stable_is_the_canary":
                controller.router.stable_id("t1") == "t1@v1"
                and controller.router.split("t1") is None,
                "old_factors_evicted": "t1" not in resident
                and "t1" in engine._adapters.sources,
            }}
        _tune_check("canary", row_c)
        rows.append(row_c)

        # (d) rollback: injected drift on t2 → a second retrain run on the
        # card → its canary pinned worse → rollback with a post-mortem
        def serve_t2():
            _tune_burst(engine, t2_prompts[:8], "t2", TUNE_CANARY_NEW,
                   keys=[f"t2-{clock}-{i}" for i in range(8)])

        serve_t2()
        injection = pin("t2", 0.9, 0.2, drift=True)
        outs_d, clock = _until(controller, clock, "retrain", "t2", serve_t2)
        outs_d2, clock = _until(controller, clock, "canary_start", "t2",
                                after=outs_d)
        outs_d3, clock = _until(controller, clock, "rollback", "t2",
                                serve_t2)
        injection.remove()
        injection = None
        rollback = _actions(outs_d3, "t2")[-1]
        lines = [json.loads(line) for line in open(rollback["post_mortem"])]
        kinds = [e["kind"] for e in lines[1:] if e.get("adapter") == "t2"]
        chain = ["tune.submitted", "tune.completed", "canary.start",
                 "canary.rollback"]
        worse = [o["evaluated"].get("t2", {}).get("canary") for o in outs_d3]
        t2_after = engine.generate(t2_prompt, max_new_tokens=MAX_NEW,
                                   adapter="t2")[0]
        row_d = {
            "phase": "tuning", "leg": "rollback", "card": card,
            "retrain": _TUNE["runs"][1] if len(_TUNE["runs"]) > 1 else None,
            "decisions": worse, "reason": rollback["reason"],
            "post_mortem_kinds": kinds,
            "checks": {
                "second_run_completed": [r["status"]["state"] for r in
                                         db.list_runs(project=TUNE_PROJECT)]
                == ["completed"] * 2,
                "rolled_back_after_rollback_ticks":
                worse[-controller.rollback_ticks:]
                == ["worse"] * controller.rollback_ticks,
                "chain_in_order": all(k in kinds for k in chain) and [
                    kinds.index(k) for k in chain] == sorted(
                    kinds.index(k) for k in chain),
                "split_cleared": controller.router.split("t2") is None
                and controller.router.stable_id("t2") == "t2"
                and "t2@v1" not in engine._adapters.sources,
                "t2_stream_unchanged": t2_after == t2_before,
            }}
        _tune_check("rollback", row_d)
        rows.append(row_d)

        # (e) restart mid-canary: a third retrain of t1 (past its
        # cooldown), its canary live and held (its quality within the
        # budget's promote and breach bands), then a new controller on
        # the journal
        clock += controller.cooldown_s
        injection = pin("t1@v1", 0.5, 0.3, drift=True)

        def serve_t1():
            _tune_burst(engine, canary_base[:4], "t1", TUNE_CANARY_NEW)

        outs_e, clock = _until(controller, clock, "retrain", "t1", serve_t1)
        outs_e2, clock = _until(controller, clock, "canary_start", "t1",
                                after=outs_e)
        keys = [f"restart-{i}" for i in range(TUNE_RESTART_KEYS)]
        sides_before = {k: controller.router.resolve("t1", k) for k in keys}
        split_before = controller.router.split("t1")
        # probes: TUNE_PROBES keys of each side, each with its own prompt of
        # no full page (never a prefix hit), served before and after
        probe_keys = [k for side in ("stable", "canary") for k in [
            k for k in keys if sides_before[k][1] == side][:TUNE_PROBES]]
        probe_prompts = _tune_prompts(seed + 40, vocab, len(probe_keys),
                                      TUNE_T2_PROMPT, TUNE_T2_PROMPT, [])

        def probe(ctl) -> list:
            served = []
            for prompt, key in zip(probe_prompts, probe_keys):
                seen = len(_peek_samples(ctl))
                tokens = engine.generate(
                    prompt, max_new_tokens=TUNE_CANARY_NEW, adapter="t1",
                    request_key=key)[0]
                sample = _peek_samples(ctl)[seen:]
                served.append({"key": key, "tokens": tokens,
                               "adapter": sample[-1]["adapter"]
                               if sample else None})
            return served

        probes_before = probe(controller)
        controller.stop()
        controller._journal.close()
        runs_before = len(db.list_runs(project=TUNE_PROJECT))
        # a fresh process holds no canary: the restart reloads it from its
        # artifact, and a failed reload is logged (a warning) and swallowed
        engine.retire_adapter("t1@v2")
        retired = "t1@v2" not in engine._adapters.sources
        warnings = _WarningRecords()
        logging.getLogger("mlrun_tpu_torch").addHandler(warnings)
        try:
            restarted = ContinuousTuningController(engine,
                                                   **overrides).start()
        finally:
            logging.getLogger("mlrun_tpu_torch").removeHandler(warnings)
        controllers.append(restarted)
        split_after = restarted.router.split("t1")
        sides_after = {k: restarted.router.resolve("t1", k) for k in keys}
        probes_after = probe(restarted)
        outs_r = []
        for _ in range(2):
            serve_t1()
            clock += TUNE_TICK_S
            outs_r.append(restarted.tick(clock))
        injection.remove()
        injection = None
        row_e = {
            "phase": "tuning", "leg": "restart", "card": card,
            "split": [split_before.canary, split_before.fraction],
            "adopted": None if split_after is None
            else [split_after.canary, split_after.fraction],
            "keys": len(keys), "actions_after": _actions(outs_r),
            "warnings": warnings.messages,
            "probes": [{"key": b["key"], "side": sides_before[b["key"]][1],
                        "before": b["adapter"], "after": a["adapter"],
                        "same_stream": a["tokens"] == b["tokens"]}
                       for b, a in zip(probes_before, probes_after)],
            "checks": {
                "canary_retired_before_restart": retired,
                "canary_reloaded_from_its_artifact":
                "t1@v2" in engine._adapters.sources
                and not warnings.messages,
                "probes_reach_their_side": all(
                    p["adapter"] == sides_before[p["key"]][0]
                    for p in probes_before + probes_after)
                and {sides_before[p["key"]][0] for p in probes_after}
                == {"t1@v1", "t1@v2"},
                "probe_streams_unchanged": [p["tokens"]
                                            for p in probes_after]
                == [p["tokens"] for p in probes_before],
                "split_adopted": split_after is not None
                and split_after.canary == split_before.canary == "t1@v2"
                and split_after.fraction == split_before.fraction,
                "same_side_every_key": sides_after == sides_before,
                "both_sides_present": {s for _, s in sides_after.values()}
                == {"stable", "canary"},
                "submits_nothing": not any(
                    a["action"] == "retrain" for a in _actions(outs_r))
                and len(db.list_runs(project=TUNE_PROJECT)) == runs_before,
            }}
        _tune_check("restart", row_e)
        rows.append(row_e)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        delta = _counter_delta(engine, before)
        t1_path = _TUNE["runs"][0]["output_path"]
        engine_stats = engine.stats
    finally:
        if injection is not None:
            injection.remove()
        for c in controllers:
            c.stop()
            if c._journal is not None:
                c._journal.close()
        set_canary_router(None)
        set_sample_observer(None)
        engine.stop()
        SERVING_FLEET_DEFAULTS["journal_dir"] = saved_journal
        recorder.configure(directory="")

    # every kernel's launches, exactly: the serving kernels as the engine's
    # counters say, the training flash as the three retrain runs' passes
    n_runs = len(_TUNE["runs"])
    passes = n_runs * (TUNE_STEPS + 1)
    layers = config.n_layers
    want = {"paged_decode": layers * delta["attn_kernel_ticks"],
            "paged_prefill": layers * delta["prefill_kernel_chunks"],
            "flash_fwd_cached": layers * delta["prefill_chunks"],
            "flash_fwd": 2 * layers * passes, "flash_bwd": layers * passes}
    _exact_launches("tuning", launches, want)
    if engine_stats["attn_gather_ticks"] or \
            engine_stats["prefill_gather_admissions"]:
        fail("tuning: an adapter row fell back to the dense gather")

    # the promoted tenant against an engine on merge_lora(base, retrained)
    retrained = load_adapter(t1_path)
    lora = {target: {key: torch.as_tensor(value, device="cuda")
                     for key, value in parts.items()}
            for target, parts in retrained.items()}
    merged = merge_lora(params, lora)
    _, ref_out = _merged_reference(config, merged, seed, canary_base[:4])
    checks = [_stream_check(config, merged, p, got, ref)
              for p, got, ref in zip(canary_base[:4], promoted_streams,
                                     ref_out)]
    del merged
    _release()
    row = {
        "phase": "tuning", "leg": "promoted_vs_merged", "card": card,
        "streams": checks, "rel_tol": SPEC_REL_TOL,
        "checks": {
            "ties_only": all(c["tie_at_departure_rel"] is None
                             or c["tie_at_departure_rel"] <= SPEC_REL_TOL
                             for c in checks),
            "near_argmax": all(c["worst_argmax_gap_rel"] <= SPEC_REL_TOL
                               for c in checks),
        }}
    _tune_check("promoted_vs_merged", row)
    endpoint = _tuning_endpoint_leg(seed, card, db, canary_base)
    for name, count in endpoint["launches"].items():
        launches[name] = launches.get(name, 0) + count
    shutil.rmtree(work, ignore_errors=True)
    set_run_db(None)
    store_manager._db = None
    for key, value in saved_env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    emit({"phase": "tuning", "card": card,
          "seconds": time.perf_counter() - phase_started,
          "retrain_runs": n_runs,
          "retrain_step_ms": [r["step_ms"] for r in _TUNE["runs"]],
          "retrain_run_s": [r["run_s"] for r in _TUNE["runs"]],
          "dark_tick_p50_s": dark_tick_p50,
          "armed_tick_p50_s": armed_tick_p50,
          "detection_to_promotion_s": row_c["detection_to_promotion_s"],
          "canary_requests_total": {
              side: CANARY_REQUESTS.value(adapter="t1", side=side)
              for side in ("stable", "canary")},
          "endpoint_latency_p50_microsec": endpoint["latency_p50_microsec"],
          "launches": launches, "loop_expected_launches": want})
    _TUNE.clear()
    return launches


# ---------------------------------------------------------------------------
# phase 20: projects — the pod's own program (the port's CLI) in child
# processes: the tpujob JobSet's command under torchrun and a project's
# two-step workflow through `project --run` (the 8B `serve` child is the
# service phase's deployed gateway)
# ---------------------------------------------------------------------------

PROJ_PROJECT = "pods"
PROJ_TRAIN_MODEL = "llama3-1b"  # the runs' model (full width)
PROJ_TPUJOB_LAYERS = 2      # (a): the tpujob pod's depth (the service's cut)
PROJ_STEPS = 4              # (a): steps after the warmup pass
PROJ_LORA_STEPS = 4         # (b): step 1's LoRA fit at B4 x 2048
PROJ_LORA_RANK = 16
PROJ_LORA_LR = 5e-3
PROJ_LOSS_REL_TOL = 1e-5    # (a): the pod's losses against in-process ones
PROJ_CHILD_TIMEOUT = 600.0
PROJ_RESULT_KEYS = ("losses", "launches", "torch_import_s",
                    "kernel_load_s", "device")

# (a): the pod's handler, carried by MLT_EXEC_CODE (user code: the 1B
# trainer through auto_trainer.train, its per-step losses and the kernel
# launches of its run logged as results)
PROJ_TRAIN_CODE = '''
import sys
import time


def train(context, device_check: bool = True, **params):
    """auto_trainer.train in the pod, with its per-step losses, the
    kernels' launches and the process's torch import and kernel load."""
    preloaded = "torch" in sys.modules
    started = time.perf_counter()
    import torch
    torch_import_s = time.perf_counter() - started

    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.ops import _build

    kernel_load_s = None
    if device_check:
        torch.cuda.init()
        started = time.perf_counter()
        _build.library()
        kernel_load_s = time.perf_counter() - started
    losses = []

    def record(step, metrics, trainer):
        losses.append(float(metrics["loss"]))
        print(f"pod step {step} loss {losses[-1]!r}")

    _build.reset_launch_counts()
    auto_trainer.train(context=context, callbacks=[record], **params)
    if device_check:
        torch.cuda.synchronize()
    context.log_results({
        "losses": losses,
        "launches": {k: v for k, v in _build.launch_counts().items() if v},
        "torch_import_s": None if preloaded else torch_import_s,
        "kernel_load_s": kernel_load_s,
        "device": torch.cuda.get_device_name(0) if device_check else "cpu"})
'''

# (b): the project's function file and its workflow
PROJ_STEPS_CODE = '''import sys

sys.path.insert(0, {here!r})
import chip_smoke  # noqa: E402


def train_adapter(context, seed: int = 0, steps: int = 4):
    """A rank-16 LoRA adapter on the 1B base, logged as a model."""
    chip_smoke._proj_train_adapter(context, seed, steps)


def decode(context, adapter: str = "", seed: int = 0):
    """Greedy decoding under the adapter, held to the merged weights."""
    chip_smoke._proj_decode(context, adapter, seed)
'''

PROJ_WORKFLOW_CODE = '''from mlrun_tpu_torch.projects import get_current_project


def pipeline(seed="0", steps="4"):
    proj = get_current_project()
    train = proj.run_function("train-adapter",
                              params={"seed": int(seed),
                                      "steps": int(steps)})
    proj.run_function("decode", params={"adapter": train.output("adapter"),
                                        "seed": int(seed)}).after(train)
'''

def _proj_check(leg: str, row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"projects ({leg}): {bad}")


def _proj_env(work: str, **extra) -> dict:
    """A child's environment: this interpreter as the PATH's python3 and
    torchrun (the image's programs), the checkout importable, no rank."""
    import stat

    shim = os.path.join(work, "bin")
    if not os.path.isdir(shim):
        os.makedirs(shim)
        for name, body in (
                ("python3", f'exec {sys.executable} "$@"'),
                ("torchrun", f'exec {sys.executable} -m torch.distributed.run '
                             '"$@"')):
            path = os.path.join(shim, name)
            with open(path, "w") as fp:
                fp.write(f"#!/bin/sh\n{body}\n")
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    env = dict(os.environ)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", "SERVING_SPEC_ENV",
                 "MLT_EXEC_CODE", "MLT_EXEC_CONFIG"):
        env.pop(name, None)
    env["PATH"] = f"{shim}:{env.get('PATH', '')}"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def _proj_cli(args: list, env: dict, leg: str, timeout=PROJ_CHILD_TIMEOUT):
    """``python3 -m mlrun_tpu_torch <args>`` in a child: (stdout, seconds)."""
    started = time.perf_counter()
    proc = subprocess.run(["python3", "-m", "mlrun_tpu_torch"] + args,
                          env=env, cwd=HERE, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - started
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        fail(f"projects ({leg}): `{' '.join(args)}` exited "
             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def _proj_train_params(seed: int, work: str) -> dict:
    return {"model": PROJ_TRAIN_MODEL,
            "model_overrides": {"n_layers": PROJ_TPUJOB_LAYERS},
            "batch_size": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ, "steps": PROJ_STEPS, "log_every": 1,
            "seed": seed, "model_name": RUNS_MODEL,
            "checkpoint_dir": os.path.join(work, "checkpoints")}


def _proj_tpujob_leg(seed: int, card: str, work: str, db) -> dict:
    """(a) the tpujob JobSet's own container command, under /bin/sh with
    the JobSet's env resolved as pod 0 of slice 0 (one node, one GPU,
    MASTER_ADDR 127.0.0.1): torchrun runs ``python3 -m mlrun_tpu_torch
    run --from-env``, which runs the 1B-width trainer at 2 layers; the run
    read back from the SQLite db, its losses against an in-process fit of
    the seed."""
    import base64
    import socket

    import torch

    from mlrun_tpu_torch import new_function
    from mlrun_tpu_torch.artifacts import ModelArtifact, get_model
    from mlrun_tpu_torch.config import EXEC_CODE_ENV
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.model import RunObject, new_task
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.ops import _build

    config = MODEL_PRESETS[PROJ_TRAIN_MODEL](n_layers=PROJ_TPUJOB_LAYERS)
    params = _proj_train_params(seed, work)
    fn = new_function("train", kind="tpujob", project=PROJ_PROJECT)
    fn.with_gpus(nodes=1, gpus_per_node=1)
    run = RunObject.from_template(new_task(
        name="train", project=PROJ_PROJECT, handler="train", params=params,
        artifact_path=os.path.join(work, "artifacts")))
    run.metadata.uid = "a0" + os.urandom(15).hex()
    jobset = fn.generate_jobset(run, extra_env={
        EXEC_CODE_ENV: base64.b64encode(PROJ_TRAIN_CODE.encode()).decode()})
    job = jobset["spec"]["replicatedJobs"][0]["template"]["spec"]
    main = job["template"]["spec"]["containers"][0]
    program = list(main["command"]) + list(main["args"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    resolved = {}
    for entry in main["env"]:
        # the pod's field references: the completion and job indexes of
        # pod 0 of slice 0
        resolved[entry["name"]] = entry.get("value", "0")
    resolved.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env = _proj_env(work, **resolved)

    started = time.perf_counter()
    proc = subprocess.run(program, env=env, cwd=HERE, capture_output=True,
                          text=True, timeout=PROJ_CHILD_TIMEOUT)
    pod_s = time.perf_counter() - started
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        fail(f"projects (tpujob): the JobSet's command exited "
             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")
    uid = run.metadata.uid
    stored = db.read_run(uid, PROJ_PROJECT) or {}
    status = stored.get("status", {})
    results = status.get("results", {})
    log_state, log = db.get_log(uid, PROJ_PROJECT)
    model_uri = f"store://models/{PROJ_PROJECT}/{RUNS_MODEL}"
    model_file, spec, _ = get_model(model_uri)

    # the same fit in this process, from the same seed
    losses = []
    started = time.perf_counter()
    auto_trainer.train(context=None, callbacks=[
        lambda step, metrics, trainer: losses.append(
            float(metrics["loss"]))],
        **{k: v for k, v in params.items()
           if k not in ("checkpoint_dir", "device_check")})
    torch.cuda.synchronize()
    in_process_s = time.perf_counter() - started
    pod_losses = results.get("losses") or []
    rel = [abs(a - b) / abs(b) for a, b in zip(pod_losses, losses)]
    passes = PROJ_STEPS + 1     # the warmup's pass and every step
    want = {"flash_fwd": 2 * config.n_layers * passes,
            "flash_bwd": config.n_layers * passes}
    launches = results.get("launches") or {}
    step_ms = (TRAIN_BATCH * TRAIN_SEQ / results["tokens_per_sec"] * 1e3
               if results.get("tokens_per_sec") else None)
    row = {
        "phase": "projects", "leg": "tpujob", "card": card,
        "model": PROJ_TRAIN_MODEL, "layers": config.n_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": PROJ_STEPS,
        "container_command": main["command"][:2] + ["..."],
        "container_args": main["args"],
        "uid": uid, "state": status.get("state"),
        "error": status.get("error"), "pod_s": pod_s,
        "in_process_s": in_process_s, "step_ms": step_ms,
        "pod_losses": pod_losses, "in_process_losses": losses,
        "loss_max_rel": max(rel) if rel else None,
        "losses_bit_equal": pod_losses == losses,
        "torch_import_s": results.get("torch_import_s"),
        "kernel_load_s": results.get("kernel_load_s"),
        "launches": launches, "expected_launches": want,
        "log": log.decode(errors="replace")[-300:],
        "model_file": model_file,
        "checks": {
            "the_ports_cli": main["args"] == ["python3", "-m",
                                              "mlrun_tpu_torch", "run",
                                              "--from-env"]
            and "mlrun-tpu" not in json.dumps(main["command"]),
            "one_node_one_gpu": resolved.get("NNODES") == "1"
            and resolved.get("NPROC_PER_NODE") == "1"
            and main["resources"]["limits"].get("nvidia.com/gpu") == 1,
            "completed": status.get("state") == "completed"
            and log_state == "completed",
            "ran_on_the_card":
            results.get("device") == torch.cuda.get_device_name(0),
            "results_logged": {"loss", "tokens_per_sec", "losses"}
            <= set(results),
            "log_holds_each_step": log.count(b"pod step ") == PROJ_STEPS,
            "model_artifact": isinstance(spec, ModelArtifact)
            and os.path.abspath(model_file)
            == os.path.abspath(params["checkpoint_dir"]),
            "losses_equal_in_process": len(pod_losses) == PROJ_STEPS
            == len(losses) and max(rel) <= PROJ_LOSS_REL_TOL,
            "flash_launches": launches == want,
        }}
    _proj_check("tpujob", row)
    return row


def _proj_train_adapter(context, seed: int, steps: int):
    """Workflow step 1 (in the `project --run` child): a rank-16 LoRA fit
    on the seeded 1B base at B4 x 2048, the adapter written with
    save_adapter and logged as the model "adapter"; its kernel launches
    and per-step losses logged as results."""
    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.adapters import save_adapter
    from mlrun_tpu_torch.training import TrainConfig, Trainer
    from mlrun_tpu_torch.training.data import synthetic_token_stream

    config = MODEL_PRESETS[PROJ_TRAIN_MODEL]()
    params = init_params(config, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    batch = next(synthetic_token_stream(TRAIN_BATCH, TRAIN_SEQ,
                                        config.vocab_size, seed=seed))

    def repeated():
        while True:
            yield batch

    _build.reset_launch_counts()
    trainer = Trainer(config, TrainConfig(
        learning_rate=PROJ_LORA_LR, warmup_steps=0, total_steps=steps,
        loss_chunk=LOSS_CHUNK, lora_rank=PROJ_LORA_RANK), device="cuda")
    trainer.init(seed, params=params)
    trainer.warmup(TRAIN_BATCH, TRAIN_SEQ)
    trainer.fit(repeated(), steps, log_every=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    history = trainer.metrics_history
    os.makedirs(context.artifact_path, exist_ok=True)
    path = os.path.join(context.artifact_path, "adapter.npz")
    save_adapter(path, trainer.state.lora)
    context.log_model("adapter", model_file=path, framework="lora",
                      parameters={"rank": PROJ_LORA_RANK, "steps": steps})
    context.log_results({
        "losses": [float(view["loss"]) for view in history],
        "step_ms": TRAIN_BATCH * TRAIN_SEQ
        / history[-1]["tokens_per_sec"] * 1e3,
        "launches": launches, "layers": config.n_layers})


def _proj_decode(context, adapter: str, seed: int):
    """Workflow step 2: the adapter step 1 logged (a store:// uri, from
    ``step1.output("adapter")``) on a 1B paged engine, the serve prompts
    decoded greedily under it, held to an engine on the merged weights
    (first-token logits, streams until a near-tie, as the lora phase
    holds its tenants)."""
    import torch

    from mlrun_tpu_torch.artifacts import get_model
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.models.lora import merge_lora
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.serving.adapters import load_adapter
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    config = MODEL_PRESETS[PROJ_TRAIN_MODEL]()
    params = init_params(config, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    model_file, _, _ = get_model(adapter)
    tree = {target: {key: torch.as_tensor(value, device="cuda")
                     for key, value in parts.items()}
            for target, parts in load_adapter(model_file).items()}
    prompts = _prompts(seed, config.vocab_size)
    engine = PagedContinuousBatchingEngine(
        config, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
        seed=seed, device="cuda", adapters={"tuned": tree})
    logits: list = []
    _record_first_logits(engine, logits)
    _build.reset_launch_counts()
    futures = [engine.submit(p, max_new_tokens=MAX_NEW, adapter="tuned")
               for p in prompts]
    out = [f.result(timeout=600)[0] for f in futures]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    stats = engine.stats
    engine.stop()
    merged = merge_lora(params, tree)
    ref_logits, ref_out = _merged_reference(config, merged, seed, prompts)
    streams = [_stream_check(config, merged, p, o, r)
               for p, o, r in zip(prompts, out, ref_out)]
    rel_err, first_same, share = _compare(logits, out, ref_logits, ref_out)
    context.log_results({
        "launches": launches, "layers": config.n_layers,
        "attn_kernel_ticks": stats["attn_kernel_ticks"],
        "attn_gather_ticks": stats["attn_gather_ticks"],
        "prefill_gather_admissions": stats["prefill_gather_admissions"],
        "prefill_chunks": stats["prefill_chunks"],
        "tokens": [len(o) for o in out],
        "vs_merged_first_logits_max_rel_err": rel_err,
        "vs_merged_first_tokens_identical": first_same,
        "vs_merged_greedy_token_share_identical": share,
        "streams": streams})


def _proj_workflow_leg(seed: int, card: str, work: str, db) -> dict:
    """(b) a project directory (project.yaml from new_project().save(), a
    function file whose two functions are saved to the run db with their
    code embedded, a workflow file) run by ``python3 -m mlrun_tpu_torch
    project <dir> --run main`` in a child; then ``get runs`` and ``logs
    <uid>`` in children read both runs back."""
    from mlrun_tpu_torch import code_to_function, new_project

    directory = os.path.join(work, "project")
    os.makedirs(directory)
    steps_file = os.path.join(directory, "steps.py")
    with open(steps_file, "w") as fp:
        fp.write(PROJ_STEPS_CODE.format(here=HERE))
    with open(os.path.join(directory, "workflow.py"), "w") as fp:
        fp.write(PROJ_WORKFLOW_CODE)
    project = new_project(PROJ_PROJECT, context=directory, save=False)
    for name, handler in (("train-adapter", "train_adapter"),
                          ("decode", "decode")):
        fn = code_to_function(name, project=PROJ_PROJECT,
                              filename=steps_file, kind="job",
                              handler=handler)
        project.set_function(fn, name=name)
        fn.save()
    project.set_workflow("main", "workflow.py")
    project.save()
    env = _proj_env(work)
    out, project_s = _proj_cli(
        ["project", directory, "--run", "main", "-x", f"seed={seed}",
         "-x", f"steps={PROJ_LORA_STEPS}"], env, "workflow")
    runs = {r["metadata"]["name"]: r
            for r in db.list_runs(project=PROJ_PROJECT)
            if r["metadata"]["name"] in ("train-adapter", "decode")}
    listed, get_s = _proj_cli(["get", "runs", "-p", PROJ_PROJECT], env,
                              "get runs")
    logs = {}
    for name, run in runs.items():
        text, _ = _proj_cli(["logs", run["metadata"]["uid"], "-p",
                             PROJ_PROJECT], env, "logs")
        logs[name] = text
    train = runs.get("train-adapter", {}).get("status", {})
    decode = runs.get("decode", {}).get("status", {})
    tr, dr = train.get("results", {}), decode.get("results", {})
    layers = tr.get("layers", 0)
    passes = PROJ_LORA_STEPS + 1
    want = {"flash_fwd": 2 * layers * passes, "flash_bwd": layers * passes}
    adapter_uri = (train.get("artifact_uris") or {}).get("adapter", "")
    decode_spec = runs.get("decode", {}).get("spec", {})
    streams = dr.get("streams") or []
    launches = {}
    for counts in (tr.get("launches") or {}, dr.get("launches") or {}):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    row = {
        "phase": "projects", "leg": "workflow", "card": card,
        "model": PROJ_TRAIN_MODEL, "layers": layers,
        "lora_rank": PROJ_LORA_RANK, "lora_steps": PROJ_LORA_STEPS,
        "project_s": project_s, "get_runs_s": get_s,
        "cli_out": out.strip().splitlines()[-3:],
        "states": {n: r.get("status", {}).get("state")
                   for n, r in runs.items()},
        "adapter_uri": adapter_uri, "train_losses": tr.get("losses"),
        "lora_step_ms": tr.get("step_ms"),
        "train_launches": tr.get("launches"), "train_expected": want,
        "decode_launches": dr.get("launches"),
        "vs_merged_first_logits_max_rel_err":
        dr.get("vs_merged_first_logits_max_rel_err"),
        "first_logits_rel_tol": LOGIT_REL_TOL,
        "vs_merged_first_tokens_identical":
        dr.get("vs_merged_first_tokens_identical"),
        "vs_merged_greedy_token_share_identical":
        dr.get("vs_merged_greedy_token_share_identical"),
        "streams": streams, "launches": launches,
        "checks": {
            "cli_lines": f"project loaded: {PROJ_PROJECT}" in out
            and "workflow main: completed" in out,
            "both_steps_completed": train.get("state") == "completed"
            and decode.get("state") == "completed",
            "step2_took_step1s_output": bool(adapter_uri)
            and decode_spec.get("parameters", {}).get("adapter")
            == adapter_uri,
            "get_runs_lists_both": all(
                f"{n:24} completed" in listed for n in runs)
            and len(runs) == 2,
            "logs_read_back": all("final state: completed" in t
                                  for t in logs.values()) and len(logs) == 2,
            "lora_flash_launches": tr.get("launches") == want,
            "adapter_on_the_paged_kernels": all(
                (dr.get("launches") or {}).get(k, 0) > 0
                for k in SERVING_KERNELS)
            and dr.get("attn_gather_ticks") == 0
            and dr.get("prefill_gather_admissions") == 0,
            "tokens": dr.get("tokens") == [MAX_NEW] * 4,
            "first_logits_within_tol":
            dr.get("vs_merged_first_logits_max_rel_err") is not None
            and dr["vs_merged_first_logits_max_rel_err"] <= LOGIT_REL_TOL,
            "streams_equal_until_near_tie": len(streams) == 4 and all(
                s["tie_at_departure_rel"] is None
                or s["tie_at_departure_rel"] <= SPEC_REL_TOL
                for s in streams),
            "near_argmax": len(streams) == 4 and all(
                s["worst_argmax_gap_rel"] <= SPEC_REL_TOL for s in streams),
        }}
    _proj_check("workflow", row)
    return row


def phase_projects(seed: int, card: str) -> dict:
    """The pod's own program on the card, every leg a child process over
    the kernel build the build phase left (a temporary SQLite run db and
    MLT_HOME): (a) the tpujob JobSet's command, (b) a two-step workflow
    through `project --run`. Returns the kernels' launches summed over the
    children's main paths."""
    import shutil
    import tempfile

    from mlrun_tpu_torch.datastore import store_manager
    from mlrun_tpu_torch.db import get_run_db, set_run_db

    work = tempfile.mkdtemp(prefix="mlt-projects-")
    saved = {k: os.environ.get(k) for k in ("MLT_DBPATH", "MLT_HOME")}
    os.environ["MLT_DBPATH"] = os.path.join(work, "runs.sqlite")
    os.environ["MLT_HOME"] = os.path.join(work, "home")
    set_run_db(None)
    store_manager._db = None
    started = time.perf_counter()
    launches: dict = {}
    try:
        db = get_run_db()
        rows = [_proj_tpujob_leg(seed, card, work, db)]
        _release()
        rows.append(_proj_workflow_leg(seed, card, work, db))
        _release()
        for row in rows:
            for name, count in row["launches"].items():
                launches[name] = launches.get(name, 0) + count
        emit({"phase": "projects", "card": card,
              "seconds": time.perf_counter() - started,
              "leg_seconds": {"tpujob_pod": rows[0]["pod_s"],
                              "tpujob_in_process": rows[0]["in_process_s"],
                              "workflow": rows[1]["project_s"]},
              "child_torch_import_s": {
                  "tpujob": rows[0]["torch_import_s"]},
              "child_kernel_load_s": {
                  "tpujob": rows[0]["kernel_load_s"]},
              "tpujob_step_ms": rows[0]["step_ms"],
              "launches": launches})
    finally:
        set_run_db(None)
        store_manager._db = None
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- service: a tpujob run submitted over HTTP, killed and resumed ------------

SVC_PROJECT = "svc"
SVC_MODEL = "llama3-1b"     # the run's model: its full width ...
SVC_LAYERS = 2              # ... at 2 layers (observe's JobSet child's cut)
SVC_STEPS = 4               # steps after the warmup pass
SVC_CKPT_EVERY = 2          # the kill lands after step 2's checkpoint
SVC_MONITOR_S = 0.5         # the service's monitor loop period
SVC_TIMEOUT = 300.0         # each wait of the phase
SVC_MARK = "svc-pod"        # the children's log lines start with it

# the run's handler, carried by MLT_EXEC_CODE: auto_trainer.train with a
# checkpoint every SVC_CKPT_EVERY steps (its CheckpointCallback records
# status.checkpoint). The resume env (MLT_RESUME_STEP) says how many
# batches the run already took: the stream skips them and the fit runs
# the remaining steps. The first attempt parks its input stream at the
# batch after its first checkpoint, so the kill lands between that
# checkpoint and the next step. Its lines go to stderr, which the
# service's provider pumps into the run's log as they come (the run
# context holds stdout until the handler returns, and a killed child
# never returns).
SVC_TRAIN_CODE = """
import json
import sys
import time


def train(context, steps: int = 4, park_after: int = 2,
          device_check: bool = True, **params):
    preloaded = "torch" in sys.modules
    started = time.perf_counter()
    import torch
    torch_import_s = None if preloaded else time.perf_counter() - started

    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.ops import _build
    from mlrun_tpu_torch.training import checkpoint

    kernel_load_s = None
    if device_check:
        torch.cuda.init()
        started = time.perf_counter()
        _build.library()
        kernel_load_s = time.perf_counter() - started
    directive = checkpoint.resume_directive()
    done = int(directive[1]) if directive and directive[1] else 0
    attempt = 1 if directive else 0
    restore_s = []
    restore = checkpoint.CheckpointManager.restore

    def timed_restore(self, *args, **kwargs):
        started = time.perf_counter()
        state = restore(self, *args, **kwargs)
        if device_check:
            torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - started)
        return state

    checkpoint.CheckpointManager.restore = timed_restore
    make_stream = auto_trainer._make_stream

    def stream(*args, **kwargs):
        source = make_stream(*args, **kwargs)
        for _ in range(done):
            next(source)
        for served, batch in enumerate(source):
            if directive is None and served == park_after:
                time.sleep(3600)
            yield batch

    auto_trainer._make_stream = stream
    out = {"attempt": attempt, "resume_step": done, "losses": [],
           "step_t": [], "torch_import_s": torch_import_s,
           "kernel_load_s": kernel_load_s,
           "device": torch.cuda.get_device_name(0) if device_check
           else "cpu"}

    def report(final):
        if device_check:
            torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in _build.launch_counts().items()
                           if v}
        out["restore_s"] = restore_s
        out["final"] = final
        print("MARK result " + json.dumps(out), file=sys.stderr,
              flush=True)

    def record(step, metrics, trainer):
        out["losses"].append(float(metrics["loss"]))
        out["step_t"].append(time.time())
        print(f"MARK attempt {attempt} step {metrics['step']} loss "
              f"{out['losses'][-1]!r}", file=sys.stderr, flush=True)
        if directive is None and metrics["step"] == park_after:
            report(False)

    _build.reset_launch_counts()
    auto_trainer.train(context=context, steps=steps - done,
                       callbacks=[record], resume=False, **params)
    report(True)
""".replace("MARK", SVC_MARK)


# the deploy leg: a serving function deployed through the service. Its
# route class travels as spec.build.functionSourceCode (MLT_EXEC_CODE in
# the deployed gateway): it wraps LLMModelServer and answers
# {"launch_counts": "reset" | "read"} itself (the counts, the engine's
# counters, the card and the process's torch import and kernel load)
SVC_DEPLOY_NAME = "llm-gw"
SVC_DEPLOY_READY_S = 600.0   # the gateway's ready timeout, raised by env
SVC_SERVE_CODE = """
import time

_started = time.perf_counter()
import torch  # noqa: E402
_TORCH_IMPORT_S = time.perf_counter() - _started

from mlrun_tpu_torch.ops import _build  # noqa: E402

_KERNEL_LOAD_S = None
if torch.cuda.is_available():
    torch.cuda.init()
    _started = time.perf_counter()
    _build.library()
    _KERNEL_LOAD_S = time.perf_counter() - _started


class CountingLLM:
    \"\"\"LLMModelServer as a graph route, with the kernels' launch counts
    behind the body {"launch_counts": "reset" | "read"}.\"\"\"

    def __init__(self, context=None, **class_args):
        from mlrun_tpu_torch.serving.llm import LLMModelServer

        self.server = LLMModelServer(context=context, **class_args)

    def do_event(self, event, *args, **kwargs):
        body = event.body if isinstance(event.body, dict) else {}
        what = body.get("launch_counts")
        if what is None:
            return self.server.do_event(event, *args, **kwargs)
        torch.cuda.synchronize()
        if what == "reset":
            _build.reset_launch_counts()
        event.body = {"launches": _build.launch_counts(),
                      "stats": self.server.engine.stats,
                      "device": torch.cuda.get_device_name(0),
                      "torch_import_s": _TORCH_IMPORT_S,
                      "kernel_load_s": _KERNEL_LOAD_S}
        return event

    def __getattr__(self, name):
        if name == "server":
            raise AttributeError(name)
        return getattr(self.server, name)
"""


def _svc_serving_fn(seed: int, warmup: bool = True):
    """The serving function the leg deploys: GATEWAY_SPEC's router with
    one CountingLLM route over LLMModelServer at Llama-3-8B."""
    import base64
    import copy

    from mlrun_tpu_torch import new_function

    spec = copy.deepcopy(GATEWAY_SPEC)
    route = spec["graph"]["steps"]["router"]["routes"]["llm"]
    route["class_name"] = "CountingLLM"
    route["class_args"].update(seed=seed, warmup=warmup)
    fn = new_function(SVC_DEPLOY_NAME, project=SVC_PROJECT, kind="serving")
    fn.spec.graph = spec["graph"]
    fn.spec.build.functionSourceCode = base64.b64encode(
        SVC_SERVE_CODE.encode()).decode()
    return fn


def _svc_gateway(state) -> dict | None:
    for row in state.db.list_runtime_resources(kind="gateway"):
        if row["uid"] == f"gateway-{SVC_DEPLOY_NAME}":
            return row
    return None


def _svc_deploy_leg(seed: int, card: str, state, provider, client) -> dict:
    """(deploy) a serving function at Llama-3-8B (32 layers, bf16, paged)
    deployed through HTTPRunDB and the service's DeploymentManager, which
    starts the port's gateway (``python3 -m mlrun_tpu_torch serve``) as a
    child on the card: (a) deploy until ready, the address stored; (b) the
    serve traffic through ``fn.invoke``, every token held to a
    teacher-forced forward of the seeded params, the kernels' launches as
    the engine counts them; (c) a drain with a request in flight, then
    SIGINT: the child exits 0; (d) the service's monitor flips the
    function to error, clears its address and drops its gateway; a second
    deploy of the same 8B graph (no warmup pass) and ``undeploy()`` leave
    it offline with no process of the gateway's tree."""
    import signal
    import threading

    import torch

    from mlrun_tpu_torch.models.llama import MODEL_PRESETS, init_params
    from mlrun_tpu_torch.service.providers import _process_tree

    config = MODEL_PRESETS["llama3-8b"]()
    fn = _svc_serving_fn(seed)
    started = time.perf_counter()
    address = fn.deploy()
    deploy_s = time.perf_counter() - started
    stored = client.get_function(SVC_DEPLOY_NAME, SVC_PROJECT, tag="latest")
    row = _svc_gateway(state)
    if not address or row is None:
        fail(f"service (deploy): no address or gateway ({address!r})")
    child = provider._procs[row["resource_id"]]
    tree = _process_tree(child.pid)
    try:
        # the teacher's params, built here while the gateway warms up
        params = init_params(config, torch.Generator(
            device="cuda").manual_seed(seed), "cuda")
        prompts = _prompts(seed, config.vocab_size)
        _svc_until("the deployed gateway's /readyz",
                   lambda: _http(address, "/readyz")[0] == 200,
                   timeout=SVC_DEPLOY_READY_S)
        ready_s = time.perf_counter() - started
        before = fn.invoke(GW_INFER, body={"launch_counts": "reset"})
        t = time.perf_counter()
        first = fn.invoke(GW_INFER, body={"inputs": prompts})
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        hit = fn.invoke(GW_INFER, body={"inputs": [prompts[0]]})
        hit_s = time.perf_counter() - t
        read = fn.invoke(GW_INFER, body={"launch_counts": "read"})
        launches = {k: v for k, v in read["launches"].items() if v}
        counted = _gateway_launches(read["launches"], before["stats"],
                                    read["stats"], config.n_layers,
                                    path="service (deploy)")
        outputs = first["outputs"] + hit["outputs"]
        gaps = []
        for prompt, tokens in zip(prompts + [prompts[0]], outputs):
            logits = _teacher_logits(config, params, prompt, tokens)
            gaps.append(max(float(r.max() - r[tok]) / float(r.abs().max())
                            for r, tok in zip(logits, tokens)))
            del logits
        del params
        torch.cuda.empty_cache()
        # (c) a drain with a request in flight, then SIGINT
        box = {}
        long_prompts = _prompts(seed + 2, config.vocab_size)
        inflight = threading.Thread(target=lambda: box.update(
            answer=fn.invoke(GW_INFER, body={"inputs": long_prompts})))
        inflight.start()
        _svc_until("the long request in flight", lambda: json.loads(
            _http(address, "/healthz")[2]).get("inflight", 0) > 0,
            timeout=60, every=0.002)
        drain = _http(address, "/__drain__", "POST")
        inflight.join(timeout=GW_TIMEOUT)
        drained = json.loads(drain[2])
        answered = box.get("answer") or {}
        child.send_signal(signal.SIGINT)
        try:
            exit_code = child.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail("service (deploy): the gateway did not exit after SIGINT")
        exited = time.perf_counter()
        # (d) the service's own monitor loop notices the dead gateway
        flipped = _svc_until("the monitor's flip to error", lambda: (
            client.get_function(SVC_DEPLOY_NAME, SVC_PROJECT,
                                tag="latest")["status"]["state"]
            == "error") and client.get_function(
                SVC_DEPLOY_NAME, SVC_PROJECT, tag="latest"))
        flip_s = time.perf_counter() - exited
        gateway_after_death = _svc_gateway(state)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    # a second deploy, then undeploy
    again = _svc_serving_fn(seed, warmup=False)
    t = time.perf_counter()
    second_address = again.deploy()
    second_deploy_s = time.perf_counter() - t
    second_tree = _process_tree(int(_svc_gateway(state)["resource_id"].split(
        "-")[1]))
    t = time.perf_counter()
    again.undeploy()
    offline = client.get_function(SVC_DEPLOY_NAME, SVC_PROJECT,
                                  tag="latest")["status"]
    left = _svc_until("the undeployed gateway's processes to exit",
                      lambda: not any(_pid_running(p)
                                      for p in second_tree),
                      timeout=60) and [p for p in second_tree
                                       if _pid_running(p)]
    undeploy_s = time.perf_counter() - t
    row = {
        "phase": "service", "leg": "deploy", "card": card,
        "model": "llama3-8b", "layers": config.n_layers, "address": address,
        "deploy_s": deploy_s, "ready_s": ready_s,
        "request_s": [first_s, hit_s],
        "torch_import_s": read["torch_import_s"],
        "kernel_load_s": read["kernel_load_s"], "device": read["device"],
        "launches": launches, **counted,
        "worst_argmax_gap_rel": max(gaps), "argmax_gap_tol": SPEC_REL_TOL,
        "drain_s": drain[3], "drained": drained, "exit_code": exit_code,
        "monitor_flip_s": flip_s,
        "second_deploy": {"layers": config.n_layers,
                          "deploy_s": second_deploy_s,
                          "undeploy_s": undeploy_s,
                          "processes": len(second_tree)},
        "checks": {
            "deployed_ready": fn.status.state == "ready"
            and address.startswith("http://127.0.0.1:"),
            "stored_address": stored["status"]["state"] == "ready"
            and stored["status"]["address"] == address,
            "the_ports_gateway": provider.kind == "local-process"
            and len(tree) >= 1,
            "ran_on_the_card": read["device"] == _device_name(),
            "tokens": len(outputs) == 5
            and all(len(o) == MAX_NEW for o in outputs),
            "near_argmax": max(gaps) <= SPEC_REL_TOL,
            "prefix_hit": read["stats"]["prefix_hits"]
            > before["stats"]["prefix_hits"],
            "drain_kept_the_inflight_request":
            drained == {"drained": True, "inflight": 0}
            and [len(a) for a in answered.get("outputs", [])]
            == [MAX_NEW] * len(long_prompts),
            "exit_0": exit_code == 0,
            "monitor_flipped_to_error": bool(flipped)
            and flipped["status"]["address"] == ""
            and flipped["status"].get("external_invocation_urls") == []
            and gateway_after_death is None,
            "second_deploy_ready": second_address.startswith(
                "http://127.0.0.1:"),
            "undeployed_offline": offline["state"] == "offline"
            and offline["address"] == "" and _svc_gateway(state) is None
            and again.status.state == "offline",
            "no_process_left": left == [],
        }}
    _svc_check(row)
    return row


def _svc_check(row: dict):
    emit(row)
    bad = [name for name, ok in row["checks"].items() if not ok]
    if bad:
        fail(f"service: {bad}")


def _svc_until(what: str, probe, timeout: float = SVC_TIMEOUT,
               every: float = 0.05):
    """Poll ``probe`` until it returns a truthy value; fail on timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = probe()
        if value:
            return value
        time.sleep(every)
    fail(f"service: timed out waiting for {what}")


def _svc_results(log: bytes) -> list:
    """The children's result lines from the run's log, in order."""
    prefix = f"{SVC_MARK} result "
    return [json.loads(line[len(prefix):])
            for line in log.decode(errors="replace").splitlines()
            if line.startswith(prefix)]


def _svc_run_params(seed: int, work: str) -> dict:
    return {"model": SVC_MODEL, "model_overrides": {"n_layers": SVC_LAYERS},
            "batch_size": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "steps": SVC_STEPS, "log_every": 1, "seed": seed,
            "checkpoint_dir": os.path.join(work, "checkpoints"),
            "checkpoint_every": SVC_CKPT_EVERY, "model_name": "svc-1b",
            "park_after": SVC_CKPT_EVERY}


def _svc_in_process(params: dict) -> tuple:
    """The same fit in this process, uninterrupted: (losses, step times)."""
    import torch

    from mlrun_tpu_torch.frameworks.torch import auto_trainer

    losses, step_t = [], []

    def record(step, metrics, trainer):
        losses.append(float(metrics["loss"]))
        step_t.append(time.time())

    auto_trainer.train(context=None, callbacks=[record], **{
        k: v for k, v in params.items()
        if k not in ("checkpoint_dir", "checkpoint_every", "park_after",
                     "device_check")})
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return losses, step_t


def phase_service(seed: int, card: str) -> dict:
    """The service on the card: the port's API server on 127.0.0.1 over a
    temporary SQLite run db with the local process provider; a client
    (HTTPRunDB through MLT_DBPATH, ClientRemoteLauncher) submits a tpujob
    run of auto_trainer.train (the 1B width at 2 layers, 4 x 2048, 4
    steps, a checkpoint every 2, max_retries 1 with no backoff); the
    service's TpuJobHandler builds the JobSet and the provider runs its
    own command (torchrun, one process) on the card; after step 2's
    checkpoint the child's process group is SIGKILLed; the service's own
    monitor classifies the failure and resubmits <name>-r1 with the
    resume env; the resumed child trains steps 3-4. Then the deploy leg
    (``_svc_deploy_leg``): a serving function at Llama-3-8B deployed
    through the same service. Returns the kernels' launches summed over
    both tpujob children and the deployed gateway."""
    import base64
    import shutil
    import signal
    import socket
    import tempfile

    from mlrun_tpu_torch import new_function, new_task
    from mlrun_tpu_torch.config import SERVICE_DEFAULTS
    from mlrun_tpu_torch.datastore import store_manager
    from mlrun_tpu_torch.db import get_run_db, set_run_db
    from mlrun_tpu_torch.db.httpdb import HTTPRunDB
    from mlrun_tpu_torch.db.sqlitedb import SQLiteRunDB
    from mlrun_tpu_torch.launcher import ClientRemoteLauncher, LauncherFactory
    from mlrun_tpu_torch.models.llama import MODEL_PRESETS
    from mlrun_tpu_torch.obs import get_flight_recorder
    from mlrun_tpu_torch.service.app import ServiceState, ServiceThread
    from mlrun_tpu_torch.service.providers import (
        LocalProcessProvider,
        _process_tree,
        signal_process_tree,
    )

    started = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mlt-service-")
    saved_env = {k: os.environ.get(k) for k in (
        "MLT_DBPATH", "MLT_HOME", "PATH", "PYTHONPATH", "RANK",
        "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT", "MLT_FUNCTION__GATEWAY_READY_TIMEOUT",
        "MLT_HTTPDB__TIMEOUT")}
    saved_conf = (SERVICE_DEFAULTS["httpdb"]["port"],
                  SERVICE_DEFAULTS["runs"]["monitoring_interval"])
    # the children's programs (python3, torchrun) are this interpreter's,
    # with the checkout importable and no rank of this process
    os.environ.update(_proj_env(work, MLT_HOME=os.path.join(work, "home")))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(name, None)
    # an 8B gateway takes longer than the default 30 s to answer: the
    # service's ready timeout and the client's request timeout, raised
    # through their env names
    os.environ["MLT_FUNCTION__GATEWAY_READY_TIMEOUT"] = str(
        SVC_DEPLOY_READY_S)
    os.environ["MLT_HTTPDB__TIMEOUT"] = str(SVC_DEPLOY_READY_S + 60)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    SERVICE_DEFAULTS["httpdb"]["port"] = port
    SERVICE_DEFAULTS["runs"]["monitoring_interval"] = SVC_MONITOR_S
    db = SQLiteRunDB(os.path.join(work, "svc.sqlite"),
                     logs_dir=os.path.join(work, "logs"))
    provider = LocalProcessProvider(db)
    state = ServiceState(db=db, provider=provider)
    server = ServiceThread(state, port=port)
    url = server.url
    os.environ["MLT_DBPATH"] = url
    set_run_db(None)
    store_manager._db = None
    try:
        client = get_run_db()
        params = _svc_run_params(seed, work)
        fn = new_function("svc-train", kind="tpujob", project=SVC_PROJECT)
        fn.with_gpus(nodes=1, gpus_per_node=1)
        fn.spec.build.functionSourceCode = base64.b64encode(
            SVC_TRAIN_CODE.encode()).decode()
        task = new_task(name="svc-train", project=SVC_PROJECT,
                        handler="train", params=params).with_retry(
            max_retries=1, backoff=0.0)
        submitted = time.time()
        run = fn.run(runspec=task, local=False, watch=False)
        uid = run.metadata.uid
        handler = state.launcher.handler_for("tpujob")
        first_id = handler._resources[uid][0]
        manifest = handler._manifests[uid]

        def checkpointed():
            doc = client.read_run(uid, SVC_PROJECT) or {}
            ckpt = doc.get("status", {}).get("checkpoint") or {}
            if doc.get("status", {}).get("state") in ("error", "completed"):
                fail(f"service: the first attempt ended before its "
                     f"checkpoint: {doc.get('status')}")
            return ckpt.get("step") == SVC_CKPT_EVERY and ckpt

        checkpoint = _svc_until("step 2's checkpoint", checkpointed)
        tree = _process_tree(provider._pid_of(first_id)[0])
        killed = time.time()
        # a preemption: SIGKILL, no SIGTERM, to the child's process group
        # and its torchrun worker's (a session of its own)
        signal_process_tree(tree[0], signal.SIGKILL)
        gone = _svc_until("the killed child's processes to exit",
                          lambda: not any(os.path.exists(f"/proc/{p}")
                                          and _pid_running(p)
                                          for p in tree))

        def resubmitted():
            doc = client.read_run(uid, SVC_PROJECT) or {}
            return doc.get("status", {}).get("retry_count") == 1 and doc

        _svc_until("the monitor's resubmission", resubmitted)
        events = [e for e in get_flight_recorder().events("run.resubmit")
                  if e.get("uid") == uid]
        resubmit_t = events[-1]["t"] if events else None
        final_state = run.wait_for_completion(sleep=0.1,
                                              timeout=SVC_TIMEOUT,
                                              raise_on_failure=False)
        status = (client.read_run(uid, SVC_PROJECT) or {}).get("status", {})
        log_state, log = client.get_log(uid, SVC_PROJECT)
        lines = log.decode(errors="replace").splitlines()
        results = _svc_results(log)
        attempts = {r["attempt"]: r for r in results}
        first, second = attempts.get(0, {}), attempts.get(1, {})
        deploy_started = time.perf_counter()
        deployed = _svc_deploy_leg(seed, card, state, provider, client)
        deploy_leg_s = time.perf_counter() - deploy_started
        server.stop()
        server = None
        _release()

        losses, step_t = _svc_in_process(params)
        config = MODEL_PRESETS[SVC_MODEL](n_layers=SVC_LAYERS)
        passes = SVC_CKPT_EVERY + 1      # the warmup's pass and 2 steps
        want = {"flash_fwd": 2 * config.n_layers * passes,
                "flash_bwd": config.n_layers * passes}

        def step_ms(times):
            return ((times[-1] - times[0]) / (len(times) - 1) * 1e3
                    if len(times) > 1 else None)

        first_t, second_t = first.get("step_t") or [None], \
            second.get("step_t") or [None]
        seconds = {
            "submit_to_first_step": first_t[0] - submitted
            if first_t[0] else None,
            "kill_to_resubmit": resubmit_t - killed if resubmit_t else None,
            "resubmit_to_resumed_first_step": second_t[0] - resubmit_t
            if second_t[0] and resubmit_t else None,
            "first_child": {"torch_import": first.get("torch_import_s"),
                            "kernel_load": first.get("kernel_load_s")},
            "resumed_child": {"torch_import": second.get("torch_import_s"),
                              "kernel_load": second.get("kernel_load_s"),
                              "checkpoint_restore":
                              (second.get("restore_s") or [None])[0]},
        }
        main = manifest["spec"]["replicatedJobs"][0]["template"]["spec"][
            "template"]["spec"]["containers"][0]
        row = {
            "phase": "service", "card": card, "url": url, "uid": uid,
            "model": SVC_MODEL, "layers": SVC_LAYERS, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": SVC_STEPS,
            "state": final_state, "status_text": status.get("status_text"),
            "retry_count": status.get("retry_count"),
            "failure_class": status.get("failure_class"),
            "checkpoint": checkpoint, "killed_resource": first_id,
            "killed_processes": len(tree),
            "container_args": main["args"], "seconds": seconds,
            "step_ms": {"first_child": step_ms(first.get("step_t") or []),
                        "resumed_child": step_ms(second.get("step_t") or []),
                        "in_process": step_ms(step_t)},
            "losses": {"first_child": first.get("losses"),
                       "resumed_child": second.get("losses"),
                       "in_process": losses},
            "launches": {"first_child": first.get("launches"),
                         "resumed_child": second.get("launches"),
                         "expected_each": want},
            "log_lines": len(lines),
            "checks": {
                "client_is_the_http_db": isinstance(client, HTTPRunDB)
                and isinstance(getattr(run, "_db", None), HTTPRunDB),
                "remote_launcher": isinstance(
                    LauncherFactory.create_launcher(
                        is_remote=fn.is_remote(), local=False),
                    ClientRemoteLauncher),
                "the_ports_torchrun_pod": main["args"] == [
                    "python3", "-m", "mlrun_tpu_torch", "run",
                    "--from-env", "--handler", "train"]
                and "torchrun" in main["command"][2],
                "completed": final_state == "completed"
                and status.get("state") == "completed"
                and log_state == "completed",
                "retry_count_1": status.get("retry_count") == 1,
                "failure_class_infra": status.get("failure_class")
                == "infra",
                "killed_the_whole_tree": gone and len(tree) >= 2,
                "resubmitted_once": len(events) == 1
                and events[0].get("attempt") == 1
                and events[0].get("failure_class") == "infra"
                and events[0].get("resource") != first_id,
                "resumed_from_step_2": second.get("resume_step")
                == SVC_CKPT_EVERY and bool(second.get("restore_s")),
                "ran_on_the_card": first.get("device") == second.get(
                    "device") == _device_name(),
                "log_holds_both_attempts": sum(
                    f"{SVC_MARK} attempt 0 step" in ln for ln in lines)
                == SVC_CKPT_EVERY and sum(
                    f"{SVC_MARK} attempt 1 step" in ln for ln in lines)
                == SVC_STEPS - SVC_CKPT_EVERY,
                "resumed_steps_equal_in_process": len(losses) == SVC_STEPS
                and second.get("losses") == losses[SVC_CKPT_EVERY:],
                "first_steps_equal_in_process":
                first.get("losses") == losses[:SVC_CKPT_EVERY],
                "flash_launches": first.get("launches") == want
                and second.get("launches") == want,
            }}
        _svc_check(row)
        launches = {}
        for counts in (first.get("launches"), second.get("launches"),
                       deployed["launches"]):
            for name, count in (counts or {}).items():
                launches[name] = launches.get(name, 0) + count
        emit({"phase": "service", "card": card,
              "seconds": time.perf_counter() - started,
              "deploy_leg_seconds": deploy_leg_s,
              "launches": launches})
        return launches
    finally:
        if server is not None:
            server.stop()
        for resource_id in list(provider._procs):
            provider.delete(resource_id)
        SERVICE_DEFAULTS["httpdb"]["port"], \
            SERVICE_DEFAULTS["runs"]["monitoring_interval"] = saved_conf
        set_run_db(None)
        store_manager._db = None
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(work, ignore_errors=True)


def _pid_running(pid: int) -> bool:
    """A pid that is alive and not a zombie awaiting its parent."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().decode(errors="replace").rsplit(") ", 1)[1][
                0] != "Z"
    except (OSError, IndexError):
        return False


def _device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


ALL_PHASES = ("build", "kernels", "serve", "serve_int8", "spec",
              "serve_dense", "lora", "train", "resilience", "kv_tier",
              "fleet", "families", "entry_points", "parallel", "observe",
              "gateway", "podfleet", "runs", "tuning", "projects",
              "service")


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

    phase_seconds = {}

    @contextlib.contextmanager
    def timed(phase):
        started = time.perf_counter()
        try:
            yield
        finally:
            phase_seconds[phase] = time.perf_counter() - started

    card = gpu_name_and_limit()
    kernels, launches, served, serve_native = [], {}, None, None
    train_step_ms = None
    if "build" in phases:
        with timed("build"):
            phase_build(card)
    if "kernels" in phases:
        with timed("kernels"):
            kernels, op_launches = phase_kernels(args.seed)
            launches.update(op_launches)
    if "serve" in phases:
        with timed("serve"):
            served = phase_serve(args.seed, card)
            launches.update({name: served["launches"][name]
                             for name in SERVING_KERNELS})
            serve_native = {key: served[key]
                            for key in ("ttft_p50_s", "decode_tick_p50_s")}
            release()
    if "serve_int8" in phases:
        with timed("serve_int8"):
            served = phase_serve(args.seed, card, "int8", native=served)
            launches.update({name: served["launches"][name]
                             for name in ("paged_decode_int8",
                                          "paged_prefill_int8")})
    served = None
    release()
    if "spec" in phases:
        with timed("spec"):
            launches.update(phase_spec(args.seed, card)["launches"])
            release()
    if "serve_dense" in phases:
        with timed("serve_dense"):
            phase_serve_dense(args.seed, card)
            release()
    if "lora" in phases:
        with timed("lora"):
            phase_lora(args.seed, card, serve_native)
            release()
    if "train" in phases:
        with timed("train"):
            trained = phase_train(args.seed, card)
            launches.update({name: trained["launches"][name]
                             for name in TRAINING_KERNELS})
            train_step_ms = trained["step_ms"]
            trained = None
            release()
    if "resilience" in phases:
        with timed("resilience"):
            phase_resilience(args.seed, card)
            release()
    if "kv_tier" in phases:
        with timed("kv_tier"):
            phase_kv_tier(args.seed, card)
            release()
    if "fleet" in phases:
        with timed("fleet"):
            phase_fleet(args.seed, card)
            release()
    if "families" in phases:
        with timed("families"):
            # the training flash kernels' launches on every training path
            for name, count in phase_families(args.seed,
                                              card)["launches"].items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "entry_points" in phases:
        with timed("entry_points"):
            # the serving and training kernels' launches on the entry points
            for name, count in phase_entry_points(args.seed, card,
                                                  train_step_ms).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "parallel" in phases:
        with timed("parallel"):
            # the training flash kernels' launches on the sharded step, its
            # checkpoint's resumed run and the ring's hops
            for name, count in phase_parallel(args.seed, card,
                                              train_step_ms).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "observe" in phases:
        with timed("observe"):
            # the serving kernels' launches on the captured burst and the
            # training flash's on the captured fit
            for name, count in phase_observe(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "gateway" in phases:
        with timed("gateway"):
            # the serving kernels' launches on the traffic served over HTTP
            for name, count in phase_gateway(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "podfleet" in phases:
        with timed("podfleet"):
            # the serving kernels' launches on the pod fleet's traffic, its
            # pre-warms, the preempted requests' handoffs and their resumes
            for name, count in phase_podfleet(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "runs" in phases:
        with timed("runs"):
            # the training flash's launches on the tpujob and hyper runs, the
            # serving kernels' on the SLO leg's burst
            for name, count in phase_runs(args.seed, card,
                                          train_step_ms).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "tuning" in phases:
        with timed("tuning"):
            # the serving kernels' launches on the loop's traffic, the
            # training flash's on its retrain runs
            for name, count in phase_tuning(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "projects" in phases:
        with timed("projects"):
            # the training flash's launches in the tpujob pod and the
            # workflow's LoRA step, the serving kernels' in its decode step
            for name, count in phase_projects(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    if "service" in phases:
        with timed("service"):
            # the training flash's launches in the tpujob run's two
            # children (killed after step 2, resumed for steps 3-4), the
            # serving kernels' in the deployed 8B gateway
            for name, count in phase_service(args.seed, card).items():
                launches[name] = launches.get(name, 0) + count
            release()
    # each phase's wall-clock seconds, for the smoke's time limit
    emit({"phase_seconds": phase_seconds})
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
