#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repository. It fails (non-zero exit, no result
line) when no CUDA device is visible or the port is not beside it.

Phases, each of which must pass:

1. Build: compiles the four hand-written CUDA kernels from
   k8s_llm_scheduler_tpu_torch/csrc (one nvcc per source, in parallel).
1a. cli verify: `python -m k8s_llm_scheduler_tpu_torch.cli verify` in a
   process of its own, beside 1b's child: every check `[ok]` (torch, numpy, the card's name
   and power limit, the four kernels built with nvcc, the config, a TINY
   forward launching K1 and K2, cluster access, the tokenizer), exit 0.
1b. cli run, the production entry point at full width: the port's
   WireFakeK8s (real HTTP) holding synthetic_nodes(32); a child process
   runs `cli.main(["run"])` against it (KubeCluster over the in-tree REST
   transport, LLM_MODEL=llama-3.1-8b-instruct, the config's defaults:
   temperature 0.3, packed admission and delta prompts on); then 24
   pending pods of 12 shapes are created over the wire (12 leaders against
   8 slots: two waves), and once they are bound 8 more of 8 new shapes (a
   warm R=8 wave). Once the fake shows all 32 bound (deadline 600 s)
   the child gets SIGINT and must exit 0 with its stats JSON. Every pod
   bound to a ready, feasible node, no fallback, every decision parsed,
   K1 and K2 launched in the child (counts zeroed just before cli.main).
   Prints each pod's pending -> bound time, the seconds between the two
   waves' harvests and the child's peak memory. The child runs with the
   operating plane on: the decision journal (durability.enabled, in its
   temporary directory), the wave profiler (on by default), metrics on
   port 0 and the SLO engine (one error-rate objective). Before SIGINT the
   phase scrapes /metrics, /debug/profile and /debug/slo and prints on one
   line the wave segments, device_compute, mfu_decode with the peak it
   used, dispatches_per_decision and prefill_tokens_per_decision. Fails
   if a record's segments do not sum to its wall, if they cover under 95%
   of it, or if an MFU share is above 1. It runs first, while no other 8B
   model is resident.
   Every child of the smoke runs in a temporary directory with the
   repository on its PYTHONPATH: the repo root's config.yaml would be
   read there, and a machine without PyYAML refuses a config file.
2. Kernels: K1 (shared-prefix flash partials) and K2 (causal in-chunk flash
   partials) on random bf16 inputs at every shape the decision phase gives
   them (taken from the engine's bucket and wave geometry for the smoke's
   own prompts: prefix chunks, suffix prefills, block decodes), each held
   against its plain PyTorch version on the same inputs (K1 at its planned
   key splits, so the combine kernel is held too; K1 also, untimed, at
   TINY's head dim 64 and g = 2, at 32-64 key splits mostly past
   prefix_len, at a buffer that is not whole key tiles and at an empty
   prefix: `K1_EDGE_CASES`; K2, untimed, at TINY, chunks that are not
   whole tiles, g = 1 and 8, lens 0, 1, > S and < 0: `K2_EDGE_CASES`).
   Queries are scaled so that attention is peaked; the normalized output
   o/l must agree within 3e-2 of the reference's RMS, m within 1e-4 (1 +
   max |m|), l within 1e-4 relative, and rows without a valid key must be
   exactly m = -1e30, l = 0. Times for the kernel, its plain version and one PyTorch library
   call (scaled_dot_product_attention) on the same inputs are device times:
   back-to-back calls captured in a CUDA graph, replayed between CUDA
   events (`_time_ms`). K1 and its SDPA yardstick are timed with a cold L2
   as the path meets it (the captured calls rotate over >= 4 distinct
   prefix buffers, 134 MB, since each layer reads its own prefix K/V) and
   again hot (one buffer replayed). K2 is timed hot (its inputs are just
   written by the layer) and cold (rotating input copies), beside SDPA
   with its dense mask and, where every len is S, SDPA with
   is_causal=True on each backend that runs it; its ratio is against the
   faster yardstick.
3. Reference: the main path at TINY width on the card (kernels) against the
   same weights on the CPU (plain versions): chunked prefix prefill, then a
   suffix prefill; logits within 5e-2 of the largest logit (bf16).
   Also, at TINY with the same weights: block decode with int8 weights and
   ragged matmuls (K3), the general path's buffered decode step with K4
   partials, and the manual-page decode step with K4 normalized.
4. Decision: a LocalLLMBackend with full-width, full-depth Llama-3.1-8B
   (random bf16 weights from a seed, greedy, batches as waves; built
   before phase 2, whose shapes it gives) serves 4 single decisions, then (once its idle worker has
   captured the sibling wave geometries: `prewarm_wave_siblings`) a batch
   of 8, then one more single decision under torch.profiler, for a 32-node
   synthetic cluster (a 5,488-token prefix: the chunked prefix prefill).
   It does so twice on the same weights: with the engine's waves as CUDA
   graphs (the default), then eagerly (graphs=False) with the batch alone
   (an eager single is host-bound, 15-26 s). Every decision must
   parse, name a feasible node and carry a confidence in [0, 1]; the two
   modes must emit identical greedy tokens wave for wave and row for row
   (the batch),
   launch each kernel as often per run of every step (prefix chunk, suffix
   prefill and block decode by row count R; a graph replay counts what its
   capture recorded), and in graph mode the batch must find its geometry
   captured and the profiled decision launch no kernel outside a graph
   (the profiler counts the host's launch calls and the device's
   operations per model call). K1 and K2 must have launched (every count
   is zeroed just before each mode's drive); K1's launches by step must
   add up to its total. Capture seconds, replays and peak memory are
   printed for each mode. Then, in graph mode: a thread waiting on a CUDA
   event must let other Python threads run (`gil_probe`), and of two warm
   R=8 waves submitted back to back the first must be harvested within
   1.25x a lone one's time, counted from its submit, with the tokens of
   the same waves run alone (`two_wave_overlap`: submit_wave returns at
   once; the wave dispatcher thread runs its iterations). Last, still in
   graph mode, two warm singles without the wave profiler and two with it
   (observability/profiler.EngineProfiler attached), then one more with
   it under torch.profiler: the profiler's cost in ms a decision is
   printed, and host launch calls a model call and host synchronizations
   a decision must equal those of the profiled decision without it.
4s. Swap 8B, on the graph-mode engine of phase 4 (swap_phase): the batch
   of 8 as one greedy wave; a second random 8B tree (init_params seed 1)
   built on the card as a staging tree; 4 single decisions in flight, and
   the hot swap through run_quiesced (engine.swap_params copies the tree
   into the serving tensors at the wave barrier); the batch again; then
   the seed-0 tree swapped back and the batch once more. Every served
   tensor keeps its data_ptr, the burst's decisions all succeed, the
   post-swap wave differs from the pre-swap one and each of its sampled
   tokens is within 5e-2 of the largest |logit| of the argmax, over the
   tokens the grammar allows, of one eager teacher-forced forward on the
   new weights (forced tokens are the grammar's), the wave after the swap
   back replays the pre-swap tokens byte for byte, and those two waves
   replay their captured programs with no capture. Prints the pause, the
   install's ms beside its bound (2 x the tree's bytes over 3.35 TB/s) and
   the card's memory before, with the staging tree and after.
4a. Admission, on the graph-mode engine of phase 4 (no second copy of
   the weights): (a) a LocalLLMBackend with the admission plane of
   the config's defaults takes the batch of 8 through
   get_scheduling_decisions_batch: one packed admission (chunks of 256,
   K1 in each chunk's prefix part, decode chunks piggybacked between
   them), decoded by step() to completion. All 8 must parse and name a
   feasible node, with 1 packed admission of 8 prompts in ceil(suffix
   tokens / 256) chunks, K1 launched 32 times in each ("pack chunk" step).
   Prints the batch's wall time, the piggybacked chunks, the decode steps
   and how many of the 8 token streams equal the wave batch's of phase 4
   (bf16: near-ties may flip, not gated), the pinned KV and peak memory.
   (b) At TINY (bf16: the kernels take bf16), three prompts (one shorter
   than a 16-token chunk, one spanning 14, one between), under the grammar
   and unconstrained: admit_packed with decode chunks piggybacked must
   emit the same tokens as with none and as each prompt's serial
   generate(), K1 4 times a chunk, and one pack chunk's end logits must
   be within 5e-2 of the largest of its CPU twin's.
4b. Loop: the scheduler's main path through its entry points, on the
   graph-mode engine of phase 4 (a new LocalLLMBackend over it with the
   config's default admission plane, as `cli run` maps it):
   `synthetic_cluster(32)` holding `pod_burst(32, distinct_shapes=8)`,
   added before the loop starts, the stack of `cli.build_stack` at the
   config's defaults around that backend (snapshot TTL 1 s,
   prefix prewarm tick 0.25 s), and Scheduler.run() until every pod is
   bound (deadline 300 s); then a second burst of 8 pods (one a shape) on
   the same cluster after the first's binds, through a new stack. Every
   pod must be bound to a ready node feasible
   for it, with no fallback decision, retry or backend error, the breaker
   closed, every LLM decision through get_scheduling_decision_async, and
   K1 and K2 launched in each burst (counts zeroed just before the first).
   The first burst's prompts must be the pinned snapshot, the second's a
   delta over the same pin, still held, and the prefill of the second
   burst's prefix must compute fewer tokens than the prefix, seeded from
   the pin, with K1 and K2 launched in it. Prints LLM
   decisions, cache and single-flight hits, waves and rows a wave, group
   installs, prefix prewarms, each pod's pending -> bound time, the drifted
   nodes, and the delta prefix prefill's tokens and ms.
4c. cli demo: `python -m k8s_llm_scheduler_tpu_torch.cli demo --model tiny
   --fake-nodes 4` in a process of its own beside path A (sampled at the
   config's 0.3): exit 0, 3 binds, no fallback.
4e. Sim: the arena (sim/) twice with one seed, 12 nodes, 16 pods in 2
   waves over the WireFakeK8s and the whole stack, the `llm` arm served
   greedily by phase 4's engine in graph mode (one LocalLLMBackend passed
   in with owned=False: no second 8B engine) beside the teacher: the two
   traces byte-identical, every pod placed or counted unschedulable, K1
   launched in each run; the card's free memory after each arm.
4f. Two backends over phase 4's engine, one after the other: the first
   decides on the 32-node cluster, the second on 12 nodes (a group of its
   own), then the first again: it reinstalls its group (one more group
   install), names a feasible node and repeats its first decision.
5. Path A: seed 0's 8B weights at full width and the depth of
   PATH_A_LAYERS (8 of 32 layers: the smoke's time limit, since the tp
   8B phase took on the hot swap, the prefix-KV plane and the resident
   loop), drawn on the card and quantized to int8 there, in an engine with
   decode_matmul="ragged", the same drive in both modes, held the same
   way; all feasible, K3 and K1 launched, K3 7 times a layer (56) per
   block-decode run in both modes. The valid tokens of every
   block-decode call are recorded for phase 7. Between the modes, phase
   4s's swap on the graph-mode int8 engine (staging trees quantized from
   init_params seeds 1 and 0): K3 reads the swapped weights through the
   tensor maps its captured launches hold.
6. Path B: the bf16 8B weights in an engine with paged_attn="pallas",
   max_slots 8, pages of 64: the cluster prefix installed, 8 suffixes
   admitted (unconstrained, greedy, 64 new tokens), step() until all
   finish, one generate(), then 8 more admitted with one step() under the
   profiler and the rest drained; in both modes (decode chunks as CUDA
   graphs, then eagerly). Every request finishes with 1-64 tokens, the
   modes emit identical tokens, K4 launched, launches per run equal, the
   graph-mode step launched no kernel outside a graph, and every page is
   returned. Its engines run fused_decode=False, so generate() drains
   through step() as before the fused runtime; that has phase 6c.
6c. Fused: path B's configuration, both modes: the 8 drained by step(),
   one generate() (which must go through decode_fused), then the 8 by
   decode_fused(): its tokens equal the step() drain's, it books exactly
   max(tokens) - 1 steps and sum(tokens - 1) decode tokens, and K4
   launches 32 times a step inside its program (graph mode: the launches
   of the conditional bodies that ran); the modes' tokens identical. Ms a
   step and tok/s beside path B's, and the device ms (CUDA events) of one
   live 16-step chunk and of the chunk's program run on the finished batch
   (mean of 10 back-to-back runs). Then one sampled drain at 0.3 with top-k 40 (graphs):
   every token a decodable id, never pad.
6d. Persistent (a): the 8B bf16 weights in an engine with
   paged_attn="gather" (the loop's own-token attention, as in the JAX
   loop), suffix bucket 256; the 8 suffixes admitted one at a time and
   drained by decode_fused give the reference; a warm-up residency
   captures the loop's two programs; then enter_persistent, the 8 through
   the command ring and step_persistent until done: the reference's
   tokens, the counter block's `emitted` equal to the decode tokens
   harvested, no torch op on the owner thread (a thread-local dispatch
   mode counts them) and no dispatch booked, K1 and K2 launched by the
   loop's admissions. Then a quiesce mid-stream and step_fused to the end:
   the reference's tokens again.
6g. Spec: speculative decoding (spec/) on the 8B bf16 weights of the
   resident backend, K = 4, two of the path B prompts behind the cluster
   prefix, SPEC_NEW_TOKENS (16) new tokens each: (a) the draft arm (a random TINY draft)
   and (b) the hidden arm (a random [4, 4096, 4096] head), greedy, with
   disable_threshold 0 so that every round speculates, in graph mode (two
   prompts) and eagerly (one); each prompt also through
   generate(use_spec=False) for ms a token beside ms a round. Every
   emitted token within 5e-2 of the largest |logit| of the target's argmax
   under one teacher-forced forward of prompt + output (bf16: the first
   divergence from the plain path is reported, not gated); one host sync
   at start and one a verify round; K1 launched 32 times at admission and
   32 times a verify round; graph and eager tokens identical. (c) the
   draft arm sampled at 0.3: every token legal. (d) the draft arm at the
   default threshold 0.3 with no prefix installed (K1 at prefix_len 0): the
   stream is handed back after 4 rounds and finishes through fused chunks,
   K4 launched. (e) TINY bf16 (the kernels take bf16), graphs: each arm
   (a random draft, the self-draft, the hidden head) token-identical to
   plain generate, unconstrained and under the decision grammar; the
   self-draft accepts K every round; sampled at 0.3, four streams of one
   prompt legal and not all equal (replays draw afresh). (f) `cli complete
   --spec` at TINY in a child started beside path A, greedy through
   LLM_TEMPERATURE=0: exit 0
   and the stdout of the same command without --spec. (g) K1 at the verify
   shapes q[1,5] and q[1,1] against the 8B prefix buffer (prefix_len
   5,488) and the empty one (64 slots, prefix_len 0), held and timed as
   the other K1 shapes.
6j. Hidden 8B: a K = 4 hidden-transfer head trained on the resident 8B
   bf16 target with train/hidden.train_hidden_transfer (10 steps at 4 x
   512 on the distill stream, lr 1e-3; the target frozen), saved to a
   temporary dir, restored (equal to the trained head) and served by
   build_local_backend(spec_arm="hidden", spec_draft_checkpoint=<dir>,
   disable threshold 0) over the same seed-0 target: speculative generate
   on two path B prompts behind the prefix, greedy, SPEC_NEW_TOKENS new tokens, held as
   phase 6g holds its arms (every token within 5e-2 of the largest |logit|
   of the teacher-forced argmax, one sync a verify round, K1 launched 32
   times at admission and 32 times a verify round). Fails on a non-finite
   loss or gradient norm. Prints ms a training step, acceptance, ms an
   emitted token and whether the output equals plain generate's (bf16:
   reported, not gated).
6m. Fleet (after phase 4b), on one card, over the decision phase's 8B
   engine through a LocalLLMBackend of its own: (a) a worker
   child serves `llama-3.2-1b-instruct` (random, seed 0, greedy) through
   cli._run_worker_replica (sched/replica.ReplicaServer, port 0); once it
   listens it gets one decision and a burst of 8 (its warm-up), then
   cli.build_stack with `distributed.replica_addrs` naming it wraps the
   8B backend in a FanoutBackend, and Scheduler.run() binds 16 pods of 8
   shapes on synthetic_cluster(32): every pod bound once to a feasible
   node, no fallback, decisions routed to both replicas, K1 and K2
   launched here and in the worker during the burst (its counts pulled
   over the wire before and after it; the warm-up's reported apart). (b) cli._maybe_router over the 8B backend (the big arm)
   with router.fast_model TINY and the numeric tokenizer on the card
   (big_cold_extra_ms 1000, complexity_threshold 1): 8 fixture pods one
   at a time, both arms' sibling prewarm off and both workers drained
   (run_quiesced) after each decision before its launches are read; the
   cold snapshot goes fast and fires the big arm's prewarm (its launches
   reported apart), the pods with a priority go big; both tiers serve,
   every decision is feasible, K1 and K2 launch in each arm. (c) `cli fleet demo
   --json` (64 pods, 3 stub replicas: every pod bound once), `cli fleet
   shard` and `cli fleet top --once --replicas` against the worker. The
   worker must exit 0 on SIGINT.
6n. KV plane 8B (after 6m): the shared prefix-KV plane (fleet/kvplane/)
   between the decision phase's 8B engine (the filler) and a twin engine
   over the same params tree and geometry (the adopter). (a) Engine level:
   the filler pins the 5,488-token snapshot prefix, decides the batch of 8
   as one greedy wave, and exports the prefix's pages in both transports
   (host: pinned host memory; d2d: the filler's tensors); the adopter
   pins the same prefix locally and decides the batch (its baseline, which
   captures its wave programs), then, its prefix cache emptied before
   each, adopts each page set and decides the batch again. Each adopted
   wave's tokens must equal the filler's, no prefix prefill and no capture
   may follow an adoption, and K1 and K2 must launch in the adopted wave
   (counts zeroed just before it). Prints export and adopt ms of each
   transport, the bytes shipped and the adopter's local prefix prefill
   ms. (b) Backend level: two LocalLLMBackends of the config's admission
   plane (delta prompts, 4 pins; batches as waves), one over each engine,
   attach_kvplane one KVPlaneStore as replica-0 and replica-1. A burst of
   the 8 pods on the snapshot on replica 0 (it wins the fill election and
   publishes) then replica 1 (it adopts: kv_source "shared", no prefix
   prefill): the same nodes and tokens. Then the generation bump of a
   swap: both engines swap together (their shared tree onto itself), the
   store bumps, a lookup presenting generation 0 is refused. A burst on
   KV_DRIFTED drifted nodes on replica 1 (it syncs, refills, publishes)
   then replica 0 (it adopts and prefills only the delta tail over the
   adopted pin): the same nodes and tokens; K1 and K2 launch in every
   burst. (c) In children, all at once: `cli fleet kvplane --json
   --replicas 4` (dedup above 1, every pin accounted), `cli fleet demo
   --json` with FLEET_KVPLANE_ENABLED=1 (64 pods bound once, the plane's
   gauges), `cli chaos list`, `cli chaos run --regime kv-plane-outage
   --trace T` (clean) then `cli chaos replay T` (ok), `cli fleet autoscale
   --json` (exit 0). Prints the phase's wall time, its peak memory, the
   store's gauges and each client's stats.
6a. Checkpoint: a TINY HF-layout safetensors checkpoint from a seed,
   written in the format's own few lines (no `safetensors` package), vocab
   widened for the builtin numeric tokenizer, loaded through
   build_local_backend(checkpoint_path=...) on the card and on the CPU,
   bf16 and int8: a suffix prefill's logits on the card within 5e-2 of
   the largest logit of the CPU load; one greedy decision on the card
   parses and names a feasible node.
6b. Sampled: a TINY engine on the card, graphs on, temperature 0.3, the
   decision grammar: after a wave that captures the geometry, two waves of
   8 copies of one prompt are replayed; their 16 streams must not all be
   equal (the generator registered with the graphs draws afresh) and each
   must parse and name a node.
6e. Persistent (b): TINY through LocalLLMBackend(persistent_loop=True) on
   the card (graphs, temperature 0.3, suffix bucket 1024): 6 decisions at
   once, every one admitted through the resident loop (no wave, no
   fallback, no wedge), parsed and feasible.
6h. Journal restart: `cli run` at TINY in a child over the port's
   WireFakeK8s with the decision journal on (durability.enabled, fsync
   "intent"); the child is SIGKILLed after its first bind, more pods are
   created while it is dead, and a second child restarts on the same
   journal (recovery, then the watch resumed from the journaled
   resourceVersion). Every pod must be bound exactly once (one binding
   POST a pod, no 409) to a ready node, the second child exit 0 on SIGINT,
   and `cli journal fsck` exit 0 with the journal clean.
6i. Rollout TINY: three random TINY checkpoints; v1 and v2 published, v1
   active; `cli rollout promote --version 2` in a child (the gate's two
   arms on the card; the phase's gate tolerances pass any verdict: it
   checks the machinery); then a `cli rollout watch` child over the
   WireFakeK8s with --shadow-frac 0.5 and metrics on port 0: v3 is
   published while it serves, 6 pods are created once v3 is shadowed, the
   watch gates v3 and hot-swaps it in (the registry's active pointer
   moves to 3), 6 more pods follow; once all are bound, /metrics is
   scraped for the rollout gauges and the child gets SIGINT. Promote exits
   0 with v2 active, the watch exits 0, every pod is bound once to a ready
   node, one promotion and one swap, the shadow mirrored decisions.
6f. cli complete: `python -m k8s_llm_scheduler_tpu_torch.cli complete` at
   8B in a child process started after phase 6d (tp 8B, then the TINY phases run
   beside it), greedy, 64 new tokens, on an 11,349-token prompt (past the
   largest prefill bucket, 8,192, by more than a prefix chunk): exit 0,
   text printed, the prompt's head through set_prefix's chunked path, K1
   and K2 launched in the child, the tail decoded by fused chunks; its
   wall time and peak memory.
6k. Train 1B: `llama-3.2-1b-instruct` at full width and depth (d_model
   2048, 16 layers, 32/8 heads, head dim 64, d_ff 8192, vocab 128,256,
   tied), bf16, random from seed 0, byte tokenizer:
   train/distill.train_and_save for 10 steps at 4 x 2048 (cli train's
   defaults, lr 3e-4) on make_batches, its native checkpoint restored
   through restore_checkpoint. Fails on a non-finite loss or gradient
   norm, a last loss not below the first, a step-1 loss more than 1e-2
   from a no-grad forward without recomputation on the same batch and
   params, or a restored tree not equal to the trained one. Prints ms a
   step, the host's ms to build a batch, tokens/s, MFU (8N a token, the
   forward recomputed, against 989 TFLOP/s) and peak GiB (phase 6n's
   child shares the card meanwhile, so these rates are read beside it).
   Then one greedy
   decision served from the checkpoint through build_local_backend: it
   parses, names a feasible node and launches K1 and K2 (head dim 64).
6l. Learn 1B: the learn loop at Llama-3.2-1B through cli.main in this
   process (config defaults with `LEARN_SETTINGS` merged in, a temporary
   working dir): train 1B's checkpoint published into a temporary
   registry and made active (`rollout publish`, `rollout promote
   --no-gate`); `learn mine` (1 seed, 8 nodes, 24 pods in 3 waves),
   `learn build`, `learn run --trace T` (mine again, 4 finetune steps at 4
   x 1,024 from the incumbent, publish, 8 weakness cases on both arms, a
   6-node 12-pod arena gate), `learn replay T` and `learn status`; then
   two placeholder versions made active in turn and a third published
   under `rollout.retain: 1`. On random weights the cycle is expected to
   reject. Fails unless the verdict agrees with its weakness scores and
   gate checks (and with run's exit code), the candidate's parent is the
   incumbent, the corpus lineage is the incumbent, replay is ok, retention
   keeps exactly the newest, the active, its parent and the lineage
   version (the incumbent, kept by its pin alone), and K1 and
   K2 launch in `mine`, the cycle's mining, the weakness gate and the
   arena gate. Prints each stage's seconds, the finetune's ms a step, the
   incidents mined, both weakness scores and the gate's verdict.
6m. tp 8B (after the 8B backend is closed, beside cli complete's child,
   before the TINY phases): Llama-3.1-8B at full width and depth served tensor parallel
   over TP = 2 ranks, this process (the driver) and one it spawns, both on
   the one card over gloo (NCCL refuses two ranks on one GPU), eager
   (gloo's host collectives cannot be captured into a CUDA graph),
   paged_attn "pallas"; each rank's shard (16 q / 4 kv heads, d_ff 7,168,
   a vocab half) drawn from seed 0 in the full tree's order. Before the 8B
   backend closes, the tp=1 engine computes the first call, the gathered
   logits of a TP_REF_TOKENS-token whole-prompt prefill: rank 0's must be
   within TP_LOGIT_TOL of max |logit| of it and equal rank 1's bit for
   bit. Then one decision and a burst of TP_PODS over synthetic_nodes(8),
   each naming a feasible node; K1 launches per model call of each step
   equal tp 1's (one a layer); one generate of TP_GEN_TOKENS tokens through
   the fused decode (K4). Each rank's K1/K2/K4 launch counts must be equal
   and non-zero (K3 zero: refused at tp > 1); prints the backend, wall
   time and each rank's peak memory. Then, in the same group (PR 21):
   the hot swap to seed TP_SWAP_SEED's tree and back, every rank
   restoring its own block (`double`, or `donate` when the card's free
   memory, printed first, cannot hold both ranks' staged blocks beside the
   children, after waiting for cli complete's child), each install at the
   backend's wave barrier: every data_ptr kept, the wave after the swap
   different, the wave after the swap back equal to the first byte for
   byte, every rank's prefix_epoch bumped twice, the pause and each rank's
   install ms against 2 x a rank's block bytes / 3.35 TB/s; the prefix-KV
   plane over the 5,488-token prefix of synthetic_nodes(32) (export over
   the host transport gathers the ranks' kv-head blocks into the driver's
   pinned memory, 1 GiB; every rank's cache cleared; adoption hands each
   rank its 512 MiB block): the wave after the adoption equal to the local
   prefill's, no prefix prefill on either rank, export and adopt ms
   against the local prefill's; the resident loop (the driver's resident
   thread deciding each iteration): the TP_PODS suffixes through the
   command ring equal to decode_fused's streams, every rank's counter
   block equal, K1 and K2 launched in the admissions and equal across the
   ranks. Between the plane and the loop, the plane's d2d transport between
   two tp groups: once cli complete's 8B child has exited (waiting for it
   if need be), a second tp group of the same model from seed 0 with its
   paged KV cut to TP_D2D_PAGES (the card's free memory printed before its
   build); the first group exports the pinned prefix `d2d` (each rank's
   block left in its export table, rank 1's behind a CUDA IPC handle) and
   the second adopts it (each rank copying the first's same-rank block
   device to device): its wave equal to the local prefill's, no prefix
   prefill on its ranks, no tp collective booked by either group for the
   export or the adoption, K1 and K2 launched on both of its ranks (counts
   zeroed just before its wave), and every first-group rank's export table
   empty once the page set is dropped; export and adopt ms beside the host
   arm's. tp 8B's reasoning cap of 8 (16) and resident streams of 4 tokens
   (8) pay for part of it.
6n. Train parallel 1B (a child process started once tp 8B's d2d arm has
   closed its second group, beside tp 8B's resident loop, the TINY
   phases, train 1B and learn 1B; joined before the timed kernel phases):
   the training mesh of train/train_step.py and train/pipeline.py, one
   process a rank (parallel/launch.run_spmd: the child is rank 0 and
   spawns rank 1), both ranks on the one card over gloo staged through
   pinned host buffers (NCCL's branch, one card a rank, is written but
   not run: one GPU). `llama-3.2-1b-instruct` at full width (d_model
   2048, 32/8 heads, d_ff 8192, vocab 128,256 from the byte tokenizer),
   bf16, depth cut to TRAIN_PAR_LAYERS of 16 to fit beside the other
   phases; random from seed 0; make_batches' first 4 x 2048 batch (seed
   0, loss_start and loss_weights). The reference is one AdamW step on one
   device from the same seed (for pp, the batch's tokens and lengths
   only, as the pipeline trains), and its gradients in f32 from the same
   bf16-valued weights. Layouts, each its own spawned group reading seed
   0's tree from a file: {dp 2}, {fsdp 2}, {tp 2}, {sp 2} (ring
   attention) and {pp 2, n_micro 2}. Each layout's step-1 loss must be
   within TRAIN_PAR_LOSS_TOL of the reference's (relative); each leaf's
   gathered gradient no further from the f32 gradient (|g - g32| / |g32|)
   than one bf16 device's is, plus TRAIN_PAR_GRAD_TOL (its error against
   one bf16 device is printed beside it); the leaves ranks replicate
   bit-equal across them after the step; and no rank may import JAX.
   Then TRAIN_PAR_TIMED more steps are timed: ms a step, the collectives
   a step and their bytes on each group, each rank's peak memory.
7. K3, untimed, at `K3_EDGE_CASES` (TINY's widths, N and K not whole
   tiles, M = 96 and 384, totals 0 / 1 / 64 / 65 / M), then at the seven 8B
   weight shapes, int8 pairs and bf16, x [R*24, K] for R = 4 and 8, and
   totals 0, R*24 and the smallest, median and largest that path A ran:
   rows below `total` within 6e-2 of the reference's RMS (the error's RMS
   within 5e-3 of it), rows from ceil(total/64)*64 on exactly zero, outputs
   finite. Timed with a cold L2 (the captured calls rotate over copies of
   the weight, >= 134 MB in all, as each layer reads its own) and hot.
   Library yardstick, cold and hot: torch.matmul of the computed rows
   against a bf16 weight (for int8 a dequantized copy made beforehand, so
   it reads twice the weight bytes).
8. K4, untimed, at `K4_EDGE_CASES` (head dims 64 and 128; g 1, 2, 3, 4
   and 8; pages of 16 to 256 tokens; lens 0, 1, ps - 1, ps, ps + 1, P*ps,
   past P*ps and negative; scattered, descending and repeated page ids;
   one split, more splits planned than pages, and 40 splits), both modes;
   then at the shapes
   of path B's step, taken from its engine (its page geometry, its page
   tables padded with the trash row, its own-token lengths with the trash
   row's negative one), both modes, and at `K4_LONG` (every slot near 64
   pages), partials. Held like K1/K2 (empty rows exactly m = -1e30, l = 0,
   o = 0) and bitwise against a second call. Timed cold (the captured
   calls rotate over copies of the caches, >= 134 MB of valid K/V in all,
   since each layer reads its own cache) and, at path B's shapes, hot;
   after the CUDA-graph replays every split-merge counter must be 0.
   Library yardstick: SDPA on KV gathered beforehand (the gather is not
   timed), cold and hot.
9. tp kernels: K1, K2 and K4 (partials) at one tensor-parallel rank's
   shapes: Llama-3.3-70B at tp 8 (8 q heads over 1 kv head, hd 128) at
   the 8B decision path's geometry (`TP_K1_CASES`, `TP_K2_CASES`,
   `TP_K4_CASES`), held and timed as above; Llama-3.1-8B at tp 2 (16 over
   4), the tp 8B phase's shapes, held (`TP_HELD_*`). Each kernel's entry of
   the result line gains `tp_launches` (each rank's, from the tp 8B phase),
   `tp_d2d_launches` (each adopter rank's, in the d2d arm's wave)
   and `tp_shapes` (these records).

The last lines are a JSON object with per-kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
# Bytes of distinct prefix K/V (K1) or weights (K3) that a cold-L2 timing
# rotates over: four layers' worth of K1's prefix at Sp 8192 (33.5 MB
# each), well past the 50 MB L2.
COLD_BYTES = 134_217_728
DEVICE = "cuda"  # where the K3/K4 cases run
NEG_INF = -1e30
N_SINGLES = 4  # single decisions before the batch of 8, in graph mode
# Eager mode's: none, and no census single after the batch either. An
# eager 8B single is host-bound (15-26 s on an H100 host, more under
# torch.profiler): with four in each eager drive the smoke ran 1,332.9 s,
# and with the census single alone 1,164.9 s on a slow host, against its
# 1,200 s limit. Eager mode still decides the batch, compared with graph
# mode's token for token.
N_EAGER_SINGLES = 0
BLOCK_F = 24  # the engine's wave block width
PATH_B_NEW_TOKENS = 64
# K3 against its plain version: both sum exact bf16 products in f32 and
# round once; they differ in the order of the sums, so an output element
# may round to a neighbouring bf16 value (one ulp: up to 1/128 of its
# size, 3.1e-2 of the RMS at the largest outputs of the first chip run).
# Held to 6e-2 of the reference's RMS for the largest error and 5e-3 for
# the RMS of the error (rounding alone leaves ~1e-3; a dropped 32-wide K
# step of 4096 leaves ~9e-2).
TOL_K3_RMS = 6e-2
TOL_K3_ERR_RMS = 5e-3


def print_ptxas(reports) -> None:
    """The ptxas report of each library built: registers, spills and errors;
    for the Hopper kernels K1 (prefix_attention), K2 (causal_attention), K3
    (ragged_matmul) and K4 (paged_attention) every line (shared memory,
    warnings, wgmma serialization notes)."""
    for name, log in reports.items():
        for line in log.splitlines():
            low = line.lower()
            full = name in ("prefix_attention", "causal_attention", "ragged_matmul",
                            "paged_attention") and (
                "ptxas" in low or "stack frame" in low)
            if full or "registers" in line or "spill" in line or "error" in low:
                print(f"  {name}: {line.strip()}", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Device time of one call: after two warm-up calls, `reps` calls are
    captured back to back in a CUDA graph, and the median of three replays
    between CUDA events, over `reps`, is the time. Host launch overhead is
    left out, as it is in no kernel's bound. A call that cannot be captured
    is timed as `reps` eager calls back to back (host gaps included; the
    line printed says so)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    except RuntimeError as exc:
        print(f"  not capturable, timed eagerly: {exc}", flush=True)
        graph = None

        def run():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


# ------------------------------------------------------------- kernel phase
# Queries are scaled so that the scores have a standard deviation of about
# 4: attention is peaked on a few keys, so a wrong mask, a dropped tile or a
# wrong P.V product moves the normalized output by a large fraction of its
# size, far past the tolerances below.
Q_SCALE = 4.0
# Tolerances of the kernels against their plain versions on the same bf16
# inputs. Both round q and P to bf16 at the same points; they differ in the
# order of the f32 sums and in that the kernel rounds P against its running
# maximum. The normalized output is held relative to the reference's RMS.
TOL_O_RMS = 3e-2
TOL_M = 1e-4  # times (1 + max |m|)
TOL_L = 1e-4  # relative


def _compare(got, want, valid_rows):
    """Errors of the normalized outputs, of m and of l on rows with a valid
    key; rows without one must be exactly m = NEG_INF, l = 0."""
    import torch

    o, m, l = got
    o_r, m_r, l_r = want
    vr = valid_rows
    out = (o / l.clamp(min=1e-30)[..., None])[vr]
    ref = (o_r / l_r.clamp(min=1e-30)[..., None])[vr]
    if vr.any():
        rms = ref.square().mean().sqrt().item()
        err_o = (out - ref).abs().max().item()
        err_m = (m[vr] - m_r[vr]).abs().max().item()
        tol_m = TOL_M * (1.0 + m_r[vr].abs().max().item())
        err_l = ((l[vr] - l_r[vr]).abs() / l_r[vr]).max().item()
    else:
        rms = err_o = err_m = tol_m = err_l = 0.0
    dead = ~vr
    dead_ok = bool((m[dead] == NEG_INF).all() and (l[dead] == 0).all())
    finite = bool(torch.isfinite(o).all() and torch.isfinite(l).all())
    ok = (err_o <= TOL_O_RMS * rms and err_m <= tol_m and err_l <= TOL_L
          and dead_ok and finite)
    return ok, {"max_abs_err": err_o, "ref_rms": rms, "m_err": err_m,
                "l_rel_err": err_l, "masked_rows_exact": dead_ok}


def _prefix_check(gen, step, B, S, Sp, plen, H=32, n_kv=8, hd=128):
    """K1 against its plain version on random inputs: (ok, rec, inputs)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    dev = "cuda"
    q = (Q_SCALE * torch.randn((B, S, H, hd), generator=gen, device=dev)).to(torch.bfloat16)
    k = torch.randn((Sp, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((Sp, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    plen_d = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = pa.flash_prefix_attention_parts(q, k, v, plen_d)
    want = pa.prefix_attention_parts_plain(q, k, v, plen_d)
    torch.cuda.synchronize()
    valid = torch.full(want[1].shape, plen > 0, dtype=torch.bool, device=dev)
    ok, rec = _compare(got, want, valid)
    rec.update(step=step, splits=_k1_splits(B, S, Sp, H, n_kv, hd),
               shape=f"q[{B},{S},{H},{hd}] prefix[{Sp},{n_kv},{hd}] prefix_len={plen}")
    return ok, rec, (q, k, v, plen_d)


def _prefix_case(gen, step, B, S, Sp, plen, H=32, n_kv=8, hd=128):
    """K1 held against its plain version, then timed with a cold and a hot
    L2 beside its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    ok, rec, (q, k, v, plen_d) = _prefix_check(gen, step, B, S, Sp, plen, H, n_kv, hd)
    flops = 4.0 * B * S * H * plen * hd
    nbytes = (B * S * H * hd * 2 + 2 * plen * n_kv * hd * 2 + 4
              + B * H * S * hd * 4 + 2 * B * H * S * 4)
    # Cold L2, as the path meets it: each layer reads its own prefix K/V, so
    # the timed calls rotate over distinct buffers (>= COLD_BYTES in all).
    n_buf = max(4, -(-COLD_BYTES // (k.nbytes + v.nbytes)))
    bufs = [(k, v)] + [
        (torch.randn_like(k, dtype=torch.float32).to(torch.bfloat16),
         torch.randn_like(v, dtype=torch.float32).to(torch.bfloat16))
        for _ in range(n_buf - 1)
    ]
    kernel_bufs = itertools.cycle(bufs)

    def kernel_cold():
        kb, vb = next(kernel_bufs)
        pa.flash_prefix_attention_parts(q, kb, vb, plen_d)

    rec.update(
        ms=_time_ms(kernel_cold, 20),
        ms_hot=_time_ms(lambda: pa.flash_prefix_attention_parts(q, k, v, plen_d), 20),
        plain_ms=_time_ms(lambda: pa.prefix_attention_parts_plain(q, k, v, plen_d), 5),
        cold_buffers=n_buf,
        **_bound(flops, nbytes),
    )
    if plen > 0:
        qt = q.transpose(1, 2)
        views = [
            tuple(t[:plen].permute(1, 0, 2).unsqueeze(0).expand(B, n_kv, plen, hd)
                  for t in kv)
            for kv in bufs
        ]
        lib_bufs = itertools.cycle(views)

        def sdpa_cold():
            kt, vt = next(lib_bufs)
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

        rec["library_ms"] = _library_ms(sdpa_cold)
        rec["library_ms_hot"] = _library_ms(
            lambda: F.scaled_dot_product_attention(qt, *views[0], enable_gqa=True)
        )
    else:
        rec["library_ms"] = rec["library_ms_hot"] = None
    return ok, rec


def _causal_check(gen, step, B, S, lens, H=32, n_kv=8, hd=128):
    """K2 against its plain version on random inputs: (ok, rec, inputs)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    dev = "cuda"
    q = (Q_SCALE * torch.randn((B, S, H, hd), generator=gen, device=dev)).to(torch.bfloat16)
    k = torch.randn((B, S, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = pa.flash_causal_attention_parts(q, k, v, lens_d)
    want = pa.causal_attention_parts_plain(q, k, v, lens_d)
    torch.cuda.synchronize()
    valid = (lens_d > 0)[:, None, None, None].expand(want[1].shape)
    ok, rec = _compare(got, want, valid)
    rec.update(step=step, shape=f"q[{B},{S},{H},{hd}] n_kv={n_kv} lens={list(lens)}")
    return ok, rec, (q, k, v, lens_d)


def _causal_case(gen, step, B, S, lens, H=32, n_kv=8, hd=128):
    """K2 held against its plain version, then timed hot (as the path meets
    its inputs, just written by the layer) and cold (the captured calls
    rotate over >= COLD_BYTES of input copies) beside its plain version and
    two SDPA yardsticks: with the dense causal-and-length mask (every
    shape), and with is_causal=True on each backend that takes it (where
    every len is S, the same function)."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    ok, rec, (q, k, v, lens_d) = _causal_check(gen, step, B, S, lens, H, n_kv, hd)
    pairs = sum(sum(min(max(n, 0), s + 1) for s in range(S)) for n in lens)
    flops = 4.0 * pairs * H * hd
    nbytes = (B * S * H * hd * 2 + 2 * sum(min(max(n, 0), S) for n in lens) * n_kv * hd * 2
              + 4 * B + B * H * S * hd * 4 + 2 * B * H * S * 4)
    n_buf = max(4, -(-COLD_BYTES // (q.nbytes + k.nbytes + v.nbytes)))
    copies = itertools.cycle([(q, k, v)] + [
        tuple((t.float() + torch.randn(t.shape, generator=gen, device=t.device)
               ).to(torch.bfloat16) for t in (q, k, v))
        for _ in range(n_buf - 1)
    ])

    def kernel_cold():
        pa.flash_causal_attention_parts(*next(copies), lens_d)

    rec.update(
        ms=_time_ms(lambda: pa.flash_causal_attention_parts(q, k, v, lens_d), 20),
        ms_cold=_time_ms(kernel_cold, 20),
        plain_ms=_time_ms(lambda: pa.causal_attention_parts_plain(q, k, v, lens_d), 5),
        cold_buffers=n_buf,
        **_bound(flops, nbytes),
    )
    dev = q.device
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :])[None] & (pos[None, :] < lens_d[:, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rec["library_ms"] = _library_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True
        )
    )
    rec["library_causal"] = (
        _sdpa_causal_ms(qt, kt, vt) if all(n == S for n in lens) else {}
    )
    yardsticks = [t for t in (rec["library_ms"], *rec["library_causal"].values())
                  if t is not None]
    rec["ratio"] = rec["ms"] / min(yardsticks) if yardsticks else None
    return ok, rec


def _sdpa_causal_ms(qt, kt, vt) -> dict:
    """{backend: ms} of scaled_dot_product_attention(is_causal=True) on each
    backend that takes these inputs, GQA as it is or, where a backend
    refuses it, with K/V expanded to every query head beforehand (the copy
    is not timed)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = qt.shape[1] // kt.shape[1]
    expanded = (kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1))
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for name, kv, extra in ((backend.name, (kt, vt), {"enable_gqa": True}),
                                (f"{backend.name} (K/V expanded)", expanded, {})):
            def call(kv=kv, extra=extra, backend=backend):
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(qt, *kv, is_causal=True, **extra)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    call()
            except (RuntimeError, TypeError):
                continue
            out[name] = _library_ms(call)
            break
    return out


def _library_ms(fn) -> float | None:
    """Time of the PyTorch library yardstick, or None where this PyTorch
    build refuses the call (it is a yardstick only, never on the path)."""
    try:
        return _time_ms(fn, 20)
    except (RuntimeError, TypeError) as exc:
        print(f"  library call refused: {exc}", flush=True)
        return None


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


def path_shapes(backend, nodes, pods, n_singles):
    """The K1 and K2 calls the decision phase makes, from the engine's own
    geometry for these prompts: the chunked prefix prefill of the cluster
    prefix, then for each wave (one per single decision, then the batch)
    its suffix prefill and its block decode; and K1 in a pack chunk of the
    admission phase's packed batch (q [1, admission_chunk_tokens] against
    the same prefix). Each K1 case is (step, B, S, Sp, prefix_len) and each
    K2 case (step, B, S, lens); repeats are dropped."""
    eng = backend.engine
    items = [backend._prepare_item(p, nodes) for p in pods]
    n = len(items[0].prefix_ids)
    chunk = min(eng.prefix_chunk, eng.prefill_buckets[-1])
    if n <= chunk:
        raise RuntimeError(f"a {n}-token prefix does not take the chunked prefill")
    cap = -(-n // chunk) * chunk + chunk  # engine._prefill_prefix_chunked
    # the block width of a wave follows the grammar the worker installs
    # with the prefix; installing it here as well changes nothing else
    eng.set_grammar(backend._grammar_for(items[0].group_key[1]))
    k1, k2 = {}, {}
    for start in range(0, n, chunk):
        k1.setdefault((1, chunk, cap, start), "prefix chunk")
        k2.setdefault((1, chunk, (min(chunk, n - start),)), "prefix chunk")
    for wave in [[it] for it in items[:n_singles]] + [items]:
        lens = [len(it.suffix_ids) for it in wave]
        bucket = eng._bucket_for(max(lens))
        R, _, F = eng._wave_geometry(len(wave), backend.max_new_tokens)
        lens += [0] * (R - len(lens))
        k1.setdefault((R, bucket, cap, n), "suffix prefill")
        k1.setdefault((R, F, cap, n), "block decode")
        if not any(key[:2] == (R, bucket) for key in k2):
            k2[(R, bucket, tuple(lens))] = "suffix prefill"
    k1.setdefault((1, eng.admission_chunk_tokens, cap, n), "pack chunk")
    return ([(step, *key) for key, step in k1.items()],
            [(step, *key) for key, step in k2.items()])


# K1 off the 8B path's shapes, held but not timed: (step, B, S, Sp,
# prefix_len, H, n_kv, hd). TINY's head dim 64 with g = 2 (the reference
# phase's width); many key splits, most of them past prefix_len, at hd 64 and
# 128 (the combine over 32-64 splits); a buffer that is not a whole number
# of key tiles; a block-decode call with an empty prefix (every split empty).
K1_EDGE_CASES = [
    ("TINY", 1, 37, 64, 50, 4, 2, 64),
    ("TINY many splits", 2, 3, 4096, 3000, 4, 2, 64),
    ("hd 128 many splits", 1, 5, 4096, 130, 8, 2, 128),
    ("ragged buffer end", 2, 70, 1000, 1000, 8, 2, 128),
    ("empty prefix", 8, 24, 8192, 0, 32, 8, 128),
]


# K2 off the 8B path's shapes, held but not timed: (step, B, S, lens, H,
# n_kv, hd). TINY's head dim 64 with g = 2 and an empty row at a chunk that
# is not whole tiles; S 300 with lens ending inside the second and third
# key tiles and at 1; g = 8 (Llama-3.3-70B's 64/8 heads); g = 1 at hd 64; a
# length past S beside a negative one.
K2_EDGE_CASES = [
    ("TINY", 2, 37, (37, 0), 4, 2, 64),
    ("S 300", 3, 300, (300, 129, 1), 32, 8, 128),
    ("g 8", 1, 520, (520,), 64, 8, 128),
    ("g 1 hd 64", 2, 300, (300, 200), 8, 8, 64),
    ("len > S, len < 0", 2, 64, (100, -3), 32, 8, 128),
]


def kernel_phase(k1_cases, k2_cases, k1_edge_cases=K1_EDGE_CASES,
                 k2_edge_cases=K2_EDGE_CASES, timed=True
                 ) -> tuple[bool, list[dict], list[dict]]:
    """K1 and K2 held against their plain versions at the path's shapes and
    at their edge cases; timed at the path's shapes unless `timed` is
    False."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1, k2 = [], []
    runs = (
        [(k1, _prefix_check, c) for c in k1_edge_cases]
        + [(k1, _prefix_case if timed else _prefix_check, c) for c in k1_cases]
        + [(k2, _causal_check, c) for c in k2_edge_cases]
        + [(k2, _causal_case if timed else _causal_check, c) for c in k2_cases]
    )
    for recs, run, case in runs:
        ok, rec = run(gen, *case)[:2]
        rec["ok"] = ok
        recs.append(rec)
        torch.cuda.empty_cache()
    for name, recs in (("K1", k1), ("K2", k2)):
        for rec in recs:
            _print_attention_case(name, rec)
    return all(r["ok"] for r in k1 + k2), k1, k2


def _k1_splits(B, S, Sp, H=32, n_kv=8, hd=128) -> int:
    """Key splits K1's wrapper plans for this call on this card."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    sms = kernels.sm_count(torch.device("cuda"))
    return pa.kv_splits(B * S * (H // n_kv), n_kv, Sp, hd, sms)[0]


def _print_attention_case(name, rec):
    line = (f"{name} {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
            f"m_err={rec['m_err']:.3g} l_rel_err={rec['l_rel_err']:.3g}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']}")
    if "ms_hot" in rec:
        line += f" (hot L2: ms={rec['ms_hot']:.4f} library_ms={rec['library_ms_hot']})"
    if "ms_cold" in rec:
        line += (f" (cold L2: ms={rec['ms_cold']:.4f}) is_causal SDPA "
                 f"{rec['library_causal']} ratio={rec['ratio']}")
    print(line, flush=True)


# ------------------------------------------------------------- K3 phase
def k3_weights(cfg):
    """(name, K, N) of the seven matmuls K3 runs in each layer."""
    D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return [("wq", D, H), ("wk", D, KV), ("wv", D, KV), ("wo", H, D),
            ("w_gate", D, Fd), ("w_up", D, Fd), ("w_down", Fd, D)]


def _compare_k3(got, want, total):
    """K3 against its plain version: rows below `total` by the largest
    error and the error's RMS, both relative to the reference's RMS; rows
    from the end of the last computed 64-row tile exactly zero."""
    import torch

    end = min(-(-total // 64) * 64, got.shape[0])
    if total > 0:
        ref = want[:total].float()
        diff = got[:total].float() - ref
        rms = ref.square().mean().sqrt().item()
        err = diff.abs().max().item()
        err_rms = diff.square().mean().sqrt().item()
    else:
        rms = err = err_rms = 0.0
    zero_ok = bool((got[end:] == 0).all())
    finite = bool(torch.isfinite(got.float()).all())
    ok = (err <= TOL_K3_RMS * rms and err_rms <= TOL_K3_ERR_RMS * rms
          and zero_ok and finite)
    return ok, {"max_abs_err": err, "err_rms": err_rms, "ref_rms": rms,
                "zero_tail_exact": zero_ok}


def _k3_weight(gen, K, N, int8):
    """A random [K, N] weight: bf16, or the int8 pair quantized from one."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models.quant import quantize_weight

    w = (torch.randn((K, N), generator=gen, device=DEVICE) * K**-0.5).to(torch.bfloat16)
    return quantize_weight(w) if int8 else w


def _k3_check(gen, w, M, total):
    """K3 against its plain version on random x [M, K]: (ok, rec, x, total)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import (
        ragged_matmul,
        ragged_matmul_plain,
    )

    K = (w["q"] if isinstance(w, dict) else w).shape[0]
    x = torch.randn((M, K), generator=gen, device=DEVICE).to(torch.bfloat16)
    total_d = torch.tensor(total, dtype=torch.int32, device=DEVICE)
    got = ragged_matmul(x, w, total_d)
    want = ragged_matmul_plain(x, w, total_d)
    torch.cuda.synchronize()
    ok, cmp = _compare_k3(got, want, total)
    return ok, {**cmp, "ok": ok, "total": total}, x, total_d


def _k3_splits(N, K) -> int:
    """K splits K3's wrapper plans for this weight on this card."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import ragged_matmul as rm

    return rm.k_splits(N, K, kernels.sm_count(torch.device(DEVICE)))[0]


def _k3_copies(w, n_bytes):
    """`w` and copies of it (distinct memory), >= COLD_BYTES in all."""
    n = max(2, -(-COLD_BYTES // n_bytes))
    if isinstance(w, dict):
        return [w] + [{"q": w["q"].clone(), "scale": w["scale"].clone()}
                      for _ in range(n - 1)]
    return [w] + [w.clone() for _ in range(n - 1)]


def _k3_case(gen, name, copies, lib_copies, R, total, int8):
    """K3 held at x [R*24, K] and `total`, then timed with a cold L2 (the
    captured calls rotate over `copies`, as each layer reads its own
    weights) and hot (one weight replayed), beside its plain version and
    the yardstick: torch.matmul of the computed rows against a bf16 weight
    (for int8 a dequantized copy made beforehand, so it reads twice the
    weight bytes), cold over `lib_copies` and hot."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import (
        BM,
        ragged_matmul,
        ragged_matmul_plain,
    )

    w = copies[0]
    K, N = (w["q"] if int8 else w).shape
    M = R * BLOCK_F
    ok, rec, x, total_d = _k3_check(gen, w, M, total)
    end = min(-(-total // BM) * BM, M)
    wbytes = K * N * (1 if int8 else 2) + (4 * N if int8 else 0)
    nbytes = (wbytes + end * K * 2 if end else 0) + M * N * 2
    rot = itertools.cycle(copies)
    rec.update(
        step=f"R={R}", weight=name, int8=int8, splits=_k3_splits(N, K),
        shape=f"x[{M},{K}] @ {'int8' if int8 else 'bf16'} w[{K},{N}] total={total}",
        ms=_time_ms(lambda: ragged_matmul(x, next(rot), total_d), 20),
        ms_hot=_time_ms(lambda: ragged_matmul(x, w, total_d), 20),
        plain_ms=_time_ms(lambda: ragged_matmul_plain(x, w, total_d), 5),
        cold_copies=len(copies),
        **_bound(2.0 * end * K * N, nbytes),
    )
    if end:
        xs = x[:end]
        lib_rot = itertools.cycle(lib_copies)
        rec["library_ms"] = _library_ms(lambda: torch.matmul(xs, next(lib_rot)))
        rec["library_ms_hot"] = _library_ms(lambda: torch.matmul(xs, lib_copies[0]))
    else:
        rec["library_ms"] = rec["library_ms_hot"] = None
    return ok, rec


# K3 off the 8B path's shapes, held but not timed, for int8 and bf16
# weights: (name, M, K, N, totals). TINY's widths (d_model 256, q/kv/ff
# widths 256/128/512) at R = 4; N not a whole 128-column tile; K not a whole
# 64-deep ring stage; M > 192 (R = 16), two passes over the weights.
K3_EDGE_CASES = [
    ("TINY wq", 96, 256, 256, (0, 1, 64, 65, 96)),
    ("TINY wk", 96, 256, 128, (0, 1, 64, 65, 96)),
    ("TINY w_gate", 96, 256, 512, (0, 1, 64, 65, 96)),
    ("N not whole column tiles", 192, 4096, 208, (0, 1, 64, 65, 192)),
    ("K not whole ring stages", 192, 1000, 256, (0, 1, 64, 65, 192)),
    ("R=16, M > 192", 384, 4096, 1024, (0, 1, 64, 65, 193, 384)),
]


def k3_phase(cfg, totals_by_r, edge_cases=K3_EDGE_CASES) -> tuple[bool, list[dict]]:
    """K3 held at `edge_cases`, then at every weight shape of path A, both
    weight forms, for each row bucket R and its totals (0, the path's
    smallest/median/largest, R*F), timed there cold and hot."""
    import torch

    from k8s_llm_scheduler_tpu_torch.ops import ragged_matmul as rm

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    if hasattr(rm, "SMEM_BYTES"):
        print(f"K3 dynamic shared memory: {rm.SMEM_BYTES} bytes a block", flush=True)
    recs = []
    for name, M, K, N, totals in edge_cases:
        for int8 in (True, False):
            w = _k3_weight(gen, K, N, int8)
            for total in totals:
                ok, rec, _, _ = _k3_check(gen, w, M, total)
                rec.update(step="edge", weight=name, int8=int8,
                           shape=f"x[{M},{K}] @ {'int8' if int8 else 'bf16'} "
                                 f"w[{K},{N}] total={total}")
                recs.append(rec)
                _print_k3(rec)
    for name, K, N in k3_weights(cfg) if totals_by_r else ():
        for int8 in (True, False):
            w = _k3_weight(gen, K, N, int8)
            copies = _k3_copies(w, K * N * (1 if int8 else 2))
            w_lib = (w["q"].float() * w["scale"]).to(torch.bfloat16) if int8 else w
            lib_copies = _k3_copies(w_lib, K * N * 2)
            for R, seen in sorted(totals_by_r.items()):
                med = int(statistics.median_low(seen)) if seen else None
                picks = {0, R * BLOCK_F} | ({min(seen), med, max(seen)} if seen else set())
                for total in sorted(picks):
                    ok, rec = _k3_case(gen, name, copies, lib_copies, R, total, int8)
                    rec["median_total"] = total == med
                    recs.append(rec)
                    _print_k3(rec)
            del copies, lib_copies
            torch.cuda.empty_cache()
    return all(r["ok"] for r in recs), recs


def _print_k3(rec):
    line = (f"K3 {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} err_rms={rec['err_rms']:.3g} "
            f"(rms {rec['ref_rms']:.3g}) zero_tail={rec['zero_tail_exact']}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']} "
                 f"(hot L2: ms={rec['ms_hot']:.4f} "
                 f"library_ms={rec['library_ms_hot']})")
    print(line, flush=True)


# ------------------------------------------------------------- K4 phase
# K4 off path B's shapes, held but not timed, both modes: (name, B, H, n_kv,
# hd, page size, pages in the cache, table width P, lens, table kind). The
# lens cover 0, 1, ps - 1, ps, ps + 1, P*ps, past P*ps and negative; the
# tables hold scattered, descending or repeated page ids. Head dims 64 and
# 128; g 1, 2 (TINY), 3 (rounded up to 4 in the kernel), 4 and 8
# (Llama-3.3-70B's 64/8 heads); pages of 16, 32, 64, 100, 203 (the largest
# the first K4 kernel took at hd 128) and 256 tokens, so pages of several boxes
# and stages of several pages. One sequence on 8 kv heads plans 17 splits
# (more than its pages); 40 sequences plan one split; one sequence of 40
# pages of 256 on one kv head takes 40 splits (the fold's 8-split rounds).
K4_EDGE_CASES = [
    ("TINY lens 0/1/ps-1/ps/ps+1/<0", 6, 4, 2, 64, 16, 64, 8, (0, 1, 15, 16, 17, -3),
     "scattered"),
    ("g 1 hd 64, P*ps and past it", 4, 8, 8, 64, 16, 40, 8, (128, 500, 64, -1),
     "descending"),
    ("g 8, repeated pages", 3, 64, 8, 128, 64, 16, 8, (512, 65, 63), "repeated"),
    ("g 3, ps 32", 3, 12, 4, 128, 32, 16, 4, (100, 31, 128), "scattered"),
    ("ps 100 hd 64", 2, 16, 4, 64, 100, 12, 5, (500, 101), "descending"),
    ("ps 203", 3, 32, 8, 128, 203, 24, 6, (1218, 204, 202), "scattered"),
    ("B 1, splits past the pages", 1, 32, 8, 128, 64, 64, 64, (100,), "scattered"),
    ("40 sequences, one split", 40, 32, 8, 128, 64, 200, 4,
     tuple((37 * i) % 260 - 4 for i in range(40)), "scattered"),
    ("ps 256, 40 splits", 1, 4, 1, 64, 256, 48, 40, (10000,), "descending"),
]
# Path B's engine at max_pages_per_seq = 64 with every slot near its end: 8
# sequences of 3,969-4,032 own tokens (63 pages each, 504 of the 512) and
# the trash row at -5,488. (step, q shape, cache shape, lens).
K4_LONG_LENS = (4032, 4025, 4011, 4003, 3994, 3985, 3977, 3969, -5488)
K4_LONG = ("long: 63 pages a slot", (9, 32, 128), (512, 64, 8, 128), K4_LONG_LENS)


def _k4_tables(kind, B, P, num_pages, gen):
    """[B, P] int32 page ids: distinct and scattered, descending, or few ids
    reused across and within rows."""
    import torch

    if kind == "scattered":
        ids = torch.randperm(num_pages, generator=gen)
        ids = ids.repeat(-(-B * P // num_pages))[:B * P]
    elif kind == "descending":
        ids = (num_pages - 1 - torch.arange(B * P)) % num_pages
    else:
        ids = torch.randint(0, min(4, num_pages), (B * P,), generator=gen)
    return ids.reshape(B, P).to(torch.int32)


def _k4_compare(got, want, lens, normalize):
    """The smoke's K4 comparison: normalized outputs (and for the partials
    m and l) as _compare holds K1/K2, and rows of a sequence with len <= 0
    exactly m = -1e30, l = 0, o = 0 (normalized: 0)."""
    import torch

    B = lens.shape[0]
    if normalize:
        H = got.shape[1]
        vr = (lens > 0)[:, None].expand(B, H)
        if vr.any():
            ref = want[vr].float()
            rms = ref.square().mean().sqrt().item()
            err = (got[vr].float() - ref).abs().max().item()
        else:
            rms = err = 0.0
        dead_ok = bool((got[~vr] == 0).all())
        ok = err <= TOL_O_RMS * rms and dead_ok and bool(torch.isfinite(got.float()).all())
        return ok, {"max_abs_err": err, "ref_rms": rms, "masked_rows_exact": dead_ok}
    n_kv, g = got[1].shape[1:]
    vr = (lens > 0)[:, None, None].expand(B, n_kv, g)
    # the partials carry no S axis: add one for the shared comparison
    ok, rec = _compare(
        tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in got),
        tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in want),
        vr.unsqueeze(-1),
    )
    o_dead = bool((got[0][~vr] == 0).all())
    rec["masked_rows_exact"] = rec["masked_rows_exact"] and o_dead
    return ok and o_dead, rec


def _k4_check(gen, step, q_shape, pages_shape, tables, lens, normalize):
    """K4 against its plain version on random inputs, and against itself
    (bitwise, run to run): (ok, rec, (kernel, plain, q, k, v, tables,
    lens))."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg

    dev = DEVICE
    B, H, hd = q_shape
    _, ps, n_kv, _ = pages_shape
    q = (Q_SCALE * torch.randn(q_shape, generator=gen, device=dev)).to(torch.bfloat16)
    kc = torch.randn(pages_shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(pages_shape, generator=gen, device=dev).to(torch.bfloat16)
    tables = tables.to(dev).contiguous()
    lens = lens.to(dev).contiguous()
    kernel = pg.paged_decode_attention if normalize else pg.paged_decode_attention_parts
    plain = pg.paged_attention_plain if normalize else pg.paged_attention_parts_plain
    got = kernel(q, kc, vc, tables, lens)
    again = kernel(q, kc, vc, tables, lens)
    want = plain(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    ok, rec = _k4_compare(got, want, lens, normalize)
    pairs = zip(got, again) if not normalize else [(got, again)]
    rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in pairs)
    rec.update(
        step=step, mode="normalized" if normalize else "parts",
        ok=ok and rec["bitwise_repeat"],
        shape=(f"q[{B},{H},{hd}] pages{list(pages_shape)} tables{list(tables.shape)} "
               f"lens={lens.tolist()}"),
    )
    if hasattr(pg, "paged_splits"):
        rec["splits"] = pg.paged_splits(B, n_kv, tables.shape[1], kernels.sm_count(q.device))
    return rec["ok"], rec, (kernel, plain, q, kc, vc, tables, lens)


def _k4_tickets_zero() -> bool | None:
    """Whether every split-merge counter is 0 (None for a K4 without them)."""
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg

    counters = getattr(pg, "_tickets", None)
    if counters is None:
        return None
    return all(int(t.abs().sum()) == 0 for t in counters.values())


def _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize, hot=True):
    """K4 held as _k4_check does, then timed cold (the captured calls
    rotate over copies of the caches whose valid bytes add up to >=
    COLD_BYTES, as each layer reads its own cache) and, unless `hot` is
    False, hot (one cache replayed), beside its plain version and the
    yardstick: SDPA on KV gathered beforehand (the gather untimed), cold
    over as many gathered copies and hot."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops.attention import gather_pages

    ok, rec, (kernel, plain, q, kc, vc, tables, lens) = _k4_check(
        gen, step, q_shape, pages_shape, tables, lens, normalize)
    B, H, hd = q_shape
    _, ps, n_kv, _ = pages_shape
    n_tok = int(lens.clamp(min=0, max=tables.shape[1] * ps).sum())
    n_pages = sum(-(-min(max(int(n), 0), tables.shape[1] * ps) // ps) for n in lens.tolist())
    out_bytes = B * H * hd * 2 if normalize else B * H * hd * 4 + 2 * B * H * 4
    kv_bytes = 2 * n_tok * n_kv * hd * 2
    nbytes = B * H * hd * 2 + kv_bytes + 4 * n_pages + 4 * B + out_bytes
    n_copies = max(2, -(-COLD_BYTES // max(kv_bytes, 1)))
    copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_copies - 1)]
    rot = itertools.cycle(copies)
    rec.update(
        ms=_time_ms(lambda: kernel(q, *next(rot), tables, lens), 20),
        ms_hot=_time_ms(lambda: kernel(q, kc, vc, tables, lens), 20) if hot else None,
        plain_ms=_time_ms(lambda: plain(q, kc, vc, tables, lens), 5),
        cold_copies=n_copies,
        **_bound(4.0 * n_tok * H * hd, nbytes, PEAK_F32_FLOPS),
    )
    del copies, rot
    rec["tickets_zero_after_replays"] = _k4_tickets_zero()
    rec["ok"] = ok = ok and rec["tickets_zero_after_replays"] is not False
    span = -(-max(int(lens.max()), 1) // ps) * ps
    gathered = [tuple(gather_pages(c, tables)[:, :span].transpose(1, 2).contiguous()
                      for c in (kc, vc))]
    gathered += [tuple(t.clone() for t in gathered[0]) for _ in range(n_copies - 1)]
    lib_rot = itertools.cycle(gathered)
    mask = (torch.arange(span, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    qt = q[:, :, None, :]

    def sdpa(kv):
        return F.scaled_dot_product_attention(qt, *kv, attn_mask=mask, enable_gqa=True)

    rec["library_ms"] = _library_ms(lambda: sdpa(next(lib_rot)))
    rec["library_ms_hot"] = _library_ms(lambda: sdpa(gathered[0])) if hot else None
    rec["library_note"] = "SDPA on KV gathered beforehand; the gather is not timed"
    del gathered, lib_rot
    return ok, rec


def _print_k4(rec):
    line = (f"K4 {rec['mode']} {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
            f"dead_exact={rec['masked_rows_exact']} bitwise={rec['bitwise_repeat']}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} (cold, {rec['cold_copies']} copies) "
                 f"ms_hot={rec['ms_hot']} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']} "
                 f"library_ms_hot={rec['library_ms_hot']} "
                 f"tickets_zero={rec['tickets_zero_after_replays']}")
    print(line, flush=True)


def k4_long_case():
    """K4_LONG as a K4 case: tables [9, 64] with 63 distinct pages (of 1..511)
    for each live slot, the trash row's all page 0."""
    import torch

    step, q_shape, pages_shape, lens = K4_LONG
    gen = torch.Generator().manual_seed(7)
    ids = (1 + torch.randperm(pages_shape[0] - 1, generator=gen))[:8 * 63].reshape(8, 63)
    tables = torch.zeros((len(lens), 64), dtype=torch.int32)
    tables[:8, :63] = ids.to(torch.int32)
    return step, q_shape, pages_shape, tables, torch.tensor(lens, dtype=torch.int32)


def k4_phase(cases, edge_cases=K4_EDGE_CASES, long_cases=(), timed=True
             ) -> tuple[bool, list[dict]]:
    """K4 held at `edge_cases`, both modes, then at path B's `cases` (both
    modes) and `long_cases` (partials), timed there unless `timed` is
    False: path B's shapes cold and hot, the long ones cold."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(4)
    recs = []
    for name, B, H, n_kv, hd, ps, num_pages, P, lens, kind in edge_cases:
        tables = _k4_tables(kind, B, P, num_pages, cpu_gen)
        lens_t = torch.tensor(lens, dtype=torch.int32)
        for normalize in (False, True):
            _, rec, _ = _k4_check(gen, f"edge: {name}", (B, H, hd), (num_pages, ps, n_kv, hd),
                                  tables, lens_t, normalize)
            recs.append(rec)
            _print_k4(rec)
        torch.cuda.empty_cache()
    runs = [(c, m, True) for c in cases for m in (False, True)]
    runs += [(c, False, False) for c in long_cases]
    for (step, q_shape, pages_shape, tables, lens), normalize, hot in runs:
        if timed:
            _, rec = _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize, hot)
        else:
            _, rec, _ = _k4_check(gen, step, q_shape, pages_shape, tables, lens, normalize)
        recs.append(rec)
        _print_k4(rec)
        torch.cuda.empty_cache()
    return all(r["ok"] for r in recs), recs


def _launch_counts() -> dict:
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    return {
        "K1": pa.flash_prefix_attention_parts.launches,
        "K2": pa.flash_causal_attention_parts.launches,
        "K3": ragged_matmul.launches,
        "K4": pg.paged_decode_attention_parts.launches + pg.paged_decode_attention.launches,
    }


@contextlib.contextmanager
def launches_by_step(engine):
    """Kernel launches and device runs by step of the engine's work: each
    run of one of its programs (engine/graphs.Program, replayed or eager:
    the suffix prefill and the block iteration of each wave geometry, keyed
    by its row count R, or the decode chunk), each chunked prefix prefill
    ("prefix chunk", its calls as runs) and each chunk of a packed
    admission ("pack chunk"). The wrappers' counts are read before and
    after each (a replay adds what its capture recorded). Yields {step:
    {"runs": n, "K1": .., "K2": .., "K3": .., "K4": ..}}, filled as the
    steps run; the wrappers go on exit."""
    from k8s_llm_scheduler_tpu_torch.engine import graphs

    steps: dict[str, dict] = {}

    def book(step, runs, before):
        after = _launch_counts()
        rec = steps.setdefault(step, {"runs": 0, "K1": 0, "K2": 0, "K3": 0, "K4": 0})
        rec["runs"] += runs
        for k, n in after.items():
            rec[k] += n - before[k]

    run = graphs.Program.run

    def counted_run(prog):
        before, runs0 = _launch_counts(), prog.runs
        try:
            run(prog)
        finally:
            book(prog.name, prog.runs - runs0, before)

    def counted(step, fn):
        def call(*args, **kwargs):
            before = _launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                book(step, 1, before)
        return call

    wrapped = {"_prefill_prefix_chunked": "prefix chunk", "_pack_chunk": "pack chunk"}
    saved = {name: vars(engine).get(name) for name in wrapped}  # another wrapper's
    graphs.Program.run = counted_run
    for name, step in wrapped.items():
        setattr(engine, name, counted(step, getattr(engine, name)))
    try:
        yield steps
    finally:
        graphs.Program.run = run
        for name, fn in saved.items():
            if fn is None:
                delattr(engine, name)
            else:
                setattr(engine, name, fn)


def per_call(steps) -> dict:
    """Kernel launches per device run of each step."""
    return {step: {k: rec[k] / rec["runs"] for k in ("K1", "K2", "K3", "K4")}
            for step, rec in steps.items() if rec["runs"]}


# The host's launch calls as torch.profiler traces them (CUPTI): kernel
# launches through the runtime and the driver, graph launches, and async
# copies and sets.
HOST_KERNEL_CALLS = frozenset(
    ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
HOST_LAUNCH_CALLS = HOST_KERNEL_CALLS | {"cudaGraphLaunch", "cudaMemcpyAsync",
                                         "cudaMemsetAsync"}
# The host's waits on the device as torch.profiler traces them.
HOST_SYNC_CALLS = frozenset(("cudaDeviceSynchronize", "cudaStreamSynchronize",
                             "cudaEventSynchronize"))


def launch_census(fn) -> dict:
    """fn() under torch.profiler, ending in a synchronize: the host's launch
    calls (HOST_LAUNCH_CALLS), of them the kernel launches outside graphs
    and the graph launches, the host's waits on the device
    (HOST_SYNC_CALLS, the closing synchronize included), and the
    operations the device ran (kernels, copies, sets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the CUDA activity alone traces the runtime and driver calls too
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rec = {"host_launches": 0, "host_kernel_launches": 0, "graph_launches": 0,
           "host_syncs": 0, "device_ops": 0}
    # the trace's raw records: an eager decision has ~1.4M, which
    # prof.events() is far slower to build into a tree than to read raw
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            rec["device_ops"] += 1
        elif name in HOST_SYNC_CALLS:
            rec["host_syncs"] += 1
        elif name in HOST_LAUNCH_CALLS:
            rec["host_launches"] += 1
            rec["host_kernel_launches"] += name in HOST_KERNEL_CALLS
            rec["graph_launches"] += name == "cudaGraphLaunch"
    return rec


def _zero_launch_counts() -> None:
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    pa.reset_launch_counts()
    ragged_matmul.launches = 0
    pg.paged_decode_attention_parts.launches = 0
    pg.paged_decode_attention.launches = 0


# ---------------------------------------------------------- reference phase
def reference_phase() -> tuple[bool, dict]:
    """TINY main path on the card (kernels) vs the same weights on the CPU
    (plain versions)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import (
        forward_prefill_suffix_dense,
        init_params,
    )
    from k8s_llm_scheduler_tpu_torch.testing import synthetic_nodes

    tok = ByteTokenizer()
    pe = PromptEngine()
    prefix, suffix = tok.chat_prompt_parts(
        pe.system_prompt, pe.cluster_part(synthetic_nodes(4)), "pod web-0"
    )
    cpu_params = init_params(TINY, seed=1, device="cpu")
    logits = {}
    for dev in ("cuda", "cpu"):
        params = {
            k: {kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
            else v.to(dev)
            for k, v in cpu_params.items()
        }
        eng = InferenceEngine(params, TINY, tok, temperature=0.0, prefix_chunk=512)
        eng.set_prefix(prefix)
        toks = torch.tensor([suffix], dtype=torch.int32, device=dev)
        lg, _, _ = forward_prefill_suffix_dense(
            params, TINY, toks,
            torch.tensor([len(suffix)], dtype=torch.int32, device=dev),
            eng._prefix.k, eng._prefix.v,
            torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev),
        )
        logits[dev] = lg.float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    ok = bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
    rec = {"prefix_tokens": len(prefix), "max_abs_err": err, "max_logit": scale}
    print(f"reference: TINY chunked prefix ({len(prefix)} tokens) + suffix, "
          f"cuda vs cpu logits err={err:.4g} (max |logit| {scale:.4g}) ok={ok}",
          flush=True)
    for name, fn in (
        ("block_decode_int8_ragged", _tiny_block_decode_ragged),
        ("decode_buffered_pallas", _tiny_decode_buffered),
        ("decode_pallas", _tiny_decode),
    ):
        out = {dev: fn(cpu_params, dev).float().cpu() for dev in ("cuda", "cpu")}
        e = (out["cuda"] - out["cpu"]).abs().max().item()
        sc = out["cpu"].abs().max().item()
        good = bool(torch.isfinite(out["cuda"]).all()) and e <= 5e-2 * sc
        rec[name] = {"max_abs_err": e, "max_logit": sc, "ok": good}
        ok = ok and good
        print(f"reference: TINY {name}, cuda vs cpu logits err={e:.4g} "
              f"(max |logit| {sc:.4g}) ok={good}", flush=True)
    return ok, rec


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _tiny_block_decode_ragged(cpu_params, dev):
    """One block-decode iteration at TINY with int8 weights and K3 matmuls;
    logits of the rows with valid tokens."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_block_decode
    from k8s_llm_scheduler_tpu_torch.models.quant import quantize_params

    rng = np.random.default_rng(5)
    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    R, F, Ss, cap, Sp, plen = 4, BLOCK_F, 32, 48, 64, 50
    blk_len = np.asarray([24, 3, 0, 11], np.int32)
    blk_valid = np.arange(F)[None, :] < blk_len[:, None]
    blk_tok = (rng.integers(1, 256, size=(R, F)) * blk_valid).astype(np.int32)
    suffix_lens = np.asarray([32, 20, 0, 7], np.int32)
    tail = np.asarray([5, 0, 0, 12], np.int32)
    positions = (plen + suffix_lens + tail)[:, None] + np.arange(F)[None, :]

    def kvs(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dtype=TINY.dtype, device=dev)

    def ints(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    params = _on(quantize_params(cpu_params), dev)
    logits, _, _ = forward_block_decode(
        params, TINY, ints(blk_tok), torch.from_numpy(blk_valid).to(dev),
        ints(blk_len), ints(positions), kvs(L, R, Ss, kv, hd), kvs(L, R, Ss, kv, hd),
        ints(suffix_lens), kvs(L, R, cap + 1, kv, hd), kvs(L, R, cap + 1, kv, hd),
        ints(tail), kvs(L, Sp, kv, hd), kvs(L, Sp, kv, hd),
        torch.tensor(plen, dtype=torch.int32, device=dev), ragged=True,
    )
    return logits[torch.from_numpy(blk_len > 0).to(dev)]


def _tiny_paged_inputs(dev, rng):
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY

    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    shape = (L, 16, 16, kv, hd)  # 16 pages of 16 tokens
    kc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tables = torch.tensor([[3, 9, 1, 14], [7, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    return (kc.to(dtype=TINY.dtype, device=dev), vc.to(dtype=TINY.dtype, device=dev),
            tables.to(dev))


def _tiny_decode_buffered(cpu_params, dev):
    """One chunked-decode step at TINY with own-token attention through K4
    partials; one slot empty and the trash-like row negative."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_decode_buffered

    rng = np.random.default_rng(6)
    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    kc, vc, tables = _tiny_paged_inputs(dev, rng)
    Sp, plen, n_steps = 64, 50, 4
    own = torch.tensor([40, 0, -50], dtype=torch.int32, device=dev)
    tail = torch.tensor([1, 0, 2], dtype=torch.int32, device=dev)
    pos = (plen + own.clamp(min=0) + tail).to(torch.int32)

    def kvs(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dtype=TINY.dtype, device=dev)

    logits, _, _ = forward_decode_buffered(
        _on(cpu_params, dev), TINY, torch.tensor([65, 66, 67], device=dev), pos,
        kc, vc, own, kvs(L, 3, n_steps, kv, hd), kvs(L, 3, n_steps, kv, hd), tail,
        kvs(L, Sp, kv, hd), kvs(L, Sp, kv, hd),
        torch.tensor(plen, dtype=torch.int32, device=dev),
        page_tables=tables, own_impl="pallas",
    )
    return logits


def _tiny_decode(cpu_params, dev):
    """One manual-page decode step at TINY through K4 normalized; the third
    slot is inactive."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_decode

    rng = np.random.default_rng(7)
    kc, vc, tables = _tiny_paged_inputs(dev, rng)
    logits, _, _ = forward_decode(
        _on(cpu_params, dev), TINY, torch.tensor([70, 71, 72], device=dev),
        torch.tensor([40, 17, 3], dtype=torch.int32, device=dev), kc, vc, tables,
        torch.tensor([True, True, False], device=dev), paged_attn="pallas",
    )
    return logits


# ----------------------------------------------------------- decision phase
def build_backend():
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

    t0 = time.perf_counter()
    # greedy (the modes are held token for token), batches as waves, and
    # 64 pages a slot: the geometry earlier runs measured
    backend = build_local_backend(
        "llama-3.1-8b-instruct", device="cuda", seed=0, request_timeout_s=600.0,
        temperature=0.0, packed_admission=False, max_pages_per_seq=64,
    )
    # the smoke's 8B phases share this engine through backends of their
    # own, so closing one must not release it: main frees it at the end
    backend.owns_engine = False
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"decision: 8B backend built in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    return backend, build_s


MODES = (("graphs", True), ("eager", False))  # InferenceEngine(graphs=...)
NO_PREWARM_S = 3600.0  # an eager backend's idle grace: longer than the smoke


def _serve(backend, nodes, pods, n_singles, prewarm: bool, census: bool = True) -> dict:
    """The decision drive: n_singles single decisions; then (with
    `prewarm`, once the backend's idle worker has captured the sibling wave
    geometries: engine.prewarm_wave_siblings, polled through
    wave_prewarm_backlog) the batch; then (with `census`) one more single
    decision under the profiler (launch_census; else census is None). Returns its times, the decisions [(pod, decision)],
    each wave's tokens, row count and cold flag (from harvest_wave), and
    the valid tokens of each block call by row bucket R."""
    eng = backend.engine
    waves: list[dict] = []
    harvest = eng.harvest_wave

    def recorded(handle):
        fins = harvest(handle)
        waves.append({"R": handle.geo_key[0], "cold": handle.cold_compile,
                      "tokens": [f.token_ids for f in fins]})
        return fins

    eng.harvest_wave = recorded
    eng.block_tokens.clear()
    out, singles = [], []
    try:
        for pod in pods[:n_singles]:
            t = time.perf_counter()
            out.append((pod, backend.get_scheduling_decision(pod, nodes)))
            singles.append((time.perf_counter() - t) * 1000.0)
        totals = {eng.max_slots // 2: list(eng.block_tokens)}
        eng.block_tokens.clear()
        t = time.perf_counter()
        while prewarm and eng.wave_prewarm_backlog():
            if time.perf_counter() - t > 600:
                raise RuntimeError("the sibling wave prewarm did not drain in 600 s")
            time.sleep(0.05)
        prewarm_s = time.perf_counter() - t
        n_single_waves = len(waves)
        t = time.perf_counter()
        batch = backend.get_scheduling_decisions_batch(pods, nodes)
        batch_ms = (time.perf_counter() - t) * 1000.0
        totals[eng.max_slots] = list(eng.block_tokens)
        batch_cold = [w["cold"] for w in waves[n_single_waves:]]
        if census:
            calls0 = eng.stats["wave_model_calls"]
            census = launch_census(lambda: backend.get_scheduling_decision(pods[0], nodes))
            census["model_calls"] = eng.stats["wave_model_calls"] - calls0
        else:
            census = None
    finally:
        del eng.harvest_wave
    for pod, d in zip(pods, batch):
        if isinstance(d, Exception):
            raise d
        out.append((pod, d))
    return {"single_decision_ms": singles, "prewarm_wait_s": prewarm_s,
            "batch_of_8_ms": batch_ms, "batch_cold_compile": batch_cold,
            "decisions": out, "waves": waves, "totals": totals, "census": census}


def _graph_books(engine) -> dict:
    """The engine's CUDA-graph books: captures, replays, capture seconds by
    program (summed over its geometries)."""
    runner = engine._graphs
    return {"captures": runner.captures, "replays": runner.replays,
            "capture_s": dict(runner.capture_s)}


def _memory(start: int) -> dict:
    import torch

    return {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_above_start_gib": (torch.cuda.max_memory_allocated() - start) / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def _drive_modes(make_backend, nodes, pods, profiled=False, after_graphs=None) -> dict:
    """_serve in graph mode, then eagerly (graphs=False), each on a backend
    from make_backend(graphs) that is closed after it; every launch count
    is zeroed just before a mode's drive and read just after it. An eager
    backend has nothing to capture: it is built with an idle grace that
    never passes, so no prewarm dummy wave runs in its drive. With
    `profiled`, graph mode's backend then runs profiler_cost. With
    `after_graphs`, graph mode's engine is handed to it once its backend
    is closed (and before the eager mode), its result in recs["after"]."""
    import torch

    recs = {}
    for mode, graphs in MODES:
        backend = make_backend(graphs)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            with launches_by_step(backend.engine) as steps:
                _zero_launch_counts()
                t0 = time.perf_counter()
                served = _serve(backend, nodes, pods,
                                N_SINGLES if graphs else N_EAGER_SINGLES, prewarm=graphs,
                                census=graphs)
                main_s = time.perf_counter() - t0
                launches = _launch_counts()
            stats = backend.get_stats()
            recs[mode] = {**served, "main_s": main_s, "launches": launches,
                          "steps": steps, "stats": stats,
                          **_graph_books(backend.engine), **_memory(start)}
            if graphs and profiled:
                recs[mode]["profiler"] = profiler_cost(backend, nodes, pods,
                                                       served["census"])
        finally:
            backend.close()
        if graphs and after_graphs is not None:
            recs["after"] = after_graphs(backend.engine)
        del backend
        gc.collect()  # an engine and its graphs hold each other
        torch.cuda.empty_cache()
    return recs


PROFILED_SINGLES = 2


def profiler_cost(backend, nodes, pods, census_off) -> dict:
    """The wave profiler's cost on warm bf16 singles in graph mode:
    PROFILED_SINGLES decisions without it and the same with an
    EngineProfiler attached, then pods[0] again with it under
    torch.profiler (launch_census), against `census_off`, pods[0]'s
    census without it. Host launch calls a model call and host waits on
    the device a decision must not change (the fences read perf_counter
    and query events); ok says whether they did not."""
    from k8s_llm_scheduler_tpu_torch.observability.profiler import EngineProfiler

    eng = backend.engine

    def singles():
        ms, syncs0 = [], eng.stats["syncs"]
        for pod in pods[:PROFILED_SINGLES]:
            t = time.perf_counter()
            backend.get_scheduling_decision(pod, nodes)
            ms.append((time.perf_counter() - t) * 1000.0)
        return ms, eng.stats["syncs"] - syncs0

    off_ms, off_syncs = singles()
    prof = EngineProfiler(cfg=eng.cfg)
    eng.attach_profiler(prof)
    try:
        on_ms, on_syncs = singles()
        calls0 = eng.stats["wave_model_calls"]
        census_on = launch_census(lambda: backend.get_scheduling_decision(pods[0], nodes))
        census_on["model_calls"] = eng.stats["wave_model_calls"] - calls0
        snap = prof.snapshot()
    finally:
        eng.attach_profiler(None)

    def launches_a_call(c):
        return c["host_launches"] / max(c["model_calls"], 1)

    rec = {
        "singles_ms_without": off_ms, "singles_ms_with": on_ms,
        "cost_ms_per_decision": (sum(on_ms) - sum(off_ms)) / PROFILED_SINGLES,
        "engine_syncs_without": off_syncs, "engine_syncs_with": on_syncs,
        "host_launches_per_model_call_without": launches_a_call(census_off),
        "host_launches_per_model_call_with": launches_a_call(census_on),
        "host_syncs_without": census_off["host_syncs"],
        "host_syncs_with": census_on["host_syncs"],
        "model_calls_without": census_off["model_calls"],
        "model_calls_with": census_on["model_calls"],
        "waves_profiled": snap["waves_profiled"],
    }
    rec["ok"] = (off_syncs == on_syncs
                 and census_on["model_calls"] == census_off["model_calls"]
                 and census_on["host_launches"] == census_off["host_launches"]
                 and census_on["host_syncs"] == census_off["host_syncs"]
                 and snap["waves_profiled"] == PROFILED_SINGLES + 1)
    print(f"decision: wave profiler cost {rec['cost_ms_per_decision']:.3f} ms a decision "
          f"(singles {[round(x, 1) for x in off_ms]} ms without, "
          f"{[round(x, 1) for x in on_ms]} ms with); host launch calls a model call "
          f"{rec['host_launches_per_model_call_without']:.4f} without, "
          f"{rec['host_launches_per_model_call_with']:.4f} with; host syncs a decision "
          f"{rec['host_syncs_without']} / {rec['host_syncs_with']}; engine syncs "
          f"{off_syncs} / {on_syncs} | {_smi()} | ok={rec['ok']}", flush=True)
    return rec


def _mode_summary(rec, decisions) -> dict:
    """One mode's printed record."""
    stats, census = rec["stats"], rec["census"]
    n = len(decisions)
    return {
        "decisions": n,
        "launches": rec["launches"],
        "launches_per_decision": {k: v / n for k, v in rec["launches"].items()},
        "single_decision_ms": rec["single_decision_ms"],
        "batch_of_8_ms": rec["batch_of_8_ms"],
        "decisions_per_s_batch": 8 / (rec["batch_of_8_ms"] / 1000.0),
        "batch_cold_compile": rec["batch_cold_compile"],
        "prewarm_wait_s": rec["prewarm_wait_s"],
        "prefix_prefill_ms": stats["prefix_prefill_ms"],
        "prefix_tokens_prefilled": stats["prefill_tokens"],
        "wave_ms_total": stats["wave_ms"],
        "waves": stats["waves"],
        "wave_model_calls": stats["wave_model_calls"],
        "wave_block_calls": stats["wave_block_calls"],
        "wave_prewarms": stats["wave_prewarms"],
        "wave_prewarm_failures": stats["wave_prewarm_failures"],
        "captures": rec["captures"], "replays": rec["replays"],
        "capture_s": rec["capture_s"],
        "kernel_launches_per_run": per_call(rec["steps"]),
        "steps": rec["steps"],
        "census_decision": census,
        "host_launches_per_model_call": (
            census["host_launches"] / max(census["model_calls"], 1) if census else None),
        "device_ops_per_model_call": (
            census["device_ops"] / max(census["model_calls"], 1) if census else None),
        "peak_gib": rec["peak_gib"], "peak_above_start_gib": rec["peak_above_start_gib"],
        "peak_reserved_gib": rec["peak_reserved_gib"],
    }


def _modes_agree(recs, what: str) -> bool:
    """Graph mode against eager: identical greedy tokens wave for wave and
    row for row (graph mode's singles past eager's N_EAGER_SINGLES and its
    census single have no eager counterpart), equal kernel launches per
    device run of every step eager mode ran,
    the batch of 8 warm in graph mode, and no kernel launched outside a
    graph in graph mode's profiled decision."""
    g, e = recs["graphs"], recs["eager"]
    g_waves = g["waves"][:N_EAGER_SINGLES] + g["waves"][N_SINGLES:-1]
    same = [w["tokens"] for w in g_waves] == [w["tokens"] for w in e["waves"]]
    # eager mode runs only the batch's steps; each must match graph mode's
    g_calls = per_call(g["steps"])
    calls = all(g_calls.get(step) == c for step, c in per_call(e["steps"]).items())
    warm = g["batch_cold_compile"] == [False]
    # the profiler saw the runtime's calls (a graph launch a model call at
    # least) and no kernel launch among them
    no_eager = (g["census"]["host_kernel_launches"] == 0
                and g["census"]["graph_launches"] >= g["census"]["model_calls"])
    print(f"{what}: graphs vs eager tokens identical={same} ({len(e['waves'])} waves), "
          f"launches per run equal={calls}, batch warm={warm}, "
          f"graph-mode decision launched no kernel outside a graph={no_eager}", flush=True)
    return same and calls and warm and no_eager


def decision_phase(backend, build_s, nodes, pods) -> tuple[bool, dict]:
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg

    def make(graphs):
        if graphs:
            return backend  # built before phase 2, graphs on by default
        return LocalLLMBackend(
            InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, rng_seed=0,
                            graphs=False),
            request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)

    recs = _drive_modes(make, nodes, pods, profiled=True)
    ok = _modes_agree(recs, "decision")
    rec = {"model": "llama-3.1-8b-instruct", "nodes": len(nodes), "backend_build_s": build_s}
    for mode, _ in MODES:
        r = recs[mode]
        ok = ok and _feasible(nodes, r["decisions"])
        rec[mode] = _mode_summary(r, r["decisions"])
        print(f"decision [{mode}]: " + json.dumps(rec[mode]), flush=True)
    g = recs["graphs"]
    # the main path's counts: graph mode; measured by step, every K1 launch
    # of the run falls in one of them
    rec["launches"] = g["launches"]
    rec["k1_launches_by_step"] = {step: r["K1"] for step, r in g["steps"].items()}
    rec["k1_per_call_by_step"] = _tp_per_call(g["steps"])
    # the batch of 8's wave, row by row (the admission phase packs it)
    rec["batch_tokens"] = g["waves"][N_SINGLES]["tokens"]
    ok = (ok and g["launches"]["K1"] > 0 and g["launches"]["K2"] > 0
          and sum(rec["k1_launches_by_step"].values()) == g["launches"]["K1"])
    rec["profiler"] = g["profiler"]
    ok = ok and rec["profiler"]["ok"]
    rec["gil"] = gil_probe()
    o_ok, rec["two_waves"] = two_wave_overlap(backend, nodes, pods)
    return ok and o_ok and rec["gil"]["released"], rec


OVERLAP_LIMIT = 1.25  # the first of two back-to-back waves, against a lone one


def two_wave_overlap(backend, nodes, pods) -> tuple[bool, dict]:
    """The wave dispatcher on the card, on the graph-mode engine (greedy):
    a lone warm R=8 wave of the pods' suffixes (A) is timed, and so is
    another of them reversed (B); then A and B are submitted back to back
    and harvested in turn. harvest_wave of A must return within
    OVERLAP_LIMIT x the lone A's time, counted from A's submit, and both
    waves' tokens must equal those of the same waves run alone."""
    eng = backend.engine
    items = [backend._prepare_item(pod, nodes) for pod in pods[: eng.max_slots]]
    backend._switch_group(items[0])  # the decision phase's prefix and grammar
    a = [i.suffix_ids for i in items]
    b = a[::-1]
    new = backend.max_new_tokens

    def alone(prompts):
        t0 = time.perf_counter()
        fins = eng.decide_wave(prompts, new)
        return time.perf_counter() - t0, [f.token_ids for f in fins]

    alone(a)  # warm
    lone_a, toks_a = alone(a)
    lone_b, toks_b = alone(b)
    t0 = time.perf_counter()
    ha = eng.submit_wave(a, new)
    submit_a = time.perf_counter() - t0
    hb = eng.submit_wave(b, new)
    submit_b = time.perf_counter() - t0
    fa = eng.harvest_wave(ha)
    first = time.perf_counter() - t0
    fb = eng.harvest_wave(hb)
    second = time.perf_counter() - t0
    same = [f.token_ids for f in fa] == toks_a and [f.token_ids for f in fb] == toks_b
    ratio = first / lone_a
    rec = {"lone_a_s": lone_a, "lone_b_s": lone_b, "submit_a_s": submit_a,
           "submit_b_s": submit_b, "harvest_a_s": first, "harvest_b_s": second,
           "ratio": ratio, "tokens_equal": same, "cold": [ha.cold_compile, hb.cold_compile],
           "model_calls": [ha.iters, hb.iters]}
    ok = ratio <= OVERLAP_LIMIT and same and not (ha.cold_compile or hb.cold_compile)
    print(f"decision, two waves back to back: lone A {lone_a:.3f} s, lone B {lone_b:.3f} s; "
          f"submits returned at {submit_a * 1e3:.2f} / {submit_b * 1e3:.2f} ms, harvest A at "
          f"{first:.3f} s ({ratio:.3f}x the lone A; limit {OVERLAP_LIMIT}x), B at "
          f"{second:.3f} s; tokens equal to the lone waves'={same} | {_smi()} | ok={ok}",
          flush=True)
    return ok, rec


def gil_probe() -> dict:
    """Whether a thread waiting on a CUDA event (the wave dispatcher's
    fences, harvest_wave) lets other Python threads run: the main thread
    counts loop turns for 0.2 s alone, then for 0.2 s while another
    thread waits on an event behind ~1 s of device sleep."""
    import torch

    def spin(seconds):
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            n += 1
        return n

    alone = spin(0.2)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of cycles
    ev = torch.cuda.Event()
    ev.record()
    waiter = threading.Thread(target=ev.synchronize)
    waiter.start()
    time.sleep(0.02)
    during = spin(0.2)
    still_waiting = waiter.is_alive()
    waiter.join()
    rec = {"spin_alone": alone, "spin_while_waiting": during,
           "waiter_was_waiting": still_waiting,
           "released": still_waiting and during > 0.5 * alone}
    print(f"decision: a thread in Event.synchronize releases the GIL={rec['released']} "
          f"({during} loop turns beside it against {alone} alone)", flush=True)
    return rec


# ---------------------------------------------------------- admission phase
TINY_CHUNK = 16  # the TINY pack's chunk width: its prompts span chunks
TINY_NEW_TOKENS = 24


def _default_config():
    """The port's config at its defaults (the JAX package's): no file, no
    env."""
    import copy

    from k8s_llm_scheduler_tpu_torch.config import DEFAULTS, Config

    return Config(copy.deepcopy(DEFAULTS))


ADMISSION_KEYS = ("packed_admission", "admission_chunk_tokens", "delta_prompts",
                  "repin_fraction", "max_pins")


def _admission_backend(engine):
    """A LocalLLMBackend over `engine` with the config's default admission
    plane (packed batches, delta prompts, 4 pins), as `cli run` and `cli
    demo` map it (cli._backend_kwargs); the chunk width is the engine's,
    checked against the config's."""
    from k8s_llm_scheduler_tpu_torch.cli import _backend_kwargs
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    kw = {k: v for k, v in _backend_kwargs(_default_config()).items() if k in ADMISSION_KEYS}
    if engine.admission_chunk_tokens != kw.pop("admission_chunk_tokens"):
        raise RuntimeError("the engine's admission chunk is not the config's")
    return LocalLLMBackend(engine, request_timeout_s=600.0, **kw)


@contextlib.contextmanager
def _recording_paged(engine):
    """Records each admit_packed call (its request ids and wall ms), the
    Finished records and count of step() calls, and the device ms of each
    pack chunk and each decode chunk (CUDA events around their launches:
    the device's time from the first to the last, idle gaps included), on
    `engine`."""
    import torch

    rec = {"packs": [], "fins": {}, "steps": 0, "events": {"pack chunk": [],
                                                          "decode chunk": []}}
    admit, step = engine.admit_packed, engine.step

    def timed(name, fn):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec["events"][name].append((start, end))
            return out
        return call

    engine._pack_chunk = timed("pack chunk", engine._pack_chunk)
    engine._chunk_dispatch = timed("decode chunk", engine._chunk_dispatch)

    def admit_packed(prompts, max_new_tokens=200, piggyback_decode=True):
        t = time.perf_counter()
        ids = admit(prompts, max_new_tokens, piggyback_decode)
        rec["packs"].append((ids, (time.perf_counter() - t) * 1000.0))
        return ids

    def recorded_step(chunks=1):
        fins = step(chunks)
        rec["steps"] += 1
        rec["fins"].update((f.req_id, f.token_ids) for f in fins)
        return fins

    engine.admit_packed, engine.step = admit_packed, recorded_step
    try:
        yield rec
    finally:
        del engine.admit_packed, engine.step, engine._pack_chunk, engine._chunk_dispatch
        torch.cuda.synchronize()
        rec["ms"] = {name: [a.elapsed_time(b) for a, b in evs]
                     for name, evs in rec.pop("events").items()}


def _pinned_gib(engine) -> float:
    return sum(p.k.numel() * p.k.element_size() * 2
               for key, p in engine._prefix_cache.items()
               if key in engine._pinned_prefix_keys) / 2**30


def _packed_batch(engine, nodes, pods, wave_tokens) -> tuple[bool, dict]:
    """(a) The batch of 8 through get_scheduling_decisions_batch of a
    backend with the config's default admission plane on the decision phase's
    graph-mode engine: one packed admission of the 8 suffixes in chunks of
    256 (K1 in each chunk's prefix part), decode chunks piggybacked between
    them, then step() until every decision is done. Counts zeroed just
    before the call and read just after it."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
    from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

    pe = PromptEngine()
    suffix_tokens = sum(len(engine.tokenizer.chat_prompt_parts(
        pe.system_prompt, pe.cluster_part(nodes), pod_suffix(pod))[1]) for pod in pods)
    C = engine.admission_chunk_tokens
    backend = _admission_backend(engine)
    before = dict(engine.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _recording_paged(engine) as paged, launches_by_step(engine) as steps:
            _zero_launch_counts()
            t0 = time.perf_counter()
            batch = backend.get_scheduling_decisions_batch(pods, nodes)
            wall_ms = (time.perf_counter() - t0) * 1000.0
            launches = _launch_counts()
    finally:
        backend.close()
    d = {k: engine.stats[k] - before[k] for k in (
        "packed_admissions", "packed_prompts", "pack_chunks", "piggyback_chunks",
        "chunks", "syncs", "prefix_prefills", "waves")}
    errors = [repr(x) for x in batch if isinstance(x, Exception)]
    ids, admit_ms = paged["packs"][0] if paged["packs"] else ([], None)
    tokens = [paged["fins"].get(i) for i in ids]
    same = sum(t == w for t, w in zip(tokens, wave_tokens))
    # where each stream first leaves the wave's, and the node each names
    first_diff = [next((i for i, (x, y) in enumerate(zip(t or [], w)) if x != y), None)
                  for t, w in zip(tokens, wave_tokens)]

    def node(ids_):
        parsed = parse_decision_json(engine.tokenizer.decode(ids_ or []))
        return parsed and parsed["selected_node"]

    same_node = sum(node(t) == node(w) for t, w in zip(tokens, wave_tokens))
    ms = paged["ms"]
    pack = steps.get("pack chunk", {"runs": 0, "K1": 0})
    rec = {
        "wall_ms": wall_ms, "admit_packed_ms": admit_ms, "suffix_tokens": suffix_tokens,
        "chunk_tokens": C, **d, "decode_steps": d["chunks"] * engine.chunk_steps,
        "step_calls": paged["steps"], "launches": launches,
        "pack_chunk_runs": pack["runs"], "pack_chunk_k1": pack["K1"],
        "tokens_a_decision": [len(t) if t else None for t in tokens],
        "same_tokens_as_the_wave": same, "first_token_unlike_the_wave": first_diff,
        "same_node_as_the_wave": same_node,
        "pack_chunk_ms": ms["pack chunk"], "decode_chunk_ms": ms["decode chunk"],
        "pinned_gib": _pinned_gib(engine),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "errors": errors,
    }
    n_chunks = -(-suffix_tokens // C)
    ok = (not errors and len(ids) == 8 and None not in tokens
          and _feasible(nodes, list(zip(pods, batch)))
          and d["packed_admissions"] == 1 and d["packed_prompts"] == 8
          and d["pack_chunks"] == pack["runs"] == n_chunks and d["waves"] == 0
          and pack["K1"] == n_chunks * engine.cfg.n_layers == launches["K1"])
    print(f"admission (a): packed batch of 8: {json.dumps(rec)}", flush=True)
    print(f"admission (a): {suffix_tokens} suffix tokens in {d['pack_chunks']} chunks of {C} "
          f"(K1 {pack['K1']} launches in them), {d['piggyback_chunks']} decode chunks "
          f"piggybacked, {rec['decode_steps']} decode steps in {d['chunks']} chunks, "
          f"{paged['steps']} step() calls; batch wall {wall_ms:.1f} ms (admit_packed "
          f"{admit_ms and round(admit_ms, 1)} ms; pack chunks {sum(ms['pack chunk']):.1f} ms "
          f"and decode chunks {sum(ms['decode chunk']):.1f} ms of device time); {same} of 8 "
          f"token streams equal the wave's (first unlike at {first_diff}), {same_node} name "
          f"the same node; pinned {rec['pinned_gib']:.2f} GiB, peak {rec['peak_gib']:.2f} GiB | "
          f"{_smi()} | ok={ok}", flush=True)
    return ok, rec


def _drain_paged(eng, ids):
    out = {}
    while not set(ids) <= out.keys():
        out.update((f.req_id, f.token_ids) for f in eng.step())
    return [out[i] for i in ids]


def _packed_tiny() -> tuple[bool, dict]:
    """(b) At TINY on the card, three prompts of the decision path (one
    shorter than a 16-token chunk, one spanning 14 chunks, one between),
    under the decision grammar and unconstrained: admit_packed with decode
    chunks piggybacked (graphs) must be token-identical to admit_packed
    with none (the slot state the eager pack chunks write in place is what
    the chunk graph's replays read) and to each prompt's serial generate(),
    and one pack chunk's end logits on the card within 5e-2 of the largest
    logit of its plain version on the CPU. In bf16: the kernels take bf16
    operands, so f32 runs only on the CPU, where the tests hold the same
    identity (tests/test_torch_admission.py). These inputs are fixed, so
    the result is too; in bf16 the packed and serial reductions round
    apart, so other inputs may flip a near-tie."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
    from k8s_llm_scheduler_tpu_torch.engine.admission.packer import pack_prompts
    from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_packed, init_params
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    tok, pe = ByteTokenizer(), PromptEngine()
    nodes = synthetic_nodes(4)
    parts = [tok.chat_prompt_parts(pe.system_prompt, pe.cluster_part(nodes), pod_suffix(p))
             for p in fixture_pods(3)]
    prompts = [parts[0][1][:12], parts[1][1], parts[2][1][:40]]
    cpu_params = init_params(TINY, seed=1, device="cpu")
    eng = InferenceEngine(_on(cpu_params, "cuda"), TINY, tok, temperature=0.0,
                          prefix_chunk=512, admission_chunk_tokens=TINY_CHUNK)
    eng.set_prefix(parts[0][0])
    dfa = build_decision_dfa(tok, [n.name for n in nodes], max_reason_tokens=16)
    rec, ok = {"prompt_lens": [len(p) for p in prompts]}, True
    for mode, grammar in (("grammar", dfa), ("free", None)):
        eng.set_grammar(grammar)
        serial = [eng.generate(p, max_new_tokens=TINY_NEW_TOKENS).token_ids for p in prompts]
        runs = {}
        for name, piggyback in (("piggybacked", True), ("not piggybacked", False)):
            before = dict(eng.stats)
            with launches_by_step(eng) as steps:
                _zero_launch_counts()
                ids = eng.admit_packed(prompts, TINY_NEW_TOKENS, piggyback_decode=piggyback)
                tokens = _drain_paged(eng, ids)
            runs[name] = {
                "tokens": tokens,
                "pack_chunks": eng.stats["pack_chunks"] - before["pack_chunks"],
                "piggyback_chunks": eng.stats["piggyback_chunks"] - before["piggyback_chunks"],
                "pack_chunk_k1": steps["pack chunk"]["K1"],
            }
        p, q = runs["piggybacked"], runs["not piggybacked"]
        n_chunks = -(-sum(map(len, prompts)) // TINY_CHUNK)
        good = (p["tokens"] == q["tokens"] and p["piggyback_chunks"] > 0
                and q["piggyback_chunks"] == 0
                and p["pack_chunks"] == q["pack_chunks"] == n_chunks
                and p["pack_chunk_k1"] == q["pack_chunk_k1"] == n_chunks * TINY.n_layers
                and all(1 <= len(t) <= TINY_NEW_TOKENS for t in p["tokens"])
                and p["tokens"] == serial)
        same_serial = [t == s for t, s in zip(p["tokens"], serial)]
        rec[mode] = {**{k: v for k, v in p.items() if k != "tokens"},
                     "identical_without_piggyback": p["tokens"] == q["tokens"],
                     "same_as_serial_generate": same_serial, "ok": good}
        ok = ok and good
        print(f"admission (b): TINY {mode}: piggybacked == not piggybacked "
              f"{p['tokens'] == q['tokens']} ({p['piggyback_chunks']} chunks piggybacked, "
              f"{p['pack_chunks']} pack chunks, K1 {p['pack_chunk_k1']}); same as serial "
              f"generate {same_serial} ok={good}", flush=True)
    # the first pack chunk's end logits, card against the CPU's plain twins
    chunk = pack_prompts(prompts, TINY_CHUNK, tok.pad_id).chunks[0]
    ends = torch.tensor([e.index for e in chunk.ends] or [0])
    logits = {}
    for dev, params in (("cuda", eng.params), ("cpu", cpu_params)):
        pk, pv = eng._prefix.k.to(dev), eng._prefix.v.to(dev)
        L, _, n_kv, hd = pk.shape
        carry = torch.zeros((L, TINY_CHUNK, n_kv, hd), dtype=pk.dtype, device=dev)
        cache = torch.zeros((L, 2, TINY_CHUNK, n_kv, hd), dtype=pk.dtype, device=dev)
        logits[dev] = forward_prefill_packed(
            params, TINY, torch.from_numpy(chunk.tokens).to(dev),
            torch.from_numpy(chunk.seg).to(dev),
            torch.from_numpy(chunk.positions).to(dev) + eng.prefix_len,
            pk, pv, torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev),
            carry, carry.clone(), torch.full((TINY_CHUNK,), -1, dtype=torch.int32, device=dev),
            0, cache, cache.clone(), torch.ones(TINY_CHUNK, dtype=torch.int32, device=dev),
            torch.arange(TINY_CHUNK, dtype=torch.int32, device=dev), ends.to(dev),
        ).float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    good = bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
    rec["pack_chunk_logits"] = {"max_abs_err": err, "max_logit": scale, "ok": good}
    print(f"admission (b): TINY pack chunk end logits, cuda vs cpu err={err:.4g} "
          f"(max |logit| {scale:.4g}) ok={good}", flush=True)
    ok = ok and good and eng.kv.pages_free == eng.kv.num_pages - 1
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rec


def admission_phase(engine, nodes, pods, wave_tokens) -> tuple[bool, dict]:
    a_ok, a = _packed_batch(engine, nodes, pods, wave_tokens)
    b_ok, b = _packed_tiny()
    return a_ok and b_ok, {"packed_batch": a, "tiny": b}


# --------------------------------------------------------------- loop phase
LOOP_NODES = 32  # the decision phase's cluster: the same 5,488-token prefix
LOOP_PODS = 32
LOOP_SHAPES = 8
LOOP_SECOND_PODS = 8  # the second burst: one pod a shape
LOOP_DEADLINE_S = 300.0


def _loop_burst(engine, backend, cluster, pods, bound_total):
    """One burst through a new `cli.build_stack` over `backend`: the pods,
    already added, until `bound_total` binds in all (deadline
    LOOP_DEADLINE_S). Returns its record (launches as the difference of the
    counts read before and after) and whether it passed."""
    import asyncio

    from k8s_llm_scheduler_tpu_torch.cli import build_stack, run_until_bound
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    nodes = cluster.get_node_metrics()  # the snapshot the burst is decided on
    scheduler, _ = build_stack(_default_config(), cluster, backend=backend)
    bound_at: dict[str, float] = {}
    bind = cluster.bind_pod_to_node

    def timed_bind(name, namespace, node):
        ok = bind(name, namespace, node)
        bound_at.setdefault(name, time.perf_counter())
        return ok

    cluster.bind_pod_to_node = timed_bind
    waves: list[dict] = []
    harvest = engine.harvest_wave

    def recorded(handle):
        fins = harvest(handle)
        waves.append({"rows": handle.n, "R": handle.geo_key[0],
                      "cold": handle.cold_compile})
        return fins

    # each decision's prompt: the pinned snapshot's prefix, or that plus a
    # STATE UPDATES diff; and the pin it names
    items: list = []
    prepare = backend._prepare_item

    def prepare_item(pod, nodes, cluster_info=None):
        item = prepare(pod, nodes, cluster_info)
        items.append(item)
        return item

    engine.harvest_wave = recorded
    backend._prepare_item = prepare_item
    before, counters0, launches0 = dict(engine.stats), dict(backend.counters), _launch_counts()
    try:
        t0 = time.perf_counter()
        all_bound = asyncio.run(run_until_bound(scheduler, cluster, bound_total,
                                                LOOP_DEADLINE_S))
        run_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    finally:
        del engine.harvest_wave, backend._prepare_item, cluster.bind_pod_to_node
    stats = scheduler.get_stats()
    client = stats["client"]
    counters = {k: v - counters0[k] for k, v in backend.counters.items()}
    eng = {k: engine.stats[k] - before[k] for k in (
        "prefix_prefills", "prefix_hits", "waves", "wave_model_calls", "wave_prewarms")}
    by_name = {n.name: n for n in nodes}
    placed = {p.name: cluster.get_pod(p.namespace, p.name).node_name for p in pods}
    feasible = all(
        placed[p.name] is not None and by_name[placed[p.name]].is_ready
        and placed[p.name] in {n.name for n in feasible_nodes(raw_pod_to_spec(p), nodes)}
        for p in pods)
    # every backend call that raised was retried, or failed the decision
    calls = counters["async_calls"] + counters["sync_calls"]
    errors = calls - client["successful_requests"] - client["invalid_decisions"]
    retries = errors - client["failed_requests"]
    bound = sorted(t - t0 for t in bound_at.values())
    rec = {
        "nodes": len(nodes), "pods": len(pods), "all_bound": all_bound, "feasible": feasible,
        "llm_decisions": stats["llm_decisions"],
        "cache_decisions": stats["cache_decisions"],
        "client_cached": client["cached_requests"],
        "client_coalesced": client["coalesced_requests"],
        "fallback_decisions": client["fallback_decisions"] + stats["fallback_decisions"],
        "retries": retries, "failed_requests": client["failed_requests"],
        "backend_errors": errors,
        "breaker": client["circuit_breaker"]["state"],
        "async_calls": counters["async_calls"], "sync_calls": counters["sync_calls"],
        "waves": len(waves), "rows_per_wave": [w["rows"] for w in waves],
        "wave_R": [w["R"] for w in waves], "cold_waves": sum(w["cold"] for w in waves),
        "group_installs": counters["group_installs"],
        "prewarms_installed": counters["prewarms_installed"],
        "prewarms_dropped": counters["prewarms_dropped"],
        "engine": eng,
        "encodings": sorted({"pinned" if list(i.prefix_ids) == list(i.pin_spec[1])
                             else "delta" for i in items}),
        "pin_keys": sorted({i.pin_spec[0] for i in items}),
        "first_bound_s": bound[0] if bound else None,
        "last_bound_s": bound[-1] if bound else None,
        "run_s": run_s, "launches": launches,
        "phases_ms": {k: v["avg_ms"] for k, v in stats["phases"].items()},
    }
    ok = (all_bound and feasible and rec["fallback_decisions"] == 0 and retries == 0
          and rec["failed_requests"] == 0 and rec["backend_errors"] == 0
          and rec["breaker"] == "closed" and counters["sync_calls"] == 0
          and counters["async_calls"] == stats["llm_decisions"] > 0
          and launches["K1"] > 0 and launches["K2"] > 0)
    return ok, rec, {tuple(i.prefix_ids) for i in items}, nodes


@contextlib.contextmanager
def _recording_prefixes(engine):
    """Records every prefix install of the engine (set_prefix and
    pin_prefix, on the worker thread, one at a time): its token ids, the
    tokens it prefilled and reused, its wall ms (ending in a sync) and the
    K1/K2 launches it made."""
    import torch

    recs: list[dict] = []
    inner = engine._set_prefix_inner

    def recorded(prompt_ids, activate=True):
        before, launches0 = dict(engine.stats), _launch_counts()
        t = time.perf_counter()
        inner(prompt_ids, activate)
        torch.cuda.synchronize()
        launches = _launch_counts()
        recs.append({
            "ids": tuple(prompt_ids), "ms": (time.perf_counter() - t) * 1000.0,
            **{k: engine.stats[k] - before[k] for k in (
                "prefix_prefills", "prefix_hits", "prefill_tokens", "prefix_reused_tokens")},
            **{k: launches[k] - launches0[k] for k in ("K1", "K2")},
        })

    engine._set_prefix_inner = recorded
    try:
        yield recs
    finally:
        del engine._set_prefix_inner


def loop_phase(engine):
    """The scheduler's main path through the user's entry points: a
    FakeCluster holding a burst of pending pods (all added before the loop
    starts, so one snapshot serves the burst's leaders), the stack of
    `cli.build_stack` at the reference config's defaults with the backend
    of `cli demo` (the config's default admission plane: delta prompts over
    pinned prefixes), and Scheduler.run() until every pod is bound, over a
    new LocalLLMBackend on the decision phase's graph-mode engine (no
    second copy of the weights). Then a second burst of one pod a shape on
    the same cluster, after the first's binds, through a new stack over the
    same backend. Every launch count is zeroed just before the first burst
    and read after each. Fails unless in both bursts every pod is bound to
    a ready node that is feasible for it, the client made no fallback
    decision, no retry and met no backend error, the breaker is closed,
    every LLM decision came through get_scheduling_decision_async (none
    through a to_thread thread), and K1 and K2 launched; and unless the
    first burst's prompts are the pinned snapshot and the second's a delta
    over the same pin, which is still held, and the prefill of the second
    burst's prefix (when the decisions' group install or the scheduler's
    idle prefix prewarm ran it) computed fewer tokens than the prefix,
    seeded from the pin, K1 and K2 launching in it."""
    from k8s_llm_scheduler_tpu_torch.core.prompt import render_node_block
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    cluster = synthetic_cluster(LOOP_NODES)
    pods = pod_burst(LOOP_PODS, distinct_shapes=LOOP_SHAPES)
    for pod in pods:
        cluster.add_pod(pod)
    backend = _admission_backend(engine)
    try:
        with _recording_prefixes(engine) as installs:
            _zero_launch_counts()
            ok1, rec, _, _ = _loop_burst(engine, backend, cluster, pods, LOOP_PODS)
            second = [dataclasses.replace(p, name=f"second-{p.name}") for p in
                      pod_burst(LOOP_SECOND_PODS, distinct_shapes=LOOP_SHAPES)]
            for pod in second:
                cluster.add_pod(pod)
            ok2, rec2, prefixes, nodes2 = _loop_burst(
                engine, backend, cluster, second, LOOP_PODS + LOOP_SECOND_PODS)
        pin = backend._delta._pin
        pins = backend._pin_manager.stats()
        pin_held = set(backend._pin_manager.pins)
    finally:
        backend.close()
    # the prefill of the second burst's prefix, wherever it ran
    fill = next((r for r in installs if r["ids"] in prefixes and r["prefix_prefills"]), None)
    rec2["drifted_nodes"] = sum(render_node_block(n) != pin.blocks[n.name] for n in nodes2)
    rec2["prefix_install"] = fill and {k: v for k, v in fill.items() if k != "ids"}
    rec2["prefix_len"] = len(fill["ids"]) if fill else None
    rec["second_burst"] = rec2
    rec["pins"] = pins
    rec["prefix_installs"] = [{k: (len(v) if k == "ids" else v) for k, v in r.items()}
                              for r in installs]
    ok = (ok1 and ok2 and rec["encodings"] == ["pinned"] and rec2["encodings"] == ["delta"]
          and len(rec["pin_keys"]) == 1 and rec2["pin_keys"] == rec["pin_keys"]
          and rec["pin_keys"][0] in pin_held and fill is not None
          and 0 < fill["prefill_tokens"] < len(fill["ids"])
          and fill["prefix_reused_tokens"] > 0 and fill["K1"] > 0 and fill["K2"] > 0)
    print(f"loop: {json.dumps(rec)}", flush=True)
    print(f"loop: {rec['llm_decisions']} LLM decisions, {rec['client_cached']} cache or "
          f"single-flight hits ({rec['client_coalesced']} coalesced), {rec['waves']} waves "
          f"of {rec['rows_per_wave']} rows, {rec['group_installs']} group installs, prefix "
          f"prewarms {rec['prewarms_installed']} installed / {rec['prewarms_dropped']} dropped; "
          f"pending -> bound first {rec['first_bound_s']:.3f} s, last "
          f"{rec['last_bound_s']:.3f} s; burst wall {rec['run_s']:.3f} s; prompts "
          f"{rec['encodings']} | {_smi()} | ok={ok1}", flush=True)
    fill = fill or {"prefill_tokens": None, "prefix_reused_tokens": None, "ms": float("nan"),
                    "K1": None, "K2": None}
    print(f"loop, second burst: {rec2['pods']} pods, {rec2['llm_decisions']} LLM decisions "
          f"in {rec2['waves']} waves of {rec2['rows_per_wave']} rows; prompts "
          f"{rec2['encodings']} over {rec2['drifted_nodes']} drifted nodes; its prefix "
          f"prefill {fill['prefill_tokens']} of {rec2['prefix_len']} tokens "
          f"({fill['prefix_reused_tokens']} seeded from the pin) in {fill['ms']:.1f} ms, K1 "
          f"{fill['K1']} / K2 {fill['K2']} launches; pending -> bound last "
          f"{rec2['last_bound_s']:.3f} s, wall {rec2['run_s']:.3f} s; {pins['live_pins']} "
          f"pins live | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def _child_env(**extra) -> dict:
    """The environment of a child process of the smoke: the repository on
    its PYTHONPATH, since children run in a temporary directory (the
    repo root's config.yaml would be read there, and a machine without
    PyYAML refuses a config file it cannot read)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def start_demo(device="cuda"):
    """Start `python -m k8s_llm_scheduler_tpu_torch.cli demo --model tiny
    --fake-nodes 4` in a process of its own on the card, in a temporary
    directory (the config's defaults: temperature 0.3); finish_demo()
    collects it. Its model is TINY: it runs beside path A."""
    cwd = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "demo",
         "--model", "tiny", "--fake-nodes", "4", "--device", device],
        cwd=cwd.name, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return child, cwd, t0


def finish_demo(started):
    """The cli demo child: it must exit 0 with its three fixture pods bound
    and no fallback decision."""
    child, cwd, t0 = started
    try:
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        cwd.cleanup()
    out = subprocess.CompletedProcess(child.args, child.returncode, stdout, stderr)
    wall_s = time.perf_counter() - t0
    try:
        stats = json.loads(out.stdout)
    except ValueError:
        stats = {}
    rec = {"rc": out.returncode, "wall_s": wall_s,
           "binds": stats.get("total_scheduled"),
           "llm_decisions": stats.get("llm_decisions"),
           "fallbacks": stats.get("fallback_decisions")}
    ok = (out.returncode == 0 and rec["binds"] == 3 and rec["fallbacks"] == 0
          and stats["client"]["fallback_decisions"] == 0)
    print(f"cli demo: {json.dumps(rec)} ok={ok}", flush=True)
    if not ok:
        print(out.stderr[-4000:], file=sys.stderr, flush=True)
    return ok, rec


def _feasible(nodes, decisions) -> bool:
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    ok = True
    for pod, d in decisions:
        names = {n.name for n in feasible_nodes(pod, nodes)}
        good = d.selected_node in names and 0.0 <= d.confidence <= 1.0
        ok = ok and good
        print(f"  {pod.name}: {d.selected_node} conf={d.confidence} "
              f"reasoning_len={len(d.reasoning)} ok={good}", flush=True)
    return ok


PATH_A_LAYERS = 8  # path A's depth, of 32 (module doc, phase 5)


def path_a_phase(backend, nodes, pods):
    """int8 weights (seed 0's at PATH_A_LAYERS, quantized on the card) and
    ragged block-decode matmuls (K3) on the decision path, in both modes;
    K3 launches 7 a layer of every block-decode run in both."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.quant import param_bytes, quantize_params

    from k8s_llm_scheduler_tpu_torch.models.llama import init_params

    # seed 0's tree at PATH_A_LAYERS, drawn on the card: its own leaves (a
    # quantized tree shares its unquantized ones with the tree it came
    # from, and the swap below writes into them), and the tree the swap
    # back restores (a cut of the 32-layer draw is not: init_params draws
    # each stacked weight for every layer in turn)
    cfg = dataclasses.replace(backend.engine.cfg, n_layers=PATH_A_LAYERS)
    bf16 = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    params = quantize_params(bf16)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del bf16

    def make(graphs):
        engine = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0,
                                 decode_matmul="ragged", graphs=graphs)
        return LocalLLMBackend(engine, request_timeout_s=600.0,
                               prewarm_idle_delay_s=0.5 if graphs else NO_PREWARM_S)

    recs = _drive_modes(make, nodes, pods, after_graphs=lambda eng: swap_phase(
        eng, nodes, pods, _int8_staging(cfg), "int8 + ragged (K3)"))
    swap_ok, swap = recs.pop("after")
    ok = _modes_agree(recs, "path A") and swap_ok
    rec = {"model": "llama-3.1-8b-instruct int8 weight-only, decode_matmul=ragged",
           "layers": PATH_A_LAYERS,
           "quantize_s": quant_s, "int8_param_gib": param_bytes(params) / 2**30,
           "swap": swap}
    k3_per_block = 7 * cfg.n_layers
    for mode, _ in MODES:
        r = recs[mode]
        ok = ok and _feasible(nodes, r["decisions"])
        blocks = {step: c for step, c in per_call(r["steps"]).items()
                  if step.startswith("block decode")}
        ok = (ok and r["launches"]["K3"] > 0 and r["launches"]["K1"] > 0 and bool(blocks)
              and all(c["K3"] == k3_per_block for c in blocks.values()))
        rec[mode] = _mode_summary(r, r["decisions"])
        print(f"path A [{mode}]: " + json.dumps(rec[mode]), flush=True)
    g = recs["graphs"]
    rec["launches"] = g["launches"]
    rec["block_tokens"] = {str(r): t for r, t in g["totals"].items()}
    return ok, rec, g["totals"]


def _path_b_run(eng, suffixes):
    """One path-B drive on engine `eng` (its prefix installed): 8 suffixes
    admitted and stepped to completion, one generate(), then 8 more
    admitted with one step() under the profiler (launch_census) and the
    rest drained."""
    import torch

    pages0 = eng.kv.pages_free
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    plen = eng.prefix_len
    shapes = [("step after admission", eng._padded_tables().clone(),
               (eng._state.pos - plen).clone())]
    fins = []
    while eng.has_active:
        fins += eng.step()
        if len(shapes) == 1:
            shapes.append(("step after one chunk", eng._padded_tables().clone(),
                           (eng._state.pos - plen).clone()))
    batch_s = time.perf_counter() - t0
    chunks_batch = eng.stats["chunks"]
    t1 = time.perf_counter()
    gen = eng.generate(suffixes[0], max_new_tokens=PATH_B_NEW_TOKENS)
    gen_s = time.perf_counter() - t1
    chunks_main = eng.stats["chunks"]
    pages_main = eng.kv.pages_free
    more = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    box = {}
    census = launch_census(lambda: box.setdefault("fins", eng.step()))
    census["decode_steps"] = (eng.stats["chunks"] - chunks_main) * eng.chunk_steps
    extra = box["fins"]
    while eng.has_active:
        extra += eng.step()
    done = {f.req_id: f.token_ids for f in fins}
    done_more = {f.req_id: f.token_ids for f in extra}
    return {
        "ids": ids, "tokens": [done.get(i) for i in ids], "generate": gen.token_ids,
        "extra": [done_more.get(i) for i in more],
        "batch_s": batch_s, "chunks_batch": chunks_batch, "gen_s": gen_s,
        "chunks_main": chunks_main, "pages0": pages0, "pages_main": pages_main,
        "pages_end": eng.kv.pages_free, "shapes": shapes, "census": census,
        "pages_shape": tuple(eng.kv.k.shape[1:]),
    }


def path_b_phase(backend, nodes, pods):
    """General completion on the bf16 8B params: set_prefix, add_requests,
    step() to completion, then generate(), own-token attention through K4,
    in both modes: identical tokens, every page returned."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    runs, ok = {}, True
    rec = {"model": "llama-3.1-8b-instruct bf16, paged_attn=pallas",
           "suffix_tokens": [len(sfx) for sfx in suffixes]}
    for mode, graphs in MODES:
        # step() and a generate() that drains through step(): the fused
        # runtime has its own phase
        eng = InferenceEngine(backend.engine.params, cfg, ByteTokenizer(), temperature=0.0,
                              paged_attn="pallas", max_slots=8, page_size=64, graphs=graphs,
                              fused_decode=False)
        eng.set_prefix(items[0].prefix_ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with launches_by_step(eng) as steps:
            _zero_launch_counts()
            r = _path_b_run(eng, suffixes)
            launches = _launch_counts()
        runs[mode] = r
        n_tok = sum(len(t) for t in r["tokens"] if t is not None)
        steps_run = r["chunks_batch"] * eng.chunk_steps
        good = (all(t is not None and 1 <= len(t) <= PATH_B_NEW_TOKENS for t in r["tokens"])
                and 1 <= len(r["generate"]) <= PATH_B_NEW_TOKENS
                and all(t is not None and 1 <= len(t) <= PATH_B_NEW_TOKENS
                        for t in r["extra"])
                and launches["K4"] > 0
                and r["pages_main"] == r["pages0"] == r["pages_end"])
        census = r["census"]
        rec[mode] = {
            "prefix_tokens": eng.prefix_len,
            "requests": len(r["ids"]),
            "tokens_per_request": [len(t or ()) for t in r["tokens"]],
            "batch_wall_s": r["batch_s"],
            "batch_tokens_per_s": n_tok / r["batch_s"],
            "chunks": r["chunks_batch"],
            "ms_per_decode_step": r["batch_s"] * 1000.0 / steps_run,
            "generate_tokens": len(r["generate"]),
            "generate_wall_s": r["gen_s"],
            "generate_tokens_per_s": len(r["generate"]) / r["gen_s"],
            "generate_ms_per_decode_step": r["gen_s"] * 1000.0 / (
                (r["chunks_main"] - r["chunks_batch"]) * eng.chunk_steps),
            "launches": launches,
            "launches_per_decode_step": launches["K4"] / (eng.stats["chunks"] * eng.chunk_steps),
            "kernel_launches_per_run": per_call(steps),
            "steps": steps,
            "census_step": census,
            "host_launches_per_decode_step": census["host_launches"] / census["decode_steps"],
            "device_ops_per_decode_step": census["device_ops"] / census["decode_steps"],
            **_graph_books(eng), **_memory(start),
            "pages_free_start": r["pages0"], "pages_free_end": r["pages_end"],
            "ok": good,
        }
        ok = ok and good
        print(f"path B [{mode}]: " + json.dumps(rec[mode]), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs["graphs"], runs["eager"]
    same = (g["tokens"], g["generate"], g["extra"]) == (e["tokens"], e["generate"], e["extra"])
    calls = rec["graphs"]["kernel_launches_per_run"] == rec["eager"]["kernel_launches_per_run"]
    no_eager = (g["census"]["host_kernel_launches"] == 0
                and g["census"]["graph_launches"] >= 1)
    print(f"path B: graphs vs eager tokens identical={same}, launches per run equal={calls}, "
          f"graph-mode step launched no kernel outside a graph={no_eager}", flush=True)
    ok = ok and same and calls and no_eager
    rec["launches"] = rec["graphs"]["launches"]
    q_shape = (8 + 1, cfg.n_heads, cfg.head_dim)
    cases = [(step, q_shape, g["pages_shape"], t.cpu(), l.cpu())
             for step, t, l in g["shapes"]]
    return ok, rec, cases


# ------------------------------------------------------------------ fused phase
FUSED_TOP_K = 40
FUSED_DEAD_REPS = 10
# the fused chunk's sampling over constant probabilities (testing.chunk_draws:
# 16 runs of 16 steps on 64 slots, vocab 32): a draw equals its slot's draw
# at step 0 by chance ~0.04 of the time, and 16,384 draws lie ~0.02 from
# the softmax in total variation
CHUNK_REPEAT_LIMIT = 0.25
CHUNK_TV_LIMIT = 0.05


def _events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _live_chunk_ms(eng) -> tuple[float, int]:
    """Device ms (CUDA events) of one fused chunk dispatched on the live
    batch, and the steps it ran; its emissions park for the next harvest.
    The prefix and page tables are bound first, so no host copy lands in
    the window."""
    eng._bind_prefix()
    eng._padded_tables()
    start, end = _events()
    start.record()
    toks, steps, prog = eng._fused_chunk_dispatch()
    end.record()
    end.synchronize()
    eng._pending_emissions.append(toks)
    return start.elapsed_time(end), eng._book_fused_steps([(steps, prog)])


def _dead_chunk_ms(eng, reps: int) -> tuple[float, int]:
    """Device ms (CUDA events) of the fused chunk's program run `reps`
    times back to back on the finished batch, per run, and the steps the
    last ran: one dispatch first binds the tables and finds the program,
    then its replays alone are timed (no host buffer, no copy in the
    window)."""
    toks, steps, prog = eng._fused_chunk_dispatch()
    eng._book_fused_steps([(steps, prog)])
    start, end = _events()
    start.record()
    for _ in range(reps):
        prog.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, int(eng._chunk.j)


def _fused_run(eng, suffixes) -> dict:
    """On `eng` (its prefix installed): the 8 suffixes drained by step(),
    one generate() (its fused chunks capture the program), the 8 drained
    by decode_fused() (timed, with its books and K4 launches), then a live
    chunk and, on the finished batch, dead chunks timed alone."""
    import torch

    n = PATH_B_NEW_TOKENS
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    fins = []
    while eng.has_active:
        fins += eng.step()
    by_step = {f.req_id: f.token_ids for f in fins}
    stepped = [by_step[i] for i in ids]
    chunks1 = eng.stats["fused_chunks"]
    t1 = time.perf_counter()
    gen = eng.generate(suffixes[0], max_new_tokens=n)
    gen_rec = dict(generate=gen.token_ids, generate_s=time.perf_counter() - t1,
                   generate_chunks=eng.stats["fused_chunks"] - chunks1)
    steps0, tok0, chunks0 = (eng.stats[k] for k in ("fused_steps", "decode_tokens",
                                                    "fused_chunks"))
    k4_0 = _launch_counts()["K4"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    wall = time.perf_counter() - t0
    fused = [done.get(i) for i in ids]
    steps = eng.stats["fused_steps"] - steps0
    rec = {
        "tokens": fused, "stepped": stepped,
        "wall_s": wall, "fused_steps": steps, "chunks": eng.stats["fused_chunks"] - chunks0,
        "decode_tokens": eng.stats["decode_tokens"] - tok0,
        "k4_launches": _launch_counts()["K4"] - k4_0, **gen_rec,
    }
    # a live chunk (16 steps on 8 slots) beside over-dispatched ones on the
    # finished batch; the live batch then drains
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    rec["live_chunk_ms"], rec["live_chunk_steps"] = _live_chunk_ms(eng)
    while eng.has_active:
        eng.decode_fused()
    rec["dead_chunk_ms"], rec["dead_chunk_steps"] = _dead_chunk_ms(eng, FUSED_DEAD_REPS)
    return rec


def _sampled_fused(params, cfg, prefix, suffixes) -> dict:
    """Two sampled decode_fused drains at temperature 0.3 with top-k 40
    (graphs), the second timed: every token a decodable id, never pad,
    within the budget."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = InferenceEngine(params, cfg, tok, temperature=SAMPLED_TEMPERATURE,
                          top_k=FUSED_TOP_K, paged_attn="pallas", max_slots=8, page_size=64)
    eng.set_prefix(prefix)
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    streams = [done.get(i) for i in ids]
    # a second drain, its chunk captured: timed
    steps0 = eng.stats["fused_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    wall = time.perf_counter() - t0
    steps = eng.stats["fused_steps"] - steps0
    streams += [done.get(i) for i in ids]
    valid = all(s is not None and 1 <= len(s) <= PATH_B_NEW_TOKENS
                and all(0 <= t < tok.vocab_size and t != tok.pad_id for t in s)
                for s in streams)
    rec = {"temperature": SAMPLED_TEMPERATURE, "top_k": FUSED_TOP_K, "valid": valid,
           "tokens": sum(len(s or ()) for s in streams),
           "distinct_streams": len({tuple(s or ()) for s in streams}),
           "fused_chunks": eng.stats["fused_chunks"], "replays": eng._graphs.replays,
           "timed_wall_s": wall, "timed_fused_steps": steps,
           "timed_ms_per_step": wall * 1000.0 / max(steps, 1)}
    del eng
    return rec


def _chunk_draws_check() -> dict:
    """The fused chunk's sampling captured on the card (its steps one WHILE
    node) over probabilities that stay constant: every run takes its 16
    steps, 15 of the 16 runs are replays, a slot's draws across one chunk's
    steps are independent (a draw made inside the WHILE body would repeat
    at every step) and follow the softmax within CHUNK_TV_LIMIT."""
    from k8s_llm_scheduler_tpu_torch import testing

    rec = testing.chunk_draws("cuda")
    rec["ok"] = (rec["steps_run"] == [16] * 16 and rec["replays"] == 15
                 and rec["repeat"] <= CHUNK_REPEAT_LIMIT and rec["tv"] <= CHUNK_TV_LIMIT)
    return rec


def fused_phase(backend, nodes, pods, path_b) -> tuple[bool, dict]:
    """The fused decode runtime at 8B bf16: path B's engine configuration
    (paged_attn="pallas", 8 slots, the path B prompts, greedy, 64 new
    tokens) in both modes. decode_fused must emit the tokens of a step()
    drain, book exactly max(tokens) - 1 steps and sum(tokens - 1) decode
    tokens, launch K4 n_layers times a step inside its program, and
    generate() must go through it; graphs and eager emit identical tokens.
    Times ms a step and tok/s beside path B's, and one over-dispatched
    chunk on a finished batch beside a live chunk (CUDA events). Then one
    sampled drain (0.3, top-k 40) whose tokens must all be valid, and the
    chunk's sampling over constant probabilities (_chunk_draws_check)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    prefix = items[0].prefix_ids
    rec, runs, ok = {"model": "llama-3.1-8b-instruct bf16, paged_attn=pallas"}, {}, True
    for mode, graphs in MODES:
        eng = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0,
                              paged_attn="pallas", max_slots=8, page_size=64, graphs=graphs)
        eng.set_prefix(prefix)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        r = runs[mode] = _fused_run(eng, suffixes)
        lens = [len(t) for t in r["tokens"] if t is not None]
        n_tok = sum(lens)
        books = (len(lens) == len(suffixes) and r["fused_steps"] == max(lens) - 1
                 and r["decode_tokens"] == sum(n - 1 for n in lens))
        good = (r["tokens"] == r["stepped"] and books
                and r["k4_launches"] == cfg.n_layers * r["fused_steps"] > 0
                and r["generate_chunks"] > 0 and 1 <= len(r["generate"]) <= PATH_B_NEW_TOKENS
                and r["live_chunk_steps"] == eng.chunk_steps and r["dead_chunk_steps"] == 0
                and eng.stats["fused_fallbacks"] == 0)
        b = path_b.get(mode, {})
        rec[mode] = {
            "tokens_equal_step_drain": r["tokens"] == r["stepped"], "books_exact": books,
            "tokens_per_request": lens, "fused_steps": r["fused_steps"],
            "fused_chunks": r["chunks"], "decode_tokens": r["decode_tokens"],
            "k4_launches": r["k4_launches"],
            "wall_s": r["wall_s"], "ms_per_step": r["wall_s"] * 1000.0 / r["fused_steps"],
            "tokens_per_s": n_tok / r["wall_s"],
            "path_b_ms_per_step": b.get("ms_per_decode_step"),
            "path_b_tokens_per_s": b.get("batch_tokens_per_s"),
            "generate_tokens": len(r["generate"]), "generate_chunks": r["generate_chunks"],
            "generate_s": r["generate_s"],
            "live_chunk_ms": r["live_chunk_ms"], "live_chunk_steps": r["live_chunk_steps"],
            "dead_chunk_ms": r["dead_chunk_ms"],
            **_graph_books(eng), **_memory(start), "ok": good,
        }
        ok = ok and good
        print(f"fused [{mode}]: " + json.dumps(rec[mode]), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = runs["graphs"]["tokens"] == runs["eager"]["tokens"]
    rec["sampled"] = _sampled_fused(params, cfg, prefix, suffixes)
    gc.collect()
    torch.cuda.empty_cache()
    rec["chunk_draws"] = _chunk_draws_check()
    ok = ok and same and rec["sampled"]["valid"] and rec["chunk_draws"]["ok"]
    print(f"fused: graphs vs eager tokens identical={same}; sampled drain "
          f"{json.dumps(rec['sampled'])}; chunk draws {json.dumps(rec['chunk_draws'])} "
          f"| {_smi()} | ok={ok}", flush=True)
    rec["launches"] = {"K4": rec["graphs"]["k4_launches"]}
    return ok, rec


# ------------------------------------------------------------ persistent phase
class _OpCounter:
    """Counts the torch ops run on the thread that enters it (a torch
    dispatch mode: modes are thread-local)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = self.ops = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(str(func))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _drain_resident(eng, n, deadline_s=300.0) -> dict:
    out = {}
    end = time.perf_counter() + deadline_s
    while len(out) < n and time.perf_counter() < end:
        for fin in eng.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids
    return out


def persistent_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """(a) The resident loop at 8B bf16, unconstrained, greedy: an engine
    with paged_attn="gather" (the loop's own-token attention is the dense
    gather, as in the JAX loop), suffix bucket 256; reference: the 8
    path B suffixes admitted one at a time and drained by decode_fused.
    Then enter_persistent, the 8 through the command ring, step_persistent
    until done: the same tokens, the counter block's `emitted` equal to
    the decode tokens harvested, no torch op on the owner thread and no
    dispatch booked between the admissions and the last harvest. Then a
    quiesce mid-stream, and the rest drained by step_fused: the same
    tokens again."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    n = PATH_B_NEW_TOKENS
    eng = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, paged_attn="gather",
                          max_slots=8, page_size=64, num_pages=128, max_pages_per_seq=8,
                          prefill_buckets=(256, 512, 1024, 2048), persistent_loop=True,
                          persistent_suffix_bucket=256)
    eng.set_prefix(items[0].prefix_ids)
    rec = {"model": "llama-3.1-8b-instruct bf16, paged_attn=gather",
           "suffix_tokens": [len(s) for s in suffixes]}
    try:
        ids = [eng.add_requests([s], max_new_tokens=n)[0] for s in suffixes]
        done = {f.req_id: f.token_ids for f in eng.decode_fused()}
        want = [done.get(i) for i in ids]
        # a warm-up residency: its first micro-chunks capture the loop's
        # admit and plain programs
        t_warm = time.perf_counter()
        eng.enter_persistent()
        eng.add_requests(suffixes[:1], max_new_tokens=2 * eng.chunk_steps)
        _drain_resident(eng, 1)
        eng.exit_persistent()
        rec["warmup_s"] = time.perf_counter() - t_warm

        torch.cuda.synchronize()
        before = _launch_counts()
        t_enter = time.perf_counter()
        entered = eng.enter_persistent()
        dispatches, tok0, steps0 = (eng.stats[k] for k in ("dispatches", "decode_tokens",
                                                          "persistent_steps"))
        t0 = time.perf_counter()
        with _OpCounter() as owner:
            ids = eng.add_requests(suffixes, max_new_tokens=n)
            out = _drain_resident(eng, len(ids))
        wall = time.perf_counter() - t0
        steady_dispatches = eng.stats["dispatches"] - dispatches
        resident_tokens = eng.stats["decode_tokens"] - tok0
        resident_steps = eng.stats["persistent_steps"] - steps0
        eng.exit_persistent()
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        totals = eng.persistent_counter_totals() or {}
        got = [out.get(i) for i in ids]
        n_tok = sum(len(t) for t in got if t is not None)

        # quiesce mid-stream, resume on the dispatch path
        reentered = eng.enter_persistent()
        ids = eng.add_requests(suffixes, max_new_tokens=n)
        mid = {}
        end = time.perf_counter() + 300.0
        while eng.stats["persistent_steps"] - resident_steps - steps0 < 1 and \
                time.perf_counter() < end:
            for fin in eng.step_persistent(timeout_s=0.05):
                mid[fin.req_id] = fin.token_ids
        eng.exit_persistent()
        for fin in eng.step_persistent(timeout_s=0.0):
            mid[fin.req_id] = fin.token_ids
        while eng.has_active:
            for fin in eng.step_fused():
                mid[fin.req_id] = fin.token_ids
        resumed = [mid.get(i) for i in ids]
        srv = eng._persistent
        rec.update({
            "entered": entered and reentered, "enter_s": t0 - t_enter,
            "tokens_equal_decode_fused": got == want,
            "resume_tokens_equal": resumed == want,
            "owner_thread_torch_ops": len(owner.ops), "owner_ops_sample": owner.ops[:5],
            "steady_dispatches": steady_dispatches,
            "counter_totals": totals, "harvested_decode_tokens": resident_tokens,
            "resident_steps": resident_steps, "wall_s": wall,
            "ms_per_step": wall * 1000.0 / max(resident_steps, 1),
            "tokens_per_s": n_tok / wall, "launches": launches,
            "tokens_per_request": [len(t or ()) for t in got],
            "launches_total": eng.stats["persistent_launches"],
            **_graph_books(eng), **srv.stats(),
        })
    finally:
        if eng.persistent_active:
            eng.exit_persistent()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    ok = (rec["entered"] and rec["tokens_equal_decode_fused"] and rec["resume_tokens_equal"]
          and rec["owner_thread_torch_ops"] == 0 and rec["steady_dispatches"] == 0
          and totals.get("emitted") == resident_tokens and totals.get("admits") == len(suffixes)
          and launches["K1"] > 0 and launches["K2"] > 0)
    print(f"persistent (a): {json.dumps(rec, default=str)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def persistent_tiny() -> tuple[bool, dict]:
    """(b) TINY, the decision grammar, through LocalLLMBackend(
    persistent_loop=True) on the card (graphs, the config's temperature
    0.3): 6 decisions at once served by the resident loop (no wave), all
    parsed and feasible."""
    import concurrent.futures as cf

    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    nodes, pods = synthetic_nodes(4), fixture_pods(6)
    backend = build_local_backend("tiny", device="cuda", request_timeout_s=600.0,
                                  prewarm_idle_delay_s=NO_PREWARM_S, persistent_loop=True,
                                  persistent_suffix_bucket=1024)
    t0 = time.perf_counter()
    try:
        with cf.ThreadPoolExecutor(len(pods)) as pool:
            decisions = list(pool.map(lambda p: backend.get_scheduling_decision(p, nodes),
                                      pods))
        wall = time.perf_counter() - t0
        stats = backend.engine.get_stats()
    finally:
        backend.close()
    llm = all(d.source == DecisionSource.LLM for d in decisions)
    feasible = _feasible(nodes, list(zip(pods, decisions)))
    rec = {k: stats.get(k) for k in ("persistent_launches", "persistent_admissions",
                                     "persistent_fallbacks", "persistent_steps",
                                     "persistent_chunks", "waves", "persistent_wedges")}
    rec.update(decisions=len(decisions), all_llm=llm, feasible=feasible, wall_s=wall)
    ok = (llm and feasible and rec["persistent_admissions"] == len(pods)
          and rec["persistent_fallbacks"] == 0 and rec["waves"] == 0
          and rec["persistent_wedges"] == 0)
    print(f"persistent (b): TINY decisions through the resident loop {json.dumps(rec)} "
          f"| ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------------------ spec phase
SPEC_K = 4  # the config's llm.spec_k
SPEC_NEW_TOKENS = 16  # 64 until PR 21: the smoke's time limit
SPEC_PROMPTS = 2
SPEC_TEMPERATURE = 0.3  # the config's llm.temperature
# Greedy at 8B bf16 is held token by token to the target's own argmax: each
# emitted token's logit, under one teacher-forced forward of prompt +
# output, within 5e-2 of the largest |logit| of the largest (the bf16
# tolerance of the reference phase); a verify block and a one-token step
# round differently, so near-ties may flip between the two paths.
SPEC_TF_TOL = 5e-2
# The self-draft's acceptance at TINY bf16: 1.0 in f32 (tests/test_torch_
# spec.py); a random draft's is ~0.
SPEC_SELF_ACCEPT = 0.75
SPEC_TINY_PROMPT = "The quick brown fox jumps over the lazy dog. " * 2
SPEC_TINY_NODES = ["node-a", "node-b", "node-west-1"]
SPEC_COMPLETE_PROMPT = "Schedule pod web-1 on the least loaded node."


def _sync_s(fn):
    """(fn(), host seconds of it, ending in a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _verify_runs(spec) -> int:
    """Verify programs run (eager, warm-up or replay) by a decoder."""
    return sum(p.program.runs for p in spec._programs.values())


def _teacher_forced(eng, sfx, out):
    """The target's logits [len(out), V] f32 predicting each token of `out`,
    from one forward of sfx + out[:-1] against the engine's prefix (K1 and
    K2, as a suffix prefill computes them), and the mask of the ids plain
    decode may emit (pad and ids past the tokenizer excluded)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models import llama

    params, cfg, dev = eng.params, eng.cfg, eng.device
    pfx = eng._prefix or eng._get_empty_prefix()
    ids = list(sfx) + list(out[:-1])
    S = len(ids)
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    plen = torch.tensor(pfx.length, dtype=torch.int32, device=dev)
    positions = plen + torch.arange(S, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    inv = llama.rope_inv_freq(cfg, dev)
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        for i in range(cfg.n_layers):
            x, _, _ = llama._suffix_layer(llama._layer(params["layers"], i), cfg, x,
                                          positions, lens, pfx.k[i], pfx.v[i], plen, inv)
        logits = llama._logits(params, cfg, x[0, len(sfx) - 1:])
    V = logits.shape[-1]
    ids_v = torch.arange(V, device=dev)
    legal = ids_v != eng.tokenizer.pad_id
    if eng._vocab_limit is not None:
        legal &= ids_v < eng._vocab_limit
    return logits, legal


def _argmax_check(eng, sfx, out) -> dict:
    """Each token of `out` against the teacher-forced argmax (SPEC_TF_TOL),
    over the ids plain decode may emit there: under a grammar, those its
    dense table allows in the state the output has reached."""
    import torch

    logits, legal = _teacher_forced(eng, sfx, out)
    legal = legal.expand(len(out), -1)
    dense = eng.dense_grammar()
    if dense is not None:
        table = dense.cpu()
        st, rows = eng._dfa_start, []
        for t in out:
            rows.append(table[st] >= 0)
            st = int(table[st, t])
        legal = legal & torch.stack(rows).to(logits.device)
    masked = torch.where(legal, logits, float("-inf"))
    top = masked.max(dim=-1).values
    scale = torch.where(legal, logits.abs(), 0.0).max(dim=-1).values
    got = masked.gather(1, torch.tensor(out, device=logits.device)[:, None].long())[:, 0]
    gap = ((top - got) / scale).cpu()
    exact = (masked.argmax(dim=-1).cpu() == torch.tensor(out)).tolist()
    return {"max_gap_rel": float(gap.max()), "exact_argmax": sum(exact),
            "tokens": len(out), "ok": bool((gap <= SPEC_TF_TOL).all())}


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _spec_drive(eng, spec, prompts, check=True) -> dict:
    """Each prompt through generate(use_spec=False) and then the attached
    decoder, timed (and its start(): the admission, the first token's
    fetch and the draft's prefill); the decoder's books, host syncs, verify
    runs and kernel launches of its runs, every token held against the
    teacher-forced argmax."""
    import torch

    n = SPEC_NEW_TOKENS
    rec = {"prompts": [], "plain_s": 0.0, "spec_s": 0.0, "start_s": 0.0, "plain_tokens": 0,
           "spec_tokens": 0, "syncs": 0}
    real_start = spec.start

    def timed_start(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_start(*args, **kwargs)
        torch.cuda.synchronize()
        rec["start_s"] += time.perf_counter() - t0
        return out

    spec.start = timed_start
    s0 = spec.stats.snapshot()
    runs0 = _verify_runs(spec)
    launches = {k: 0 for k in _launch_counts()}
    for sfx in prompts:
        plain, plain_s = _sync_s(lambda: eng.generate(sfx, n, use_spec=False))
        before, syncs0 = _launch_counts(), eng.stats["syncs"]
        fin, spec_s = _sync_s(lambda: eng.generate(sfx, n))
        rec["syncs"] += eng.stats["syncs"] - syncs0
        for k, v in _launch_counts().items():
            launches[k] += v - before[k]
        rec["plain_s"] += plain_s
        rec["spec_s"] += spec_s
        rec["plain_tokens"] += len(plain.token_ids)
        rec["spec_tokens"] += len(fin.token_ids)
        p = {"tokens": len(fin.token_ids), "plain_tokens": len(plain.token_ids),
             "first_divergence": _first_divergence(fin.token_ids, plain.token_ids),
             "spec_ids": fin.token_ids}
        if check:
            p["argmax"] = _argmax_check(eng, sfx, fin.token_ids)
        rec["prompts"].append(p)
    s1 = spec.stats.snapshot()
    d = {k: s1[k] - s0[k] for k in ("requests", "rounds", "proposed", "accepted", "emitted",
                                     "disables", "fallback_requests", "overlapped_rounds",
                                     "ahead_wasted")}
    rec.update(books=d, acceptance_rate=d["accepted"] / max(d["proposed"], 1),
               verify_runs=_verify_runs(spec) - runs0,
               launches=launches)
    # a round: a verify (and the draft arm's proposals), its one fetch and
    # the host's books, start() left out
    rec["ms_per_round"] = ((rec["spec_s"] - rec["start_s"]) * 1000.0
                           / max(rec["verify_runs"], 1))
    del spec.start
    rec["ms_per_token"] = rec["spec_s"] * 1000.0 / max(rec["spec_tokens"], 1)
    rec["plain_ms_per_token"] = rec["plain_s"] * 1000.0 / max(rec["plain_tokens"], 1)
    # admission launches K1 n_layers times a request, each verify n_layers
    rec["k1_expected"] = eng.cfg.n_layers * (len(prompts) + rec["verify_runs"])
    return rec


def _spec_ok(rec, greedy=True, hand_off=False) -> bool:
    b = rec["books"]
    ok = (rec["launches"]["K1"] == rec["k1_expected"] and rec["verify_runs"] > 0
          and all(1 <= p["tokens"] <= SPEC_NEW_TOKENS for p in rec["prompts"]))
    if greedy:
        ok = ok and all(p["argmax"]["ok"] for p in rec["prompts"])
    if not hand_off:
        # one sync at start, then one a round (the bootstrap rounds of the
        # hidden arm are verify runs too)
        ok = ok and rec["syncs"] == rec["verify_runs"] + b["requests"] and b["disables"] == 0
    return ok


def _spec_engine(params, cfg, **kw):
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    return InferenceEngine(params, cfg, ByteTokenizer(), **{
        "temperature": 0.0, "paged_attn": "pallas", "max_slots": 2, "page_size": 64,
        "num_pages": 96, "max_pages_per_seq": 16, **kw})


def _spec_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """(a)-(d) on the 8B bf16 weights of the resident backend."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
    from k8s_llm_scheduler_tpu_torch.spec.draft import build_random_draft

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods[:SPEC_PROMPTS]]
    prompts = [it.suffix_ids for it in items]
    prefix = items[0].prefix_ids
    vocab = backend.engine.tokenizer.vocab_size
    draft_params, draft_cfg = build_random_draft(get_config("tiny"), vocab, seed=1,
                                                 device="cuda")
    rec, ok = {"draft": draft_cfg.name, "k": SPEC_K, "prefix_tokens": len(prefix),
               "suffix_tokens": [len(p) for p in prompts]}, True

    def draft_dec(eng, **kw):
        return SpeculativeDecoder(eng, draft_params, draft_cfg, k=SPEC_K, **kw)

    def hidden_dec(eng):
        return SpeculativeDecoder(eng, arm="hidden", k=SPEC_K, hidden_seed=1,
                                  disable_threshold=0.0)

    for mode, graphs in MODES:
        eng = _spec_engine(params, cfg, graphs=graphs)
        eng.set_prefix(prefix)
        drive = prompts if graphs else prompts[:1]
        for arm, make in (("draft", lambda e: draft_dec(e, disable_threshold=0.0)),
                          ("hidden", hidden_dec)):
            spec = make(eng)
            eng.attach_spec(spec)
            r = _spec_drive(eng, spec, drive)
            r["ok"] = _spec_ok(r)
            rec[f"{arm} [{mode}]"] = r
            ok = ok and r["ok"]
            eng.attach_spec(None)
            del spec
            gc.collect()
        if graphs:
            # (d) auto-disable at the default threshold, no prefix (K1 at
            # prefix_len 0): a random draft hands the slot back after
            # min_rounds and the request finishes through the fused chunks
            eng.set_prefix(None)
            spec = draft_dec(eng)
            eng.attach_spec(spec)
            r = _spec_drive(eng, spec, prompts[:1])
            r["handed_off"] = r["books"]["fallback_requests"] == 1 == r["books"]["disables"]
            r["ms_per_round"] = None  # the fused chunks after the hand-off are in spec_s
            r["ok"] = (_spec_ok(r, hand_off=True) and r["handed_off"]
                       and r["launches"]["K4"] > 0)
            rec["auto-disable [graphs]"] = r
            ok = ok and r["ok"]
            eng.attach_spec(None)
            rec["graph_books"] = _graph_books(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for arm in ("draft", "hidden"):
        g, e = rec[f"{arm} [graphs]"], rec[f"{arm} [eager]"]
        same = g["prompts"][0]["spec_ids"] == e["prompts"][0]["spec_ids"]
        rec[f"{arm} graphs vs eager identical"] = same
        ok = ok and same
    # (c) the draft arm sampled at the config's 0.3 (graphs): legal tokens
    eng = _spec_engine(params, cfg, temperature=SPEC_TEMPERATURE)
    eng.set_prefix(prefix)
    spec = draft_dec(eng, disable_threshold=0.0)
    eng.attach_spec(spec)
    r = _spec_drive(eng, spec, prompts, check=False)
    streams = [p["spec_ids"] for p in r["prompts"]]
    r["legal"] = all(0 <= t < vocab and t != eng.tokenizer.pad_id for s in streams for t in s)
    r["ok"] = _spec_ok(r, greedy=False) and r["legal"]
    rec["draft sampled [graphs]"] = r
    ok = ok and r["ok"]
    del eng, spec
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rec


def _spec_tiny() -> tuple[bool, dict]:
    """(e) TINY bf16 on the card (the kernels take bf16), graphs, greedy:
    each arm (a random draft, the self-draft, the hidden head),
    unconstrained and under the decision grammar behind a prefix, beside
    plain generate: whether the tokens are identical and where they first
    differ is reported; every token must hold the teacher-forced argmax
    (grammar-masked) within SPEC_TF_TOL, and the self-draft must accept at
    least SPEC_SELF_ACCEPT of its proposals (bf16 near-ties). Then the
    draft arm sampled at 0.3: every token legal, and replays draw afresh
    (the same prompt's streams are not all equal)."""
    from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
    from k8s_llm_scheduler_tpu_torch.spec.draft import build_random_draft

    tok = ByteTokenizer()
    params = init_params(TINY, seed=0, device="cuda")
    draft, draft_cfg = build_random_draft(TINY, tok.vocab_size, seed=1, device="cuda")
    arms = {
        "draft": lambda e: SpeculativeDecoder(e, draft, draft_cfg, k=SPEC_K,
                                              disable_threshold=0.0),
        "self-draft": lambda e: SpeculativeDecoder(e, params, TINY, k=SPEC_K),
        "hidden": lambda e: SpeculativeDecoder(e, arm="hidden", k=SPEC_K, hidden_seed=1,
                                               disable_threshold=0.0),
    }
    rec, ok = {}, True
    for grammar in (False, True):
        eng = _spec_engine(params, TINY, max_pages_per_seq=8, num_pages=32,
                           prefill_buckets=(64, 128, 256))
        if grammar:
            eng.set_grammar(build_decision_dfa(tok, SPEC_TINY_NODES, max_reason_tokens=16))
            eng.set_prefix(tok.encode("cluster: node-a node-b node-west-1. "))
            prompt, n = tok.encode("Pick a node: "), 110
        else:
            prompt, n = tok.encode(SPEC_TINY_PROMPT), SPEC_NEW_TOKENS
        plain = eng.generate(prompt, n, use_spec=False).token_ids
        for arm, make in arms.items():
            spec = make(eng)
            eng.attach_spec(spec)
            got = eng.generate(prompt, n).token_ids
            snap = spec.stats.snapshot()
            argmax = _argmax_check(eng, prompt, got)
            good = argmax["ok"] and snap["rounds"] > 0
            if arm == "self-draft":
                # a self-draft disagrees with its target's verify only at
                # bf16 near-ties (the draft attends in f32 over a dense
                # buffer, the verify's prefix part rounds as K1 does)
                good = good and snap["acceptance_rate"] >= SPEC_SELF_ACCEPT
            r = {"identical": got == plain, "first_divergence": _first_divergence(got, plain),
                 "tokens": len(got), "rounds": snap["rounds"], "argmax": argmax,
                 "accepted_all": snap["accepted"] == SPEC_K * snap["rounds"],
                 "acceptance_rate": snap["acceptance_rate"], "mode": spec._grammar_mode()[0],
                 "ok": good}
            rec[f"{arm} {'grammar' if grammar else 'free'}"] = r
            ok = ok and good
            eng.attach_spec(None)
    eng = _spec_engine(params, TINY, max_pages_per_seq=8, num_pages=32,
                       prefill_buckets=(64, 128, 256), temperature=SPEC_TEMPERATURE)
    spec = arms["draft"](eng)
    eng.attach_spec(spec)
    prompt = tok.encode(SPEC_TINY_PROMPT)
    replays0 = eng._graphs.replays
    streams = [eng.generate(prompt, 32).token_ids for _ in range(4)]
    legal = all(0 <= t < tok.vocab_size and t != tok.pad_id for s in streams for t in s)
    r = {"streams": len(streams), "distinct": len({tuple(s) for s in streams}),
         "legal": legal, "replays": eng._graphs.replays - replays0,
         "rounds": spec.stats.rounds}
    r["ok"] = legal and r["distinct"] > 1 and r["replays"] > 0
    rec["draft sampled"] = r
    ok = ok and r["ok"]
    return ok, rec


def start_spec_complete():
    """Start (f)'s two children: `cli complete --spec` at TINY (greedy
    through LLM_TEMPERATURE=0) and the same command without --spec, in a
    temporary directory; _spec_complete() collects them. They run beside
    path A."""
    cwd = tempfile.TemporaryDirectory()
    procs = {}
    for name, extra in (("spec", ["--spec"]), ("plain", [])):
        cmd = [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "complete",
               "--prompt", SPEC_COMPLETE_PROMPT, "--model", "tiny",
               "--max-new-tokens", "32", "--device", "cuda", *extra]
        procs[name] = subprocess.Popen(cmd, cwd=cwd.name, env=_child_env(LLM_TEMPERATURE="0"),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    return procs, cwd


def _spec_complete(started) -> tuple[bool, dict]:
    """(f) `cli complete --spec` at TINY in a child process, beside the same
    command without --spec (start_spec_complete): both exit 0 and print
    the same text."""
    procs, cwd = started
    outs = {}
    try:
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            outs[name] = (proc.returncode, out, err)
    finally:
        cwd.cleanup()
    rec = {name: {"rc": rc, "stdout_chars": len(out)} for name, (rc, out, _) in outs.items()}
    rec["stdout_equal"] = outs["spec"][1] == outs["plain"][1]
    ok = all(rc == 0 for rc, _, _ in outs.values()) and rec["stdout_equal"]
    if not ok:
        for name, (_, _, err) in outs.items():
            print(f"cli complete {name} stderr: {err[-3000:]}", file=sys.stderr, flush=True)
    return ok, rec


def spec_phase(backend, nodes, pods, complete_started) -> tuple[bool, dict]:
    """Speculative decoding (spec/) on the resident 8B backend's weights and
    at TINY; K1 at the verify shapes. See the module doc, phase 6g.
    `complete_started` is start_spec_complete()'s."""
    import torch

    ok8, rec = _spec_8b(backend, nodes, pods)
    okt, rec["tiny"] = _spec_tiny()
    okc, rec["cli_complete_spec"] = _spec_complete(complete_started)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    n = len(backend._prepare_item(pods[0], nodes).prefix_ids)
    chunk = min(backend.engine.prefix_chunk, backend.engine.prefill_buckets[-1])
    sp = -(-n // chunk) * chunk + chunk  # the engine's chunked prefix buffer
    from k8s_llm_scheduler_tpu_torch.engine.engine import EMPTY_PREFIX_SLOTS

    k1 = []
    for S, what in ((SPEC_K + 1, "draft / hidden verify"), (1, "hidden bootstrap")):
        for Sp, plen in ((sp, n), (EMPTY_PREFIX_SLOTS, 0)):
            good, r = _prefix_case(gen, f"spec {what}", 1, S, Sp, plen)
            r["ok"] = good
            r["bound_share"] = r["bound_ms"] / r["ms"]
            _print_attention_case("K1", r)
            k1.append(r)
            torch.cuda.empty_cache()
    rec["k1_cases"] = k1
    okk = all(r["ok"] for r in k1)
    rec["k1_spec_launches"] = sum(
        v["launches"]["K1"] for k, v in rec.items() if isinstance(v, dict) and "launches" in v)
    ok = ok8 and okt and okc and okk
    summary = {k: ({kk: vv for kk, vv in v.items() if kk not in ("prompts",)}
                   if isinstance(v, dict) else v) for k, v in rec.items() if k != "k1_cases"}
    print(f"spec: {json.dumps(summary, default=str)} | {_smi()} | ok={ok} "
          f"(8B {ok8}, TINY {okt}, cli complete --spec {okc}, K1 {okk})", flush=True)
    return ok, rec


# ------------------------------------------------------------ training phases
TRAIN_MODEL = "llama-3.2-1b-instruct"
TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_SEQ = 4, 2048  # cli train's defaults
TRAIN_LR = 3e-4  # cli train's default
TRAIN_REF_TOL = 1e-2  # step 1's loss against a no-grad forward without recomputation
RECOMPUTE = 4.0 / 3.0  # a recomputing step runs the forward twice: 8N, not 6N, a token
HIDDEN_K = SPEC_K
HIDDEN_STEPS = 10
HIDDEN_BATCH, HIDDEN_SEQ = 4, 512  # train_hidden_transfer's defaults


def _step_books():
    """An on_step callback that records each step's loss, gradient norm (of
    the tensors the callback is handed a gradient on) and the host seconds
    since the previous step ended (each ends in a device sync)."""
    import torch

    rec = {"loss": [], "grad_norm": [], "step_s": [], "t": time.perf_counter()}

    def on_step(step, loss, tensors):
        grads = [t.grad.float() for t in tensors if t.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        rec["loss"].append(float(loss))
        rec["grad_norm"].append(float(norm))
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["step_s"].append(now - rec["t"])
        rec["t"] = now

    return rec, on_step


def _warm_ms(step_s) -> float:
    """Mean ms a step after the first (which also builds cuBLAS plans and the
    allocator's pools)."""
    warm = step_s[1:] or step_s
    return 1000.0 * sum(warm) / len(warm)


def train_1b(out_root: Path) -> tuple[bool, dict]:
    """Llama-3.2-1B at full width and depth, bf16, random from seed 0:
    train_and_save for TRAIN_STEPS steps at 4 x 2048 on make_batches (the
    byte tokenizer) into `out_root`/ckpt (kept: the learn phase's
    incumbent), the checkpoint restored through restore_checkpoint and one
    greedy decision served from it. See the module doc, phase 6k."""
    import torch

    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill, init_params
    from k8s_llm_scheduler_tpu_torch.models.loader import restore_checkpoint
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.train.distill import make_batches, train_and_save
    from k8s_llm_scheduler_tpu_torch.train.train_step import causal_lm_loss, param_leaves
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    tokenizer, cfg = build_builtin_tokenizer("byte", get_config(TRAIN_MODEL))
    # the reference for step 1: the params train_and_save draws (init_params,
    # seed 0) on its first batch (make_batches, seed 0), forward with no
    # recomputation and no gradient
    stream = make_batches(tokenizer, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    t0 = time.perf_counter()
    batch = next(stream)
    for _ in range(2):
        next(stream)
    # the host's share of a step: building a batch of teacher pairs
    batch_ms = (time.perf_counter() - t0) * 1000.0 / 3
    tokens, lens, starts, weights = (torch.as_tensor(a).cuda() for a in batch)
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in param_leaves(params))
    with torch.no_grad():
        logits, _, _ = forward_prefill(params, cfg, tokens.long(), lens)
        ref = float(causal_lm_loss(logits, tokens, lens, starts, weights))
    del params, logits
    torch.cuda.empty_cache()

    books, record = _step_books()
    kept = {}

    def on_step(step, loss, state):
        record(step, loss, param_leaves(state.params))
        kept["params"] = state.params

    rec = {"model": TRAIN_MODEL, "params": n_params, "steps": TRAIN_STEPS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR, "ref_loss": ref,
           "batch_host_ms": batch_ms}
    out = Path(out_root) / "ckpt"
    rec["checkpoint"] = str(out)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = train_and_save(cfg, str(out), steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, lr=TRAIN_LR, seed=0, log_every=TRAIN_STEPS,
                           device="cuda", on_step=on_step)
    rec["train_and_save_s"] = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    trained = kept.pop("params")
    for t in param_leaves(trained):
        t.grad = None
    t0 = time.perf_counter()
    restored = restore_checkpoint(out, cfg, device="cuda")
    rec["restore_s"] = time.perf_counter() - t0
    same = all(torch.equal(a.detach(), b) for a, b in
               zip(param_leaves(trained), param_leaves(restored)))
    del trained, restored
    torch.cuda.empty_cache()
    ms = _warm_ms(books["step_s"])
    toks = TRAIN_BATCH * TRAIN_SEQ
    rec.update(
        losses=books["loss"], grad_norms=books["grad_norm"], final_loss=final,
        step_ms=[1000.0 * s for s in books["step_s"]], ms_per_step=ms,
        tokens_per_s=toks / (ms / 1000.0),
        mfu=6.0 * n_params * toks * RECOMPUTE / (ms / 1000.0) / PEAK_BF16_FLOPS,
        restored_equal=same)

    # one greedy decision served from the restored checkpoint
    nodes, pod = synthetic_nodes(4), fixture_pods(1)[0]
    b = build_local_backend(TRAIN_MODEL, device="cuda", checkpoint_path=str(out),
                            temperature=0.0, request_timeout_s=600.0,
                            prewarm_idle_delay_s=NO_PREWARM_S)
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        decision = b.get_scheduling_decision(pod, nodes)
        rec["decision_s"] = time.perf_counter() - t0
        rec["decision_launches"] = _launch_counts()
    finally:
        b.close()
    names = {n.name for n in feasible_nodes(pod, nodes)}
    rec["decision"] = decision.selected_node
    finite = all(math.isfinite(x) for x in books["loss"] + books["grad_norm"])
    checks = {
        "finite": finite,
        "falls": books["loss"][-1] < books["loss"][0],
        "step1_vs_ref": abs(books["loss"][0] - ref) <= TRAIN_REF_TOL,
        "restored_equal": same,
        "decision": (decision.source == DecisionSource.LLM and decision.selected_node in names
                     and rec["decision_launches"]["K1"] > 0
                     and rec["decision_launches"]["K2"] > 0),
    }
    rec["checks"] = checks
    ok = all(checks.values())
    print(f"train 1B: {TRAIN_MODEL} ({n_params:,} params) bf16, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {[round(x, 4) for x in books['loss']]} "
          f"(step 1 against a no-grad forward {ref:.5f}), grad norms "
          f"{[round(x, 3) for x in books['grad_norm']]}; {ms:.1f} ms a step (steps 2-"
          f"{TRAIN_STEPS}; {batch_ms:.1f} ms of it a batch built on the host), "
          f"{rec['tokens_per_s']:.0f} tokens/s, MFU {rec['mfu']:.4f} "
          f"(8N a token against {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), peak "
          f"{rec['peak_gib']:.2f} GiB; restore {rec['restore_s']:.2f} s, equal {same}; "
          f"decision {decision.selected_node} in {rec['decision_s']:.2f} s, launches "
          f"{rec['decision_launches']} | {_smi()} | checks {checks} ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------- train parallel 1B
TRAIN_PAR_LAYERS = 4  # of Llama-3.2-1B's 16: five groups fit beside the TINY phases
TRAIN_PAR_LAYOUTS = (("dp2", {"dp": 2}, False), ("fsdp2", {"fsdp": 2}, False),
                     ("tp2", {"tp": 2}, False), ("sp2-ring", {"sp": 2}, False),
                     ("pp2", {"pp": 2}, True))
TRAIN_PAR_TIMED = 1  # steps timed after the checked one
TRAIN_PAR_LOSS_TOL = 5e-3  # |loss - one device's| / one device's (bf16 roundings)
# A leaf's gradient is held against one device's in f32 from the same bf16
# weights: |g - g32| / |g32| may exceed one bf16 device's own error by at
# most this. (The bf16 embedding gradient of one device is itself ~9% off
# at 1B: its frequent byte rows accumulate in bf16.)
TRAIN_PAR_GRAD_TOL = 1e-2


def _one_device_reference(cfg, batch, params_path) -> dict:
    """One AdamW step on one device from the tree at `params_path`: the
    loss, every gradient (kept on the card) and ms a step over
    TRAIN_PAR_TIMED more; then the same step's gradients in f32 from the
    same (bf16-valued) weights."""
    import torch

    from k8s_llm_scheduler_tpu_torch.parallel.dryrun import _grad_tree, _pairs
    from k8s_llm_scheduler_tpu_torch.train.train_step import adamw, make_train_step

    def step_grads(cfg_, make_opt, params):
        init_fn, step_fn = make_train_step(cfg_, "cuda", make_opt)
        state = init_fn(params)
        placed = step_fn.place_batch(*batch)
        state, loss = step_fn(state, *placed)
        grads = _grad_tree(state.params)
        grads = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.clone()) for k, v in grads.items()}
        return state, step_fn, placed, loss, grads

    torch.cuda.reset_peak_memory_stats()
    state, step_fn, placed, loss, grads = step_grads(
        cfg, adamw(TRAIN_LR), torch.load(params_path, map_location="cuda"))
    rec = {"loss": float(loss)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_PAR_TIMED):
        state, loss = step_fn(state, *placed)
    float(loss)
    rec["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / TRAIN_PAR_TIMED
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    f32 = torch.load(params_path, map_location="cuda")
    f32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in f32.items()}
    state, _, _, loss32, grads32 = step_grads(
        dataclasses.replace(cfg, dtype=torch.float32),
        lambda leaves: torch.optim.SGD(leaves, lr=0.0), f32)
    rec["loss_f32"] = float(loss32)
    del state, f32
    torch.cuda.empty_cache()
    rec["grad_rel_err_f32"] = {
        name: float((g.float() - r).norm() / r.norm().clamp(min=1e-30))
        for name, g, r in _pairs(grads, grads32)}
    return {**rec, "grads": grads, "grads_f32": grads32}


def train_parallel_phase() -> tuple[bool, dict]:
    """Phase 6n, in the process that runs it (a child of the smoke): each
    layout's group against the one-device step. See the module doc."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.parallel import launch
    from k8s_llm_scheduler_tpu_torch.parallel.dryrun import probe_step
    from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh
    from k8s_llm_scheduler_tpu_torch.train.distill import make_batches

    t_phase = time.perf_counter()
    tokenizer, cfg = build_builtin_tokenizer("byte", get_config(TRAIN_MODEL))
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_PAR_LAYERS)
    batch = next(make_batches(tokenizer, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    # seed 0's tree, drawn once: every rank reads it and keeps its slice
    params_path = str(Path.cwd() / "params_seed0.pt")
    full = init_params(cfg, seed=0, device="cuda")
    torch.save({k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                for k, v in full.items()}, params_path)
    del full
    refs = {"step": _one_device_reference(cfg, batch, params_path),
            "pp": _one_device_reference(cfg, batch[:2], params_path)}
    keep = ("loss", "loss_f32", "ms_per_step", "peak_bytes", "grad_rel_err_f32")
    rec = {"model": TRAIN_MODEL, "layers": TRAIN_PAR_LAYERS, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR,
           "backend": "gloo (staged through pinned host buffers; ranks share one card)",
           "reference": {k: {kk: v[kk] for kk in keep} for k, v in refs.items()},
           "layouts": {}, "setup_s": time.perf_counter() - t_phase}
    print(f"train parallel 1B: one device, {TRAIN_PAR_LAYERS} of 16 layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: {json.dumps(rec['reference'])}", flush=True)
    ok = True
    for name, axes, pipeline in TRAIN_PAR_LAYOUTS:
        ref = refs["pp" if pipeline else "step"]
        t0 = time.perf_counter()
        out = launch.run_spmd(
            make_mesh(axes), probe_step,
            dict(cfg=cfg, batch=batch[:2] if pipeline else batch, params=params_path,
                 lr=TRAIN_LR, device="cuda", pipeline=pipeline,
                 n_micro=2 if pipeline else None, timed_steps=TRAIN_PAR_TIMED, gather=False,
                 compare=True),
            device="cuda",
            driver_kwargs={"reference": {"bf16": ref["grads"], "f32": ref["grads_f32"]}})
        lay = {k: out[k] for k in ("loss", "last_loss", "ms_per_step", "collectives_per_step",
                                   "peak_bytes", "replicated_equal", "ranks_importing_jax")}
        lay["wall_s"] = time.perf_counter() - t0
        lay["loss_rel_err"] = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
        err, err32 = out["grad_rel_err"]["bf16"], out["grad_rel_err"]["f32"]
        # how far past one bf16 device's own distance from f32 each leaf is
        excess = {k: err32[k] - ref["grad_rel_err_f32"][k] for k in err32}
        worst = max(excess, key=excess.get)
        lay.update(grad_rel_err=err, grad_rel_err_f32=err32,
                   worst={"leaf": worst, "excess": excess[worst], "vs_f32": err32[worst],
                          "one_device_vs_f32": ref["grad_rel_err_f32"][worst],
                          "vs_one_device": err[worst]})
        checks = {"finite": all(math.isfinite(x) for x in [out["loss"], out["last_loss"]]
                                + list(err.values()) + list(err32.values())),
                  "loss": lay["loss_rel_err"] <= TRAIN_PAR_LOSS_TOL,
                  "grads": excess[worst] <= TRAIN_PAR_GRAD_TOL,
                  "replicated_equal": out["replicated_equal"],
                  "no_jax": out["ranks_importing_jax"] == []}
        lay["checks"] = checks
        rec["layouts"][name] = lay
        ok = ok and all(checks.values())
        print(f"train parallel 1B {name} {axes}: loss {out['loss']:.5f} (one device "
              f"{ref['loss']:.5f}, rel {lay['loss_rel_err']:.2e}); gradients against one "
              f"device in f32 {json.dumps({k: round(v, 5) for k, v in err32.items()})} (one "
              f"bf16 device: worst leaf {worst} {ref['grad_rel_err_f32'][worst]:.2e}, this "
              f"layout {err32[worst]:.2e}, against one bf16 device {err[worst]:.2e}); "
              f"{out['ms_per_step']:.1f} ms a step (one device {ref['ms_per_step']:.1f}); "
              f"collectives a step {json.dumps(out['collectives_per_step'])}; peak GiB "
              f"{ {r: round(b / 2**30, 2) for r, b in out['peak_bytes'].items()} }; "
              f"{lay['wall_s']:.1f} s; checks {checks}", flush=True)
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["ok"] = ok
    print(f"train parallel 1B: {rec['phase_s']:.1f} s | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def start_train_parallel():
    """Start phase 6n in a child (this script with --train-parallel-child)
    in a temporary directory; finish_train_parallel() collects it."""
    cwd = tempfile.TemporaryDirectory()
    out, log = Path(cwd.name) / "train_parallel.json", Path(cwd.name) / "log.txt"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--train-parallel-child", str(out)],
            cwd=cwd.name, env=_child_env(), stdout=f, stderr=subprocess.STDOUT)
    return child, cwd, out, log, t0


def finish_train_parallel(started) -> tuple[bool, dict]:
    child, cwd, out, log, t0 = started
    try:
        child.wait(timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
    try:
        text = log.read_text()
        rec = json.loads(out.read_text()) if out.exists() else {}
    finally:
        cwd.cleanup()
    rec["rc"], rec["process_wall_s"] = child.returncode, time.perf_counter() - t0
    ok = child.returncode == 0 and bool(rec.get("ok"))
    print(text[-12000:], end="", flush=True)
    print(f"train parallel 1B child: rc {child.returncode}, "
          f"{rec['process_wall_s']:.1f} s | ok={ok}", flush=True)
    return ok, rec


def hidden_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """A K=4 hidden-transfer head trained on the resident 8B bf16 target
    (train_hidden_transfer, 10 steps at 4 x 512 on the distill stream),
    saved, and served by build_local_backend(spec_arm="hidden",
    spec_draft_checkpoint=...): speculative generate on two path B prompts
    behind the prefix. See the module doc, phase 6j."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.train.hidden import (
        restore_hidden_transfer,
        train_hidden_transfer,
    )

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods[:SPEC_PROMPTS]]
    prompts = [it.suffix_ids for it in items]
    prefix = items[0].prefix_ids
    books, record = _step_books()
    rec = {"k": HIDDEN_K, "steps": HIDDEN_STEPS, "batch": [HIDDEN_BATCH, HIDDEN_SEQ]}
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        ht, loss = train_hidden_transfer(
            params, cfg, k=HIDDEN_K, steps=HIDDEN_STEPS, batch_size=HIDDEN_BATCH,
            seq_len=HIDDEN_SEQ, seed=0, out_dir=d, log_every=0,
            on_step=lambda step, l, head: record(step, l, [head["transfer"]]))
        rec["peak_above_start_gib"] = (torch.cuda.max_memory_allocated() - start) / 2**30
        restored = restore_hidden_transfer(d, cfg, HIDDEN_K, device="cuda")
        rec["restored_equal"] = torch.equal(restored["transfer"], ht["transfer"])
        del restored
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        served = build_local_backend(
            cfg.name, device="cuda", seed=0, temperature=0.0, request_timeout_s=600.0,
            prewarm_idle_delay_s=NO_PREWARM_S, spec_enabled=True, spec_arm="hidden",
            spec_draft_checkpoint=d, spec_k=HIDDEN_K, spec_disable_threshold=0.0)
        rec["backend_s"] = time.perf_counter() - t0
    try:
        eng = served.engine
        # the head serves the target it was trained on (init_params seed 0)
        rec["same_target"] = torch.equal(eng.params["embed"], params["embed"])
        rec["served_equal"] = torch.equal(eng.spec.hidden_head["transfer"], ht["transfer"])

        def drive():
            eng.set_prefix(prefix)
            return _spec_drive(eng, eng.spec, prompts)

        r, _pause = served.run_quiesced(drive, 600.0)
    finally:
        served.close()
    del served, ht
    gc.collect()
    torch.cuda.empty_cache()
    r["ok"] = _spec_ok(r)
    r["identical_to_plain"] = all(p["first_divergence"] is None for p in r["prompts"])
    ms = _warm_ms(books["step_s"])
    rec.update(losses=books["loss"], grad_norms=books["grad_norm"], final_loss=loss,
               step_ms=[1000.0 * s for s in books["step_s"]], ms_per_step=ms, serve=r)
    finite = all(math.isfinite(x) for x in books["loss"] + books["grad_norm"])
    checks = {"finite": finite, "restored_equal": rec["restored_equal"],
              "served_equal": rec["served_equal"], "same_target": rec["same_target"],
              "spec": r["ok"]}
    rec["checks"] = checks
    ok = all(checks.values())
    print(f"hidden 8B: K={HIDDEN_K} head, {HIDDEN_STEPS} steps of {HIDDEN_BATCH} x "
          f"{HIDDEN_SEQ}: losses {[round(x, 4) for x in books['loss']]}, {ms:.1f} ms a "
          f"step (steps 2-{HIDDEN_STEPS}), +{rec['peak_above_start_gib']:.2f} GiB peak; "
          f"served backend built in {rec['backend_s']:.1f} s; acceptance "
          f"{r['acceptance_rate']:.3f}, {r['ms_per_token']:.2f} ms a token (plain "
          f"{r['plain_ms_per_token']:.2f}), {r['ms_per_round']:.2f} ms a round, "
          f"{r['verify_runs']} verify runs, K1 {r['launches']['K1']} (expected "
          f"{r['k1_expected']}), identical to plain {r['identical_to_plain']} (first "
          f"divergence {[p['first_divergence'] for p in r['prompts']]}) | {_smi()} | "
          f"checks {checks} ok={ok}", flush=True)
    return ok, rec


# --------------------------------------------------------------- cli complete
COMPLETE_MODEL = "llama-3.1-8b-instruct"
COMPLETE_NEW_TOKENS = 64
# The child of the cli complete phase: `cli complete` at argv[1]'s model,
# greedy, 64 new tokens, on a prompt longer than the config's largest
# prefill bucket (8,192) by more than one prefix chunk (2,048), so its head
# goes through set_prefix's chunked path. Its K1/K2 counts are zeroed
# before cli.main and read after; the chunked prefills and the fused
# chunks' steps are booked. Last line: one JSON object of them.
COMPLETE_CHILD = r"""
import json, sys, time
import torch
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.engine import engine as engine_mod
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

prompt = " ".join(f"node-{i:04d} cpu={i * 37 % 100}% mem={i * 53 % 100}%" for i in range(440))
chunked, fused, generated = [], [], []
chunk = engine_mod.InferenceEngine._prefill_prefix_chunked
book = engine_mod.InferenceEngine._book_fused_steps
generate = engine_mod.InferenceEngine.generate

def counted_chunked(self, ids, seed=None):
    chunked.append(len(ids))
    return chunk(self, ids, seed=seed)

def counted_book(self, handles):
    n = book(self, handles)
    fused.append(n)
    return n

def booked_generate(self, ids, max_new_tokens=200):
    fin = generate(self, ids, max_new_tokens)
    generated.append({"tokens": len(fin.token_ids), "token_ids": fin.token_ids,
                      "text": fin.text})
    return fin

engine_mod.InferenceEngine._prefill_prefix_chunked = counted_chunked
engine_mod.InferenceEngine._book_fused_steps = counted_book
engine_mod.InferenceEngine.generate = booked_generate
pa.reset_launch_counts()
t0 = time.perf_counter()
rc = cli.main(["complete", "--model", sys.argv[1], "--max-new-tokens", sys.argv[2],
               "--temperature", "0", "--prompt", prompt])
print()
print(json.dumps({"launches": {"K1": pa.flash_prefix_attention_parts.launches,
                               "K2": pa.flash_causal_attention_parts.launches},
                  "prompt_bytes": len(prompt.encode()), "chunked_prefix": chunked,
                  "fused_steps": fused, "generated": generated,
                  "wall_s": time.perf_counter() - t0,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
sys.exit(rc)
"""


def start_complete():
    """Start the cli complete child (COMPLETE_CHILD) in a temporary
    directory; finish_complete() collects it."""
    cwd = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", COMPLETE_CHILD, COMPLETE_MODEL, str(COMPLETE_NEW_TOKENS)],
        cwd=cwd.name, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return child, cwd, t0


def finish_complete(started) -> tuple[bool, dict]:
    """`python -m k8s_llm_scheduler_tpu_torch.cli complete` at 8B in a child
    process: exit 0, the prompt's head through the chunked prefix path, K1
    and K2 launched in the child, the tail decoded through the fused
    runtime (1-64 tokens generated), and what the command printed exactly
    the completion's text as generate() returned it (the child records it
    with its token ids; random weights may give an empty-looking text);
    wall time and the child's peak memory."""
    child, cwd, t0 = started
    try:
        # tp 8B's swap may have waited for the child already
        out, err = getattr(child, "smoke_output", None) or child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        cwd.cleanup()
    lines = out.rstrip("\n").splitlines()
    try:
        report = json.loads(lines[-1])
    except (ValueError, IndexError):
        report = {}
    gen = (report.get("generated") or [{}])[-1]
    # stdout: the command's print of the text, the child's empty line, the
    # report (read as text: universal newlines)
    text = str(gen.get("text")).replace("\r\n", "\n").replace("\r", "\n")
    printed = "text" in gen and out == text + "\n\n" + lines[-1] + "\n"
    rec = {"model": COMPLETE_MODEL, "rc": child.returncode,
           "process_wall_s": time.perf_counter() - t0, "text_printed": printed, **report}
    launches = report.get("launches") or {}
    ok = (child.returncode == 0 and printed
          and 1 <= gen.get("tokens", 0) <= COMPLETE_NEW_TOKENS
          and bool(report.get("chunked_prefix"))
          and launches.get("K1", 0) > 0 and launches.get("K2", 0) > 0
          and sum(report.get("fused_steps") or ()) > 0)
    print(f"cli complete: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    if not ok:
        print(err[-6000:], file=sys.stderr, flush=True)
    return ok, rec


# ------------------------------------------------------- cli verify, cli run
def start_verify():
    """Start `python -m k8s_llm_scheduler_tpu_torch.cli verify` in a process
    of its own, in a temporary directory (no config file: this machine may
    have no PyYAML); finish_verify() collects it. It runs beside the run
    phase's child: its model is TINY."""
    cwd = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "verify"],
        cwd=cwd.name, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return child, cwd, t0


def finish_verify(started) -> tuple[bool, dict]:
    """The cli verify child: every check must pass, exit 0."""
    child, cwd, t0 = started
    try:
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        cwd.cleanup()
    lines = [ln.strip() for ln in out.splitlines() if ln.strip().startswith("[")]
    rec = {"rc": child.returncode, "wall_s": time.perf_counter() - t0, "checks": lines}
    ok = child.returncode == 0 and lines and not any(ln.startswith("[FAIL]") for ln in lines)
    for ln in lines:
        print(f"cli verify: {ln}", flush=True)
    print(f"cli verify: rc={child.returncode} in {rec['wall_s']:.1f} s ok={ok}", flush=True)
    if not ok:
        print(out[-4000:], err[-4000:], file=sys.stderr, flush=True)
    return bool(ok), rec


RUN_MODEL = "llama-3.1-8b-instruct"
RUN_NODES = 32
RUN_PODS = 24
RUN_SHAPES = 12  # 12 leaders against 8 slots: two waves, 12 single-flight followers
# Once those are bound, 8 pods of 8 new shapes: one R=8 wave at the suffix
# bucket the first burst captured (the snapshot's delta rides the prefix),
# so the profiler books a warm wave.
RUN_SECOND_PODS = 8
RUN_DEADLINE_S = 600.0
# The run phase's SLO objective (slo.objectives, which no environment
# variable sets): failed binds over decisions.
RUN_SLO_OBJECTIVES = [{"name": "bind_errors", "kind": "error_rate",
                       "numerator": "failed_bindings", "denominator": "total_scheduled",
                       "budget": 0.01}]
# The operating plane's switches, as the run phase's child gets them.
RUN_PLANE_ENV = {"DURABILITY_ENABLED": "true", "METRICS_ENABLED": "true",
                 "METRICS_PORT": "0", "SLO_ENABLED": "true", "SLO_INTERVAL_S": "1.0",
                 "OBS_SAMPLER_INTERVAL_S": "0.5"}
# The child of the run phase: `cli run` against the wire fake at argv[1],
# at the config's defaults (temperature 0.3, packed admission and delta
# prompts on) with LLM_MODEL from its environment, the operating plane's
# switches on (RUN_PLANE_ENV, the journal in its directory) and the SLO
# objectives of SMOKE_SLO_OBJECTIVES. It writes its metrics port to the
# file metrics_port. Its K1/K2 counts are zeroed before cli.main and read
# after it; each harvest_wave return and each parsed decision is booked.
# Last line: one JSON object of them.
RUN_CHILD = r"""
import json, os, sys, time
from pathlib import Path
import torch
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as config_mod
from k8s_llm_scheduler_tpu_torch.cluster import httpapi
from k8s_llm_scheduler_tpu_torch.engine import engine as engine_mod
from k8s_llm_scheduler_tpu_torch.engine import local as local_mod
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

httpapi.set_active_config(sys.argv[1])
harvests, parsed = [], []
harvest = engine_mod.InferenceEngine.harvest_wave
parse = local_mod.LocalLLMBackend._parse

def timed_harvest(self, handle):
    fins = harvest(self, handle)
    harvests.append({"t": time.perf_counter(), "submitted": handle.submitted_at,
                     "rows": handle.n, "R": handle.geo_key[0], "cold": handle.cold_compile,
                     "model_calls": handle.iters})
    return fins

def booked_parse(self, text):
    try:
        d = parse(self, text)
    except Exception as exc:
        parsed.append({"ok": False, "error": str(exc)[:200]})
        raise
    parsed.append({"ok": True, "node": d.selected_node})
    return d

start_metrics = cli._start_metrics

def port_file(*args, **kwargs):
    server, sampler = start_metrics(*args, **kwargs)
    Path("metrics_port").write_text(str(server.port))
    return server, sampler

engine_mod.InferenceEngine.harvest_wave = timed_harvest
local_mod.LocalLLMBackend._parse = booked_parse
cli._start_metrics = port_file
config_mod.DEFAULTS["slo"]["objectives"] = json.loads(os.environ["SMOKE_SLO_OBJECTIVES"])
pa.reset_launch_counts()
rc = cli.main(["run"])
launches = {"K1": pa.flash_prefix_attention_parts.launches,
            "K2": pa.flash_causal_attention_parts.launches}
print(json.dumps({"launches": launches, "harvests": harvests, "parsed": parsed,
                  "temperature": cli.load_config().get("llm.temperature"),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
sys.exit(rc)
"""


def _scrape_plane(port_path: Path, timeout_s: float = 30.0) -> dict:
    """/metrics, /debug/profile and /debug/slo of the run phase's child,
    its port read from the file it wrote. {} when it never wrote one."""
    import urllib.request

    end = time.perf_counter() + timeout_s
    while not port_path.exists() and time.perf_counter() < end:
        time.sleep(0.1)
    if not port_path.exists():
        return {}
    port = int(port_path.read_text())
    out = {}
    for path in ("/metrics", "/debug/profile", "/debug/slo"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            out[path] = resp.read().decode()
    return out


def _plane_summary(scraped: dict) -> tuple[bool, dict]:
    """The run phase's operating plane from its scrapes: the wave segments
    and device_compute with the event-timed device ms beside it, mfu_decode
    with the peak it used, the flow gauges, the SLO engine's evaluations.
    ok: every record's segments (waves, packs, fused harvests) sum to its
    wall, they cover at least 95% of the waves' wall (all of them, and the
    warm ones, which carry the MFU decomposition), each wave's timed device
    span lies inside its wall, and no MFU share is above 1."""
    if not scraped:
        print("run: the child's metrics server never answered | ok=False", flush=True)
        return False, {}
    from k8s_llm_scheduler_tpu_torch.observability.profiler import SEGMENTS

    prof = json.loads(scraped["/debug/profile"])
    slo = json.loads(scraped["/debug/slo"])
    gauges = {}
    for line in scraped["/metrics"].splitlines():
        name, _, value = line.partition(" ")
        if name.endswith(("dispatches_per_decision", "prefill_tokens_per_decision")):
            gauges[name] = float(value)
    records = list(prof["ring"])
    for family in ("packs", "fused", "spec", "persistent"):
        records += (prof.get(family) or {}).get("ring", [])
    sums_ok = all(abs(sum(r["segments_ms"].values()) - r["wall_ms"]) <= 1e-6 * max(
        r["wall_ms"], 1.0) for r in records)
    # every wave's coverage, the cold ones (capture) included; the
    # snapshot's coverage_frac and mfu cover the warm ones
    wall = sum(r["wall_ms"] for r in prof["ring"])
    covered = sum(r["wall_ms"] - r["segments_ms"]["unattributed"] for r in prof["ring"])
    mfu = prof.get("mfu") or {}
    shares = [mfu.get("decode"), mfu.get("device"), mfu.get("busy_frac"),
              *(mfu.get("loss") or {}).values(), (prof.get("fused") or {}).get("mfu_decode")]
    shares = [x for x in shares if x is not None]
    rec = {
        "device_kind": prof["device_kind"], "peak_bf16_tflops": prof["peak_bf16_tflops"],
        "waves_profiled": prof["waves_profiled"],
        "warm_waves_in_window": prof["warm_waves_in_window"],
        "wall_ms_total": prof["wall_ms_total"],
        "segments_ms_total": prof["segments_ms_total"],
        "device_compute_ms_total": prof["device_compute_ms_total"],
        "device_event_ms_total": prof.get("device_event_ms_total"),
        "coverage_frac": prof["coverage_frac"],
        "coverage_frac_all_waves": covered / wall if wall > 0 else 0.0, "mfu": mfu,
        "achieved_tflops": prof["achieved_tflops"],
        "dispatches_per_decision": prof.get("dispatches_per_decision"),
        "prefill_tokens_per_decision": prof.get("prefill_tokens_per_decision"),
        "metrics_gauges": gauges,
        "packs_profiled": (prof.get("packs") or {}).get("packs_profiled", 0),
        "fused_profiled": (prof.get("fused") or {}).get("harvests_profiled", 0),
        "records": len(records), "segments_sum_to_wall": sums_ok,
        "slo_evaluations": slo["evaluations"], "slo_tripped": slo["tripped"],
        "wave_segments": [{"wall_ms": r["wall_ms"], "cold": r["cold_compile"],
                           "device_compute_ms": r["device_compute_ms"],
                           "device_event_ms": r.get("device_event_ms"),
                           **{k: r["segments_ms"][k] for k in SEGMENTS}} for r in prof["ring"]],
    }
    warm = rec["warm_waves_in_window"] > 0
    # the event-timed device span of a wave lies inside its wall
    events_ok = all(0 < r["device_event_ms"] <= r["wall_ms"]
                    for r in prof["ring"] if "device_event_ms" in r)
    ok = (sums_ok and events_ok and rec["waves_profiled"] > 0
          and rec["coverage_frac_all_waves"] >= 0.95
          and (not warm or (rec["coverage_frac"] >= 0.95 and bool(mfu)))
          and all(0 <= x <= 1 for x in shares) and rec["slo_evaluations"] > 0)
    print("run: profile " + json.dumps({k: rec[k] for k in (
        "segments_ms_total", "device_compute_ms_total", "device_event_ms_total",
        "wall_ms_total", "coverage_frac", "coverage_frac_all_waves",
        "mfu", "peak_bf16_tflops", "device_kind", "dispatches_per_decision",
        "prefill_tokens_per_decision", "metrics_gauges", "waves_profiled",
        "warm_waves_in_window", "packs_profiled", "fused_profiled", "segments_sum_to_wall",
        "slo_evaluations")}) + f" | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def run_phase() -> tuple[bool, dict]:
    """`cli run` at full width on the card against the wire-level fake API
    server: the port's WireFakeK8s holding synthetic_nodes(RUN_NODES), a
    child process (`RUN_CHILD`, in a temporary directory, KUBECONFIG at a
    path that does not exist, the API server set with
    httpapi.set_active_config, LLM_MODEL=RUN_MODEL, the config's default
    temperature 0.3) that runs `cli.main(["run"])`; then RUN_PODS pending
    pods of RUN_SHAPES shapes created over the wire, and once they are
    bound RUN_SECOND_PODS more of new shapes. Once the fake shows
    every pod bound (deadline RUN_DEADLINE_S) the child gets SIGINT; it must
    exit 0 with the stats JSON. Fails unless every pod is bound to a node
    that is ready and feasible for it, no decision fell back or failed to
    parse, and K1 and K2 launched in the child."""
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_nodes

    nodes = synthetic_nodes(RUN_NODES)
    srv = WireFakeK8s()
    for n in nodes:
        srv.add_node(n.name, cpu=str(int(n.available_cpu_cores)),
                     memory=f"{int(n.available_memory_gb)}Gi", pods=str(n.max_pods),
                     labels=n.labels)
    first = pod_burst(RUN_PODS, distinct_shapes=RUN_SHAPES)
    n_shapes = RUN_SHAPES + RUN_SECOND_PODS
    second = [dataclasses.replace(p, name=f"second-pod-{i}") for i, p in enumerate(
        pod_burst(n_shapes, distinct_shapes=n_shapes)[RUN_SHAPES:])]
    pods = first + second
    rec: dict = {"model": RUN_MODEL, "nodes": RUN_NODES, "pods": len(pods),
                 "shapes": n_shapes}
    scraped: dict = {}
    with tempfile.TemporaryDirectory() as cwd:
        env = _child_env(KUBECONFIG=str(Path(cwd) / "no-kubeconfig"), LLM_MODEL=RUN_MODEL,
                         DURABILITY_JOURNAL_DIR=str(Path(cwd) / "journal"),
                         SMOKE_SLO_OBJECTIVES=json.dumps(RUN_SLO_OBJECTIVES), **RUN_PLANE_ENV)
        env.pop("KUBERNETES_SERVICE_HOST", None)
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", RUN_CHILD, srv.base_url], cwd=cwd,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
        try:
            # the child's watch must be up before the pods arrive: it lists
            # the pods, then watches
            end = time.perf_counter() + RUN_DEADLINE_S
            while (child.poll() is None and time.perf_counter() < end
                   and not any("watch=true" in r for r in srv.request_log)):
                time.sleep(0.1)
            rec["start_s"] = time.perf_counter() - t0
            pending_at, bound_at = {}, {}
            for burst in (first, second):
                for pod in burst:
                    req = pod.container_requests[0]
                    srv.add_pod(pod.name, requests=dict(req), priority=pod.priority)
                    pending_at[pod.name] = time.perf_counter()
                while (child.poll() is None and time.perf_counter() < end
                       and len(bound_at) < len(pending_at)):
                    now = time.perf_counter()
                    for _, name, _node in list(srv.bindings):
                        bound_at.setdefault(name, now)
                    time.sleep(0.01)
            if child.poll() is None:
                time.sleep(1.5)  # an SLO evaluation and a sample after the last bind
                scraped = _scrape_plane(Path(cwd) / "metrics_port")
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            out, err = child.communicate(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
            srv.close()
    placed = {name: node for _, name, node in srv.bindings}
    # stdout: the stats JSON (indented), then the child's one-line report
    lines = out.strip().splitlines()
    try:
        report = json.loads(lines[-1])
        stats = json.loads("\n".join(lines[:-1]))
    except (ValueError, IndexError):
        report, stats = {}, {}
    node_by_name = {n.name: n for n in nodes}
    feasible = all(
        placed.get(p.name) in {n.name for n in feasible_nodes(raw_pod_to_spec(p), nodes)}
        and node_by_name[placed[p.name]].is_ready for p in pods if p.name in placed)
    harvests = report.get("harvests", [])
    waves = [h for h in harvests if h["rows"]]
    rec.update({
        "rc": child.returncode, "wall_s": time.perf_counter() - t0,
        "bound": len(placed), "feasible": feasible,
        "pending_to_bound_s": {name: bound_at[name] - pending_at[name] for name in bound_at},
        "launches": report.get("launches"), "peak_gib": report.get("peak_gib"),
        "temperature": report.get("temperature"),
        "parsed": len(report.get("parsed", [])),
        "unparsed": sum(not r["ok"] for r in report.get("parsed", [])),
        "waves": [{k: h[k] for k in ("rows", "R", "cold", "model_calls")} for h in waves],
        "wave_wall_s": [h["t"] - h["submitted"] for h in waves],
        "between_harvests_s": [b["t"] - a["t"] for a, b in zip(waves, waves[1:])],
        "llm_decisions": stats.get("llm_decisions"),
        "fallback_decisions": stats.get("fallback_decisions"),
        "client_fallbacks": (stats.get("client") or {}).get("fallback_decisions"),
        "total_scheduled": stats.get("total_scheduled"),
    })
    plane_ok, rec["plane"] = _plane_summary(scraped)
    times = sorted(rec["pending_to_bound_s"].values())
    ok = (child.returncode == 0 and len(placed) == len(pods) and feasible
          and rec["fallback_decisions"] == 0 and rec["client_fallbacks"] == 0
          and rec["parsed"] > 0 and rec["unparsed"] == 0
          and bool(rec["launches"]) and rec["launches"]["K1"] > 0
          and rec["launches"]["K2"] > 0 and plane_ok)
    for name in sorted(rec["pending_to_bound_s"], key=rec["pending_to_bound_s"].get):
        print(f"  run: {name} pending -> bound {rec['pending_to_bound_s'][name]:.3f} s "
              f"on {placed.get(name)}", flush=True)
    print(f"run: cli run ({RUN_MODEL}, temperature {rec['temperature']}) over HTTP bound "
          f"{len(placed)} of {len(pods)} pods ({n_shapes} shapes, two bursts) in "
          f"{len(waves)} waves {rec['waves']}; pending -> bound first "
          f"{times[0] if times else float('nan'):.3f} s, last "
          f"{times[-1] if times else float('nan'):.3f} s; between the waves' harvests "
          f"{rec['between_harvests_s']} s; {rec['llm_decisions']} LLM decisions, "
          f"{rec['unparsed']} unparsed, fallbacks {rec['fallback_decisions']}; K1 / K2 "
          f"launches {rec['launches']}; child peak {rec['peak_gib']} GiB, rc "
          f"{child.returncode}, started in {rec['start_s']:.1f} s | {_smi()} | ok={ok}",
          flush=True)
    if not ok:
        print(err[-6000:], file=sys.stderr, flush=True)
    return ok, rec


# ------------------------------------------------------- journal restart phase
JOURNAL_NODES = 4
JOURNAL_PODS = 8  # 4 created before the kill, 4 while the child is dead
JOURNAL_DEADLINE_S = 300.0
# `cli run` (the config's defaults, LLM_MODEL and the journal from the
# environment) against the wire fake at argv[1].
JOURNAL_CHILD = r"""
import sys
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.cluster import httpapi
httpapi.set_active_config(sys.argv[1])
sys.exit(cli.main(["run"]))
"""


def journal_restart_phase() -> tuple[bool, dict]:
    """Crash and restart of `cli run` on one decision journal: a TINY child
    over the port's WireFakeK8s with durability.enabled (fsync "intent")
    is SIGKILLed once the first of JOURNAL_PODS // 2 pods is bound; the
    other half is created while it is dead; a second child restarts on the
    same journal (recovery, then the watch from the journaled
    resourceVersion) and gets SIGINT once every pod is bound. Fails unless
    each pod is bound exactly once to a ready node (one 201 a pod, and no
    binding refused as already bound: a pod decided twice would meet a
    409), the second child exits 0, and `cli journal fsck` exits 0 with the
    journal clean and no lifecycle open. A binding POST the SIGKILL tore
    mid-request reaches the fake without its body and gets no answer; the
    binding POSTs the fake logged are reported beside the answers."""
    from collections import Counter

    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_nodes

    nodes = synthetic_nodes(JOURNAL_NODES)
    srv = WireFakeK8s()
    for n in nodes:
        srv.add_node(n.name, cpu=str(int(n.available_cpu_cores)),
                     memory=f"{int(n.available_memory_gb)}Gi", pods=str(n.max_pods),
                     labels=n.labels)
    answers = []  # the status code of every answered binding POST
    send = srv._send_json

    def answered(handler, code, obj):
        if handler.command == "POST" and handler.path.endswith("/bindings"):
            answers.append(code)
        send(handler, code, obj)

    srv._send_json = answered
    pods = pod_burst(JOURNAL_PODS, distinct_shapes=JOURNAL_PODS)
    half = JOURNAL_PODS // 2
    rec: dict = {"model": "tiny", "nodes": JOURNAL_NODES, "pods": JOURNAL_PODS}
    t0 = time.perf_counter()
    end = t0 + JOURNAL_DEADLINE_S
    with tempfile.TemporaryDirectory() as cwd:
        journal = Path(cwd) / "journal"
        env = _child_env(KUBECONFIG=str(Path(cwd) / "no-kubeconfig"), LLM_MODEL="tiny",
                         DURABILITY_ENABLED="true", DURABILITY_JOURNAL_DIR=str(journal))
        env.pop("KUBERNETES_SERVICE_HOST", None)
        logs = [Path(cwd) / "first.log", Path(cwd) / "second.log"]

        def start(log):
            with open(log, "w") as fh:
                return subprocess.Popen([sys.executable, "-c", JOURNAL_CHILD, srv.base_url],
                                        cwd=cwd, env=env, stdout=fh, stderr=subprocess.STDOUT)

        def wait(child, done):
            while child.poll() is None and time.perf_counter() < end and not done():
                time.sleep(0.01)

        def add(burst):
            for pod in burst:
                srv.add_pod(pod.name, requests=dict(pod.container_requests[0]),
                            priority=pod.priority)

        child = start(logs[0])
        try:
            wait(child, lambda: any("watch=true" in r for r in srv.request_log))
            add(pods[:half])
            wait(child, lambda: len(srv.bindings) >= 1)
            child.kill()  # SIGKILL: no shutdown path runs
            child.wait(timeout=60)
            rec["bound_at_kill"] = len(srv.bindings)
            add(pods[half:])
            n_log = len(srv.request_log)
            child = start(logs[1])
            wait(child, lambda: len(srv.bindings) >= len(pods))
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        fsck = subprocess.run(
            [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "journal", "fsck",
             "--dir", str(journal)], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120)
        second_log = logs[1].read_text()
    srv.close()
    posts = sum(r.startswith("POST ") and r.endswith("/bindings") for r in srv.request_log)
    per_pod = Counter(name for _, name, _ in srv.bindings)
    try:
        report = json.loads(fsck.stdout)
    except ValueError:
        report = {}
    recovery = next((ln[ln.index("journal recovery:"):] for ln in second_log.splitlines()
                     if "journal recovery:" in ln), None)
    resumed = [r for r in srv.request_log[n_log:] if "watch=true" in r
               and "resourceVersion=" in r and "/pods" in r]
    ready = {n.name for n in nodes if n.is_ready}
    rec.update({
        "wall_s": time.perf_counter() - t0, "rc": child.returncode,
        "bound": len(per_pod), "binding_posts": posts,
        "binding_answers": dict(sorted(Counter(answers).items())),
        "bound_more_than_once": sorted(p for p, c in per_pod.items() if c > 1),
        "on_ready_nodes": all(node in ready for _, _, node in srv.bindings),
        "recovery": recovery, "watch_resumed_from_rv": bool(resumed),
        "fsck_rc": fsck.returncode, "fsck": {k: report.get(k) for k in (
            "ok", "torn_bytes", "open_decisions", "open_intents", "acked", "last_rv")},
    })
    ok = (rec["rc"] == 0 and rec["bound"] == len(pods)
          and rec["binding_answers"] == {201: len(pods)}
          and not rec["bound_more_than_once"] and rec["on_ready_nodes"]
          and recovery is not None and fsck.returncode == 0 and report.get("ok") is True
          and report.get("open_decisions") == 0 and report.get("open_intents") == 0
          and report.get("acked") == len(pods))
    print(f"journal restart: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    if not ok:
        print(second_log[-6000:], fsck.stdout[-2000:], fsck.stderr[-2000:],
              file=sys.stderr, flush=True)
    return ok, rec


# --------------------------------------------------------------- sampled phase
SAMPLED_TEMPERATURE = 0.3  # the config's llm.temperature


def sampled_phase() -> tuple[bool, dict]:
    """Sampled decisions replayed as CUDA graphs: a TINY engine on the card
    (graphs on, temperature 0.3, the decision grammar over 4 nodes) runs a
    wave of 8 copies of one prompt to capture its geometry, then two more:
    the 16 replayed streams must not all be equal (the generator
    registered with the graphs draws afresh at every replay), and each
    must parse and name one of the nodes."""
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

    nodes = synthetic_nodes(4)
    backend = build_local_backend("tiny", device="cuda", temperature=SAMPLED_TEMPERATURE,
                                  request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)
    try:
        eng = backend.engine
        item = backend._prepare_item(fixture_pods(1)[0], nodes)
        backend._switch_group(item)
        prompts = [item.suffix_ids] * eng.max_slots
        eng.decide_wave(prompts, backend.max_new_tokens)  # captures the geometry
        replays0 = eng._graphs.replays
        streams = [f.token_ids for _ in range(2)
                   for f in eng.decide_wave(prompts, backend.max_new_tokens)]
        replayed = eng._graphs.replays - replays0
        texts = [eng.tokenizer.decode(ids) for ids in streams]
    finally:
        backend.close()
    names = {n.name for n in nodes}
    parsed = [parse_decision_json(t) for t in texts]
    valid = all(p is not None and p["selected_node"] in names for p in parsed)
    distinct = len({tuple(ids) for ids in streams})
    rec = {"streams": len(streams), "distinct": distinct, "valid": valid,
           "replays": replayed,
           "nodes": sorted({p["selected_node"] for p in parsed if p is not None})}
    ok = valid and distinct > 1 and replayed > 0
    print(f"sampled: TINY at temperature {SAMPLED_TEMPERATURE}, graphs: {distinct} distinct of "
          f"{len(streams)} replayed streams of one prompt ({replayed} replays), all parse to "
          f"a node={valid}, nodes {rec['nodes']} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------------ checkpoint phase
def _write_safetensors(path: Path, tensors: dict) -> None:
    """A safetensors file in the format's own few lines: 8-byte header
    length, JSON header, raw little-endian bytes."""
    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        dtype = {torch.bfloat16: "BF16", torch.float32: "F32"}[t.dtype]
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _tiny_hf_tensors(cfg, seed=0) -> dict:
    """A TINY HF-layout checkpoint ([out, in] projections) from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hd, D, F = cfg.head_dim, cfg.d_model, cfg.d_ff

    def w(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    out = {"model.embed_tokens.weight": w(cfg.vocab_size, D, scale=0.02),
           "model.norm.weight": (1 + w(D, scale=0.1).float()).to(torch.bfloat16)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (1 + w(D, scale=0.1).float()).to(torch.bfloat16),
            p + "self_attn.q_proj.weight": w(cfg.n_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.k_proj.weight": w(cfg.n_kv_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.v_proj.weight": w(cfg.n_kv_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.o_proj.weight": w(D, cfg.n_heads * hd, scale=D ** -0.5),
            p + "post_attention_layernorm.weight": (1 + w(D, scale=0.1).float()).to(
                torch.bfloat16),
            p + "mlp.gate_proj.weight": w(F, D, scale=D ** -0.5),
            p + "mlp.up_proj.weight": w(F, D, scale=D ** -0.5),
            p + "mlp.down_proj.weight": w(D, F, scale=F ** -0.5),
        })
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = w(cfg.vocab_size, D, scale=D ** -0.5)
    return out


def checkpoint_phase() -> tuple[bool, dict]:
    """A TINY HF safetensors checkpoint from a seed (written by
    _write_safetensors; vocab widened for the builtin numeric tokenizer)
    loaded by build_local_backend(checkpoint_path=...) on the card and on
    the CPU, bf16 and int8: a suffix prefill's logits on the card within
    5e-2 of the largest logit of the same checkpoint loaded on the CPU,
    and one greedy decision on the card that parses and names a feasible
    node."""
    import torch

    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_suffix_dense
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    _, cfg = build_builtin_tokenizer("numeric", TINY)
    nodes = synthetic_nodes(4)
    pod = fixture_pods(1)[0]
    rec, ok = {"vocab": cfg.vocab_size}, True
    with tempfile.TemporaryDirectory() as d:
        _write_safetensors(Path(d) / "model.safetensors", _tiny_hf_tensors(cfg))
        for quant in (None, "int8"):
            logits, t_load = {}, {}
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                b = build_local_backend("tiny", device=dev, checkpoint_path=d,
                                        tokenizer_name="numeric", quantize=quant,
                                        temperature=0.0, request_timeout_s=600.0)
                t_load[dev] = time.perf_counter() - t0
                try:
                    eng = b.engine
                    item = b._prepare_item(pod, nodes)
                    eng.set_prefix(item.prefix_ids)
                    toks = torch.tensor([item.suffix_ids], dtype=torch.int32, device=dev)
                    lg, _, _ = forward_prefill_suffix_dense(
                        eng.params, eng.cfg, toks,
                        torch.tensor([len(item.suffix_ids)], dtype=torch.int32, device=dev),
                        eng._prefix.k, eng._prefix.v,
                        torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev))
                    logits[dev] = lg.float().cpu()
                    if dev == "cuda":
                        decision = b.get_scheduling_decision(pod, nodes)
                finally:
                    b.close()
            err = (logits["cuda"] - logits["cpu"]).abs().max().item()
            scale = logits["cpu"].abs().max().item()
            names = {n.name for n in feasible_nodes(pod, nodes)}
            good = (bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
                    and decision.source == DecisionSource.LLM
                    and decision.selected_node in names)
            key = quant or "bf16"
            rec[key] = {"max_abs_err": err, "max_logit": scale, "load_s": t_load,
                        "decision": decision.selected_node, "ok": good}
            ok = ok and good
            print(f"checkpoint: TINY safetensors ({key}, vocab {cfg.vocab_size}, numeric "
                  f"tokenizer) loaded in {t_load['cuda']:.2f} s on the card; suffix prefill "
                  f"logits vs the CPU load err={err:.4g} (max |logit| {scale:.4g}); greedy "
                  f"decision {decision.selected_node} | {_smi()} | ok={good}", flush=True)
    return ok, rec


# ------------------------------------------------------------ rollout phases
SWAP_BURST = 4  # single decisions in flight while a swap waits at the barrier


def _leaf_ptrs(tree) -> list[int]:
    """data_ptr of every tensor leaf of a params tree, in walk order."""
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _leaf_ptrs(v)]
    return [tree.data_ptr()]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _grammar_argmax_check(eng, sfx, out) -> dict:
    """Each token of a constrained greedy output against one teacher-forced
    forward on the engine's weights (`_teacher_forced`): walking the
    grammar's sparse tables, a forced state's token must be the forced one,
    and a sampled state's token within SPEC_TF_TOL of the largest |logit|
    of the argmax over the tokens that state allows."""
    import torch

    logits, _ = _teacher_forced(eng, sfx, out)
    logits = logits.float().cpu()
    sp_tok, sp_next = eng._sp_tokens.cpu(), eng._sp_next.cpu()
    forced, forced_next = eng._forced.cpu(), eng._forced_next.cpu()
    st, worst, sampled, exact, ok = eng._dfa_start, 0.0, 0, 0, True
    for t, tok in enumerate(out):
        if st == eng._done_state:
            break
        if int(forced[st]) >= 0:
            ok = ok and tok == int(forced[st])
            st = int(forced_next[st])
            continue
        allowed = sp_tok[st] >= 0
        cand = sp_tok[st][allowed].long()
        row = logits[t, cand]
        hit = (cand == tok).nonzero()
        if not len(hit):
            ok = False
            break
        gap = float((row.max() - row[hit[0, 0]]) / row.abs().max().clamp_min(1e-30))
        worst, sampled = max(worst, gap), sampled + 1
        exact += int(cand[row.argmax()] == tok)
        ok = ok and gap <= SPEC_TF_TOL
        st = int(sp_next[st][allowed][hit[0, 0]])
    return {"sampled": sampled, "exact_argmax": exact, "max_gap_rel": worst, "ok": ok}


def swap_phase(engine, nodes, pods, make_staging, label: str) -> tuple[bool, dict]:
    """A hot swap of the served 8B weights on `engine` (its waves captured
    by an earlier phase): the batch of `pods` as one constrained greedy
    wave; a second random tree (make_staging(1)) built on the card as a
    staging tree; SWAP_BURST single decisions submitted and, with them in
    flight, the swap through run_quiesced (engine.swap_params copies the
    tree into the serving tensors at the wave barrier); the batch again on
    the new weights; then make_staging(0), the tree the engine was built
    with, swapped back the same way, and the batch once more. Fails unless
    no tensor of the served tree moved (data_ptr), every decision of the
    burst succeeded on a feasible node, the post-swap wave differs from the
    pre-swap one and each of its rows is the teacher-forced argmax of the
    new weights under the grammar (_grammar_argmax_check), the wave after
    the swap back replays the pre-swap tokens byte for byte, and those two
    waves replayed their captured programs without a capture."""
    import concurrent.futures as cf

    import torch
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    backend = LocalLLMBackend(engine, request_timeout_s=600.0,
                              prewarm_idle_delay_s=NO_PREWARM_S)
    items = [backend._prepare_item(p, nodes) for p in pods]

    def wave():
        books = _graph_books(engine)
        backend._switch_group(items[0])
        fins = engine.decide_wave([it.suffix_ids for it in items], backend.max_new_tokens)
        after = _graph_books(engine)
        return ([f.token_ids for f in fins], after["captures"] - books["captures"],
                after["replays"] - books["replays"])

    def install(tree):
        def fn():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.swap_params(tree)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000.0
        return fn

    gib = 2**30
    rec: dict = {"engine": label, "param_gib": _tree_bytes(engine.params) / gib}
    rec["bound_ms"] = 2 * _tree_bytes(engine.params) / PEAK_BYTES_PER_S * 1e3
    ptrs = _leaf_ptrs(engine.params)
    try:
        pre, _, _ = wave()
        torch.cuda.synchronize()
        rec["mem_before_gib"] = torch.cuda.memory_allocated() / gib
        staging = make_staging(1)
        torch.cuda.synchronize()
        rec["mem_staged_gib"] = torch.cuda.memory_allocated() / gib
        burst = [dataclasses.replace(p, name=f"swap-{p.name}") for p in pods[:SWAP_BURST]]
        with cf.ThreadPoolExecutor(SWAP_BURST) as pool:
            futs = [pool.submit(backend.get_scheduling_decision, p, nodes) for p in burst]
            time.sleep(0.05)  # the burst's wave is submitted before the swap waits
            rec["swap_install_ms"], pause_s = backend.run_quiesced(install(staging),
                                                                   timeout_s=600.0)
            decided = [f.result(timeout=600.0) for f in futs]
        rec["pause_ms"] = pause_s * 1000.0
        del staging
        gc.collect()
        torch.cuda.empty_cache()
        rec["mem_after_gib"] = torch.cuda.memory_allocated() / gib
        burst_ok = all(d.selected_node in {n.name for n in feasible_nodes(p, nodes)}
                       for p, d in zip(burst, decided))
        post, post_captures, post_replays = wave()
        checks = [_grammar_argmax_check(engine, it.suffix_ids, out)
                  for it, out in zip(items, post)]
        staging = make_staging(0)
        rec["swap_back_install_ms"], back_pause = backend.run_quiesced(install(staging),
                                                                       timeout_s=600.0)
        rec["swap_back_pause_ms"] = back_pause * 1000.0
        del staging
        gc.collect()
        torch.cuda.empty_cache()
        back, back_captures, back_replays = wave()
    finally:
        backend.close()
    rec.update({
        "ptrs_unchanged": _leaf_ptrs(engine.params) == ptrs,
        "burst_ok": burst_ok, "rows_changed": sum(a != b for a, b in zip(pre, post)),
        "argmax": {"ok": all(c["ok"] for c in checks),
                   "sampled": sum(c["sampled"] for c in checks),
                   "exact_argmax": sum(c["exact_argmax"] for c in checks),
                   "max_gap_rel": max(c["max_gap_rel"] for c in checks)},
        "swap_back_replays_pre": back == pre,
        "captures_after_swap": post_captures + back_captures,
        "replays_after_swap": post_replays + back_replays,
        "weight_swaps": engine.stats["weight_swaps"], "prefix_epoch": engine.prefix_epoch,
    })
    rec["install_bound_share"] = rec["bound_ms"] / rec["swap_install_ms"]
    ok = (rec["ptrs_unchanged"] and burst_ok and rec["rows_changed"] > 0
          and rec["argmax"]["ok"] and rec["swap_back_replays_pre"]
          and rec["captures_after_swap"] == 0 and rec["replays_after_swap"] > 0)
    print(f"swap [{label}]: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def swap_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """swap_phase on the decision phase's warm graph-mode bf16 engine, the
    staging trees from init_params (seed 1, then seed 0: the engine's)."""
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params

    cfg = backend.engine.cfg
    return swap_phase(backend.engine, nodes, pods,
                      lambda seed: init_params(cfg, seed=seed, device="cuda"), "bf16")


def _int8_staging(cfg):
    """make_staging for path A: the int8 tree of init_params(seed), as path
    A quantizes its weights (its bf16 transient dropped)."""
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.models.quant import quantize_params

    def make(seed):
        bf16 = init_params(cfg, seed=seed, device="cuda")
        return quantize_params(bf16)

    return make


SIM_NODES = 12
SIM_PODS = 16
SIM_WAVES = 2
SIM_SEED = 0


def sim_phase(backend) -> tuple[bool, dict]:
    """The arena (sim/) twice with one seed: SIM_NODES nodes, SIM_PODS pods
    in SIM_WAVES waves over the port's WireFakeK8s and the whole stack, the
    `llm` arm served greedily by the decision phase's warm 8B engine in
    graph mode through one LocalLLMBackend passed in with owned=False (no
    second 8B engine), beside the teacher. Fails unless the two runs'
    traces are byte-identical, every pod of the llm arm is placed or
    counted unschedulable, and K1 launched in each run. Prints K1 launches
    and the card's free memory after each arm."""
    import torch
    from k8s_llm_scheduler_tpu_torch import sim
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.sim.trace import build_trace, canonical_bytes

    spec = sim.ScenarioSpec(name="smoke", seed=SIM_SEED, n_nodes=SIM_NODES,
                            n_pods=SIM_PODS, arrival="waves", n_waves=SIM_WAVES)
    arm_backend = LocalLLMBackend(backend.engine, request_timeout_s=600.0,
                                  prewarm_idle_delay_s=NO_PREWARM_S)
    runs = []
    try:
        for _ in range(2):
            free: dict = {}

            def done(name, _report, free=free):
                torch.cuda.synchronize()
                free[name] = torch.cuda.mem_get_info()[0] / 2**30

            _zero_launch_counts()
            t0 = time.perf_counter()
            report = sim.run_arena(
                sim.generate_scenario(spec),
                [sim.ArmSpec(name="llm", kind="stack", make=lambda: arm_backend,
                             owned=False), sim.teacher_arm()],
                wave_timeout_s=600.0, on_arm_done=done)
            runs.append({"wall_s": time.perf_counter() - t0, "k1": _launch_counts()["K1"],
                         "free_gib_after_arm": free,
                         "trace": canonical_bytes(build_trace(report)),
                         "scores": report["arms"]["llm"]["scores"],
                         "stats": report["arms"]["llm"]["stats"]})
    finally:
        arm_backend.close()
    llm = runs[0]["scores"]
    rec = {"nodes": SIM_NODES, "pods": SIM_PODS, "waves": SIM_WAVES,
           "identical_traces": runs[0]["trace"] == runs[1]["trace"],
           "trace_bytes": len(runs[0]["trace"]),
           "llm_scores": llm, "llm_stats": runs[0]["stats"],
           "runs": [{k: r[k] for k in ("wall_s", "k1", "free_gib_after_arm")} for r in runs]}
    ok = (rec["identical_traces"] and llm["n_bound"] + llm["n_unschedulable"] == SIM_PODS
          and all(r["k1"] > 0 for r in runs)
          and runs[0]["stats"].get("llm_decisions", 0) > 0)
    print(f"sim: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def resident_phase(engine, nodes) -> tuple[bool, dict]:
    """Two backends over the decision phase's engine, one after the other:
    the first decides on the 32-node cluster, the second on SIM_NODES
    nodes (a group of its own), then the first again: it must reinstall
    its group (one more install) and repeat its decision (greedy)."""
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    pod = fixture_pods(1)[0]
    first, second = (LocalLLMBackend(engine, request_timeout_s=600.0,
                                     prewarm_idle_delay_s=NO_PREWARM_S) for _ in range(2))
    try:
        t0 = time.perf_counter()
        before = first.get_scheduling_decision(pod, nodes)
        installs = first.get_stats()["backend"]["group_installs"]
        second.get_scheduling_decision(pod, synthetic_nodes(SIM_NODES))
        after = first.get_scheduling_decision(pod, nodes)
        rec = {"s": time.perf_counter() - t0,
               "nodes": [before.selected_node, after.selected_node],
               "reinstalls": first.get_stats()["backend"]["group_installs"] - installs}
    finally:
        second.close()
        first.close()
    ok = (_feasible(nodes, [(pod, before), (pod, after)]) and rec["reinstalls"] == 1
          and (before.selected_node, before.reasoning) == (after.selected_node, after.reasoning))
    print(f"resident: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


ROLLOUT_NODES = 4
ROLLOUT_PODS = 6  # a burst while v3 is the shadowed candidate, one after its swap
ROLLOUT_DEADLINE_S = 300.0
# The gate's scenario and tolerances in the rollout phase's children: the
# phase checks the machinery (gate, promote, swap), not whether one random
# checkpoint places better than another, so every check passes.
ROLLOUT_GATE = {"seed": 0, "nodes": 6, "pods": 12, "shapes": 4, "waves": 2,
                "spread_tolerance": 1.0, "constraint_tolerance": 1.0,
                "bound_tolerance": 1.0}
# `cli <argv[2:]>` with ROLLOUT_GATE and a 0.5 s controller poll in the
# config's defaults (no environment variable sets them), the wire fake at
# argv[1] ("-" for none), and the metrics port written to metrics_port.
ROLLOUT_CHILD = r"""
import json, os, sys
from pathlib import Path
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as config_mod
from k8s_llm_scheduler_tpu_torch.cluster import httpapi

if sys.argv[1] != "-":
    httpapi.set_active_config(sys.argv[1])
config_mod.DEFAULTS["rollout"]["gate"].update(json.loads(os.environ["SMOKE_GATE"]))
config_mod.DEFAULTS["rollout"]["poll_seconds"] = 0.5
start_metrics = cli._start_metrics

def port_file(*args, **kwargs):
    server, sampler = start_metrics(*args, **kwargs)
    if server is not None:
        Path("metrics_port").write_text(str(server.port))
    return server, sampler

cli._start_metrics = port_file
sys.exit(cli.main(sys.argv[2:]))
"""


def _gauges(text: str, prefix: str) -> dict:
    """Prometheus samples of /metrics whose name starts with `prefix`."""
    out = {}
    for line in text.splitlines():
        if line.startswith(prefix):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def rollout_tiny() -> tuple[bool, dict]:
    """Live rollout at TINY on the card through `cli rollout`: three random
    TINY checkpoints (seeds 0, 1, 2) saved with models/loader; v1 and v2
    published and v1 made active; `cli rollout promote --version 2` in a
    child (the gate's two arms, incumbent v1 and candidate v2, on the
    card); then a `cli rollout watch` child over the port's WireFakeK8s
    (ROLLOUT_NODES nodes) with --shadow-frac 0.5 and metrics on port 0.
    While it serves v2, v3 is published: once /metrics shows v3 as the
    shadowed candidate, ROLLOUT_PODS pods are created; the watch gates v3
    (two arms on the card), hot-swaps it in and the registry's active
    pointer moves to 3; ROLLOUT_PODS more pods are created. Once every pod
    is bound, /metrics is scraped for the rollout gauges and the child gets
    SIGINT. Fails unless promote exits 0 with the gate passed, the watch
    exits 0 with its stats, every pod is bound once to a ready node, the
    watch promoted v3 with one swap and the shadow mirrored decisions."""
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
    from k8s_llm_scheduler_tpu_torch.rollout import CheckpointRegistry
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_nodes

    import urllib.request

    rec: dict = {"model": "tiny", "gate": ROLLOUT_GATE}
    nodes = synthetic_nodes(ROLLOUT_NODES)
    srv = WireFakeK8s()
    for n in nodes:
        srv.add_node(n.name, cpu=str(int(n.available_cpu_cores)),
                     memory=f"{int(n.available_memory_gb)}Gi", pods=str(n.max_pods),
                     labels=n.labels)
    pods = pod_burst(2 * ROLLOUT_PODS, distinct_shapes=2 * ROLLOUT_PODS)
    t0 = time.perf_counter()
    end = t0 + ROLLOUT_DEADLINE_S
    child = None
    with tempfile.TemporaryDirectory() as cwd:
        reg_dir = Path(cwd) / "registry"
        registry = CheckpointRegistry(reg_dir)
        for seed in (0, 1, 2):
            save_checkpoint(Path(cwd) / f"ckpt{seed}", init_params(TINY, seed=seed, device="cpu"))
        for seed in (0, 1):
            registry.publish(Path(cwd) / f"ckpt{seed}", cfg=TINY, note=f"seed {seed}")
        registry.set_active(1)
        env = _child_env(KUBECONFIG=str(Path(cwd) / "no-kubeconfig"), LLM_MODEL="tiny",
                         METRICS_ENABLED="true", METRICS_PORT="0",
                         SMOKE_GATE=json.dumps(ROLLOUT_GATE))
        env.pop("KUBERNETES_SERVICE_HOST", None)
        promote = subprocess.run(
            [sys.executable, "-c", ROLLOUT_CHILD, "-", "rollout", "promote", "--registry",
             str(reg_dir), "--version", "2"], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=600)
        try:
            verdict = json.loads(promote.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            verdict = {}
        rec["promote"] = {"rc": promote.returncode, "pass": verdict.get("pass"),
                          "active": verdict.get("active"),
                          "incumbent": verdict.get("incumbent"),
                          "candidate": verdict.get("candidate")}
        log = Path(cwd) / "watch.log"
        out = Path(cwd) / "watch.out"
        port_path = Path(cwd) / "metrics_port"
        scraped, shadow_max = "", 0.0

        def scrape() -> str:
            # the last good scrape when the child does not answer (it may be
            # exiting); the checks below read what the scrapes got
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{int(port_path.read_text())}/metrics",
                        timeout=30) as resp:
                    return resp.read().decode()
            except OSError as exc:
                print(f"rollout TINY: /metrics scrape failed: {exc!r}", flush=True)
                return scraped

        def wait(done):
            nonlocal scraped, shadow_max
            while child.poll() is None and time.perf_counter() < end and not done():
                if port_path.exists():
                    scraped = scrape()
                    shadow_max = max([shadow_max, *_gauges(
                        scraped, "llm_scheduler_shadow_mirrored").values()])
                time.sleep(0.2)

        def add(burst):
            for pod in burst:
                srv.add_pod(pod.name, requests=dict(pod.container_requests[0]),
                            priority=pod.priority)

        with open(log, "w") as err, open(out, "w") as stdout:
            child = subprocess.Popen(
                [sys.executable, "-c", ROLLOUT_CHILD, srv.base_url, "rollout", "watch",
                 "--registry", str(reg_dir), "--shadow-frac", "0.5"],
                cwd=cwd, env=env, stdout=stdout, stderr=err)
        try:
            wait(lambda: port_path.exists()
                 and any("watch=true" in r for r in srv.request_log))
            registry.publish(Path(cwd) / "ckpt2", cfg=TINY, note="seed 2")
            wait(lambda: _gauges(scraped, "llm_scheduler_shadow_candidate_version")
                 or registry.active() == 3)
            rec["shadowed_before_pods"] = bool(
                _gauges(scraped, "llm_scheduler_shadow_candidate_version"))
            add(pods[:ROLLOUT_PODS])
            wait(lambda: registry.active() == 3 and len(srv.bindings) >= ROLLOUT_PODS)
            add(pods[ROLLOUT_PODS:])
            wait(lambda: len(srv.bindings) >= len(pods))
            if child.poll() is None and port_path.exists():
                scraped = scrape()
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        text = out.read_text()
        watch_log = log.read_text()
        active = registry.active()
    srv.close()
    try:
        stats = json.loads(text[text.index("{"):])
    except ValueError:
        stats = {}
    rollout = stats.get("rollout", {})
    gauges = _gauges(scraped, "llm_scheduler_rollout_")
    ready = {n.name for n in nodes if n.is_ready}
    rec.update({
        "wall_s": time.perf_counter() - t0, "watch_rc": child.returncode,
        "active": active, "bound": len({name for _, name, _ in srv.bindings}),
        "bindings": len(srv.bindings),
        "on_ready_nodes": all(node in ready for _, _, node in srv.bindings),
        "shadow_mirrored_max": shadow_max,
        "rollout": {k: rollout.get(k) for k in ("promotions", "gate_pass", "gate_fail",
                                                "rollbacks", "burn_in_open", "rejected")},
        "swap": {k: (rollout.get("swap") or {}).get(k) for k in (
            "swaps", "last_pause_s", "last_mode", "active_version")},
        "metrics_gauges": {k: v for k, v in gauges.items() if any(
            s in k for s in ("promotions", "gate_pass", "swap_swaps", "swap_last_pause_s",
                             "active_version"))},
    })
    ok = (rec["promote"]["rc"] == 0 and rec["promote"]["pass"] is True
          and rec["promote"]["active"] == 2 and rec["watch_rc"] == 0 and active == 3
          and rec["bound"] == rec["bindings"] == len(pods) and rec["on_ready_nodes"]
          and rec["rollout"]["promotions"] == 1 and rec["swap"]["swaps"] == 1
          and shadow_max > 0 and bool(rec["metrics_gauges"]))
    print(f"rollout TINY: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    if not ok:
        print(promote.stderr[-3000:], watch_log[-6000:], file=sys.stderr, flush=True)
    return ok, rec


LEARN_MODEL = TRAIN_MODEL  # the largest model the port trains on one card
LEARN_SETTINGS = {  # small, listed: the learn 1B phase's config over the defaults
    "llm": {"model": LEARN_MODEL, "backend": "local", "temperature": 0.0},
    "learn": {"mine_seeds": [0], "mine_nodes": 8, "mine_pods": 24, "mine_waves": 3,
              "steps": 4, "batch_size": 4, "seq_len": 1024, "lr": 3e-4,
              "weakness_cases": 8, "retain": 0},
    "rollout": {"gate": {"seed": 0, "nodes": 6, "pods": 12, "shapes": 4, "waves": 2}},
}


@contextlib.contextmanager
def _cli_in(cwd: Path, settings: dict):
    """cli.main in this process with `settings` merged into the config's
    defaults, run from `cwd` (no config file there: a card without PyYAML
    refuses one); both are restored after."""
    import copy

    from k8s_llm_scheduler_tpu_torch import config as config_mod

    saved = copy.deepcopy(config_mod.DEFAULTS)
    for section, values in settings.items():
        for key, value in values.items():
            if isinstance(value, dict):
                config_mod.DEFAULTS[section].setdefault(key, {}).update(value)
            else:
                config_mod.DEFAULTS[section][key] = value
    here = os.getcwd()
    os.chdir(cwd)
    try:
        yield
    finally:
        os.chdir(here)
        config_mod.DEFAULTS.clear()
        config_mod.DEFAULTS.update(saved)


def _cli_json(argv) -> tuple[int, dict]:
    """(exit code, the last JSON object on stdout) of cli.main(argv)."""
    import io

    from k8s_llm_scheduler_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue().strip()
    try:
        return rc, json.loads(text)
    except ValueError:
        lines = [line for line in text.splitlines() if line.startswith("{")]
        return rc, (json.loads(lines[-1]) if lines else {"stdout": text[-2000:]})


def learn_1b(incumbent_ckpt: str) -> tuple[bool, dict]:
    """The learn loop at Llama-3.2-1B through `cli.main` in this process:
    the train 1B checkpoint published into a temporary registry and made
    active, then `learn mine`, `build`, `run --trace T`, `replay T` and
    `status`, and `rollout publish` under `rollout.retain: 1`. See the
    module doc, phase 6l."""
    import torch

    from k8s_llm_scheduler_tpu_torch.learn import loop as loop_mod
    from k8s_llm_scheduler_tpu_torch.rollout import CheckpointRegistry
    from k8s_llm_scheduler_tpu_torch.train import train_step

    rec: dict = {"model": LEARN_MODEL, "settings": LEARN_SETTINGS, "stages_s": {},
                 "launches": {}}
    stage_launches: dict[str, dict] = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            before = _launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                total = stage_launches.setdefault(name, {"K1": 0, "K2": 0})
                for k in total:
                    total[k] += _launch_counts()[k] - before[k]
        return wrapper

    step_ms: list[float] = []
    make_step = train_step.make_train_step

    def timed_make_train_step(*args, **kwargs):
        init_fn, step_fn = make_step(*args, **kwargs)

        def timed_step(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()
            step_ms.append(1000.0 * (time.perf_counter() - t0))
            return out

        timed_step.__dict__.update(step_fn.__dict__)  # place_batch, gather_params, specs
        return init_fn, timed_step

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        settings = json.loads(json.dumps(LEARN_SETTINGS))
        settings["learn"]["corpus_dir"] = str(root / "corpus")
        settings["rollout"]["registry_dir"] = str(root / "registry")
        trace = root / "learn.trace"
        patches = [(loop_mod.LearnLoop, "mine_sources"), (loop_mod, "weakness_report"),
                   (loop_mod.LearnLoop, "_gate"), (train_step, "make_train_step")]
        saved = [getattr(obj, name) for obj, name in patches]
        loop_mod.LearnLoop.mine_sources = counted("cycle_mine", saved[0])
        loop_mod.weakness_report = counted("weakness", saved[1])
        loop_mod.LearnLoop._gate = counted("gate_total", saved[2])
        train_step.make_train_step = timed_make_train_step
        try:
            with _cli_in(root, settings):
                def stage(name, argv):
                    _zero_launch_counts()
                    t0 = time.perf_counter()
                    out = _cli_json(argv)
                    rec["stages_s"][name] = time.perf_counter() - t0
                    rec["launches"][name] = _launch_counts()
                    return out

                rc_pub, pub = stage("publish", ["rollout", "publish", "--checkpoint",
                                                incumbent_ckpt, "--model", LEARN_MODEL])
                rc_act, _ = stage("activate", ["rollout", "promote", "--version",
                                               str(pub.get("version")), "--no-gate"])
                rc_mine, mine = stage("mine", ["learn", "mine", "--note", "smoke", "--device",
                                                  "cuda"])
                rc_build, build = stage("build", ["learn", "build"])
                rc_run, run = stage("run", ["learn", "run", "--trace", str(trace),
                                            "--work-dir", str(root / "work"), "--device",
                                            "cuda"])
                rc_replay, replay = stage("replay", ["learn", "replay", str(trace)])
                rc_status, status = stage("status", ["learn", "status"])
                registry = CheckpointRegistry(root / "registry")
                incumbent = pub.get("version")
                candidate = run.get("candidate_version")
                manifest = registry.get(candidate) if candidate is not None else None
                # retention: two placeholder versions published and made
                # active in turn, then a third published under
                # rollout.retain 1. Only the corpus lineage pin keeps the
                # incumbent (neither newest, active nor the active's
                # parent); the cycle's candidate goes, whatever its verdict
                spare = root / "spare"
                spare.mkdir()
                (spare / "placeholder.bin").write_bytes(b"retention check")
                spares = []
                for i in range(2):
                    _, v = stage(f"publish_spare{i}", ["rollout", "publish", "--checkpoint",
                                                       str(spare), "--model", LEARN_MODEL])
                    stage(f"activate_spare{i}", ["rollout", "promote", "--version",
                                                 str(v.get("version")), "--no-gate"])
                    spares.append(v.get("version"))
            with _cli_in(root, {**settings, "rollout": {**settings["rollout"], "retain": 1}}):
                rc_retain, last = _cli_json(["rollout", "publish", "--checkpoint", str(spare),
                                             "--model", LEARN_MODEL])
            kept = CheckpointRegistry(root / "registry").versions()
        finally:
            for (obj, name), fn in zip(patches, saved):
                setattr(obj, name, fn)
    gate_only = {k: stage_launches.get("gate_total", {}).get(k, 0)
                 - stage_launches.get("weakness", {}).get(k, 0) for k in ("K1", "K2")}
    rec["launches"].update(cycle_mine=stage_launches.get("cycle_mine"),
                           weakness_gate=stage_launches.get("weakness"), arena_gate=gate_only)
    weak_inc, weak_cand = run.get("weakness_incumbent"), run.get("weakness_candidate")
    action = run.get("action")
    scores = (manifest.scores.get("learn_gate", {}) if manifest is not None else {})
    weakness_pass = scores.get("weakness", {}).get("pass")
    base = scores.get("base", {})
    rec.update(
        incumbent_version=incumbent, candidate_version=candidate, action=action,
        incidents_mined=mine.get("n_incidents"), cycle_corpus=run.get("corpus_version"),
        per_class=mine.get("per_class"), build=build, weakness_incumbent=weak_inc,
        weakness_candidate=weak_cand, gate_pass=run.get("gate_pass"),
        gate_checks=base.get("checks"), train_loss=run.get("train_loss"),
        finetune_ms_per_step=(statistics.mean(step_ms[1:] or step_ms) if step_ms else None),
        finetune_step_ms=step_ms, replay=replay, lineage=status.get("lineage_versions"),
        registry_active=status.get("registry_active"), kept_after_retain=kept,
        parent=manifest.parent if manifest is not None else None)
    consistent = (
        weak_inc is not None and weak_cand is not None
        and weakness_pass == (weak_cand > weak_inc + LEARN_SETTINGS["learn"].get(
            "weakness_margin", 0.0))
        and base.get("pass") == all((base.get("checks") or {"": False}).values())
        and base.get("pass") == run.get("gate_pass")
        and action == ("promoted" if weakness_pass and base.get("pass") else "rejected")
        and rc_run == (0 if action == "promoted" else 1)
        and scores.get("action") == action)
    checks = {
        "cli": (rc_pub, rc_act, rc_mine, rc_build, rc_replay, rc_status, rc_retain)
               == (0,) * 7,
        "mined": (mine.get("n_incidents") or 0) > 0
                 and mine.get("checkpoint_version") == incumbent,
        "verdict_consistent": consistent,
        "lineage": rec["parent"] == incumbent and rec["lineage"] == [incumbent],
        "replay_identical": replay.get("ok") is True,
        "retain_keeps_lineage": kept == sorted([incumbent, *spares, last.get("version")]),
        "finetune_ran": len(step_ms) == LEARN_SETTINGS["learn"]["steps"]
                        and math.isfinite(run.get("train_loss") or float("nan")),
        "launches": all((rec["launches"][k] or {}).get(x, 0) > 0
                        for k in ("mine", "cycle_mine", "weakness_gate", "arena_gate")
                        for x in ("K1", "K2")),
    }
    rec["checks"] = checks
    ok = all(checks.values())
    print(f"learn 1B: {LEARN_MODEL}, incumbent v{incumbent} (train 1B's checkpoint); "
          f"mine: {mine.get('n_incidents')} incidents {mine.get('per_class')}; cycle: "
          f"{action} candidate v{candidate} (parent {rec['parent']}), weakness "
          f"{weak_inc} -> {weak_cand}, arena gate {run.get('gate_pass')} "
          f"{base.get('checks')}, train loss {run.get('train_loss')}, finetune "
          f"{rec['finetune_ms_per_step']} ms a step ({len(step_ms)} steps of "
          f"{LEARN_SETTINGS['learn']['batch_size']} x {LEARN_SETTINGS['learn']['seq_len']}); "
          f"replay {replay.get('ok')}; kept after retain 1: {kept}; stages s "
          f"{ {k: round(v, 1) for k, v in rec['stages_s'].items()} }; launches "
          f"{rec['launches']} | {_smi()} | checks {checks} ok={ok}", flush=True)
    return ok, rec


FLEET_WORKER_MODEL = TRAIN_MODEL
FLEET_NODES = 32  # the decision phase's cluster
FLEET_PODS = 16
FLEET_SHAPES = 8
FLEET_DEADLINE_S = 300.0
FLEET_WORKER_START_S = 300.0
FLEET_ROUTER = {"enabled": True, "big_cold_extra_ms": 1000.0, "complexity_threshold": 1}
FLEET_ROUTER_PODS = 8

FLEET_WORKER = r"""
import sys
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as config_mod
from k8s_llm_scheduler_tpu_torch.engine import local as local_mod
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

get_stats = local_mod.LocalLLMBackend.get_stats

def counted_stats(self):
    out = get_stats(self)
    out["kernel_launches"] = {"K1": pa.flash_prefix_attention_parts.launches,
                              "K2": pa.flash_causal_attention_parts.launches}
    return out

local_mod.LocalLLMBackend.get_stats = counted_stats
config_mod.DEFAULTS["llm"].update(model=sys.argv[1], temperature=0.0)
config_mod.DEFAULTS["distributed"].update(replica_port=0, replica_bind_host="127.0.0.1")
pa.reset_launch_counts()
sys.exit(cli._run_worker_replica(cli.load_config(), device="cuda"))
"""


def _start_worker(cwd: Path):
    """The worker child and its port, read from the line it prints once it
    listens (deadline FLEET_WORKER_START_S)."""
    import queue

    proc = subprocess.Popen([sys.executable, "-c", FLEET_WORKER, FLEET_WORKER_MODEL],
                            cwd=cwd, env=_child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    err: list[str] = []
    threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True).start()
    end = time.perf_counter() + FLEET_WORKER_START_S
    while time.perf_counter() < end and proc.poll() is None:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if "serving decisions on :" in line:
            return proc, int(line.rsplit(":", 1)[1]), err
    return proc, None, err


def _stop_worker(proc) -> int | None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def _fleet_fanout(backend, port) -> tuple[bool, dict]:
    """(a) A burst through cli.build_stack with distributed.replica_addrs
    naming the worker: FanoutBackend over the phase's 8B backend and the
    worker's ReplicaClient, under Scheduler.run() over synthetic_cluster."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from k8s_llm_scheduler_tpu_torch.cli import build_stack, run_until_bound
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.sched.replica import ReplicaClient
    from k8s_llm_scheduler_tpu_torch.testing import (
        fixture_pods,
        pod_burst,
        synthetic_cluster,
        synthetic_nodes,
    )

    # the worker's warm-up, ahead of the burst: one decision, then a wave
    warm = ReplicaClient("127.0.0.1", port, request_timeout_s=FLEET_DEADLINE_S)
    try:
        nodes = synthetic_nodes(FLEET_NODES)
        t0 = time.perf_counter()
        warm.get_scheduling_decision(fixture_pods(1)[0], nodes)
        first_s = time.perf_counter() - t0
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(lambda p: warm.get_scheduling_decision(p, nodes), fixture_pods(8)))
        warm_s = time.perf_counter() - t0
    finally:
        warm.close()
    cfg = _default_config()
    cfg.data["distributed"]["replica_addrs"] = [f"127.0.0.1:{port}"]
    cfg.data["llm"]["timeout"] = FLEET_DEADLINE_S
    cluster = synthetic_cluster(FLEET_NODES)
    pods = pod_burst(FLEET_PODS, distinct_shapes=FLEET_SHAPES)
    for pod in pods:
        cluster.add_pod(pod)
    binds: dict[str, int] = {}
    bind = cluster.bind_pod_to_node

    def counted_bind(name, namespace, node):
        ok = bind(name, namespace, node)
        if ok:
            binds[name] = binds.get(name, 0) + 1
        return ok

    cluster.bind_pod_to_node = counted_bind
    snapshot = cluster.get_node_metrics()
    scheduler, fan = build_stack(cfg, cluster, backend=backend)
    worker = fan.replicas[1]
    try:
        # the worker's counts run from its start: the burst's are the
        # difference of two pulls around it, its warm-up's the first pull
        warm_launches = _worker_launches(worker)
        _zero_launch_counts()
        t0 = time.perf_counter()
        all_bound = asyncio.run(run_until_bound(scheduler, cluster, len(pods),
                                                FLEET_DEADLINE_S))
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        after = _worker_launches(worker)
        fan_stats = fan.get_stats()
    finally:
        del cluster.bind_pod_to_node
        for client in fan.replicas[1:]:  # the phase closes the 8B backend
            client.close()
    worker_launches = {k: after[k] - warm_launches[k] for k in ("K1", "K2")}
    stats = scheduler.get_stats()
    placed = {p.name: cluster.get_pod(p.namespace, p.name).node_name for p in pods}
    feasible = all(placed[p.name] in {n.name for n in feasible_nodes(raw_pod_to_spec(p),
                                                                     snapshot)}
                   for p in pods)
    routed = fan_stats["fanout_routed"]
    rec = {"backend": type(fan).__name__, "pods": len(pods), "all_bound": all_bound,
           "binds_per_pod": sorted(set(binds.values())), "feasible": feasible,
           "routed": routed, "ema_ms": fan_stats["fanout_ema_ms"],
           "llm_decisions": stats["llm_decisions"],
           "fallbacks": stats["client"]["fallback_decisions"] + stats["fallback_decisions"],
           "run_s": run_s, "worker_first_s": first_s, "worker_warm_s": warm_s,
           "coordinator_launches": launches, "worker_launches": worker_launches,
           "worker_warm_launches": warm_launches}
    ok = (rec["backend"] == "FanoutBackend" and all_bound and feasible
          and rec["binds_per_pod"] == [1] and len(binds) == len(pods)
          and rec["fallbacks"] == 0 and all(r > 0 for r in routed)
          and launches["K1"] > 0 and launches["K2"] > 0
          and worker_launches["K1"] > 0 and worker_launches["K2"] > 0)
    return ok, rec


def _worker_launches(client) -> dict:
    """The worker's K1/K2 launch counts since it started, from its stats."""
    counts = client.telemetry_pull(timeout_s=60.0)["stats"]["kernel_launches"]
    return {k: counts[k] for k in ("K1", "K2")}


def _fleet_router(backend) -> tuple[bool, dict]:
    """(b) cli._maybe_router over the phase's 8B backend: the fast arm is
    router.fast_model (TINY) with router.fast_tokenizer (numeric) on the
    card; a cold snapshot goes fast and fires the big arm's prewarm, a pod
    with a priority goes big. Decisions one at a time with both arms'
    sibling prewarm off; after each, both workers are drained through
    run_quiesced before the K1/K2 counts are read, so a decision's launches
    are its arm's (the cold one's also hold the big arm's prewarm)."""
    from k8s_llm_scheduler_tpu_torch.cli import _maybe_router
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    cfg = _default_config()
    cfg.data["router"].update(FLEET_ROUTER)
    cfg.data["llm"]["temperature"] = 0.0
    routed = _maybe_router(backend, cfg, "cuda")
    arms = (routed.big, routed.fast)
    routed.fast.prewarm_idle_delay_s = NO_PREWARM_S  # the big arm's is already
    nodes = synthetic_nodes(FLEET_NODES)
    decisions = []
    try:
        t0 = time.perf_counter()
        for pod in fixture_pods(FLEET_ROUTER_PODS):
            before = routed.get_stats()["router"]
            _zero_launch_counts()
            t1 = time.perf_counter()
            d = routed.get_scheduling_decision(pod, nodes)
            decide_s = time.perf_counter() - t1
            for arm in arms:
                arm.run_quiesced(lambda: None, FLEET_DEADLINE_S)
            launches = _launch_counts()
            after = routed.get_stats()["router"]
            reason = next(r for r, n in after["route_reasons"].items()
                          if n > before["route_reasons"].get(r, 0))
            names = {n.name for n in feasible_nodes(pod, nodes)}
            decisions.append({
                "pod": pod.name, "reason": reason, "s": decide_s,
                "arm": "big" if after["routed_big"] > before["routed_big"] else "fast",
                "node": d.selected_node, "launches": {k: launches[k] for k in ("K1", "K2")},
                "feasible": d.selected_node in names and d.source == DecisionSource.LLM})
        run_s = time.perf_counter() - t0
        stats = routed.get_stats()["router"]
    finally:
        routed.fast.close()  # the phase closes the 8B arm
    arm_launches = {
        arm: {k: sum(x["launches"][k] for x in decisions
                     if x["arm"] == arm and x["reason"] != "cold_snapshot")
              for k in ("K1", "K2")}
        for arm in ("big", "fast")}
    cold = [x["launches"] for x in decisions if x["reason"] == "cold_snapshot"]
    rec = {"fast_model": cfg.get("router.fast_model"),
           "fast_tokenizer": cfg.get("router.fast_tokenizer"), "router": stats,
           "decisions": decisions, "arm_launches": arm_launches,
           "cold_launches": cold, "run_s": run_s}
    ok = (stats["routed_big"] > 0 and stats["routed_fast"] > 0 and stats["cold_prewarms"] > 0
          and stats["failovers"] == 0 and all(x["feasible"] for x in decisions)
          and all(arm_launches[a][k] > 0 for a in arm_launches for k in ("K1", "K2")))
    return ok, rec


def _fleet_cli(port, cwd: Path) -> tuple[bool, dict]:
    """(c) `cli fleet demo --json`, `cli fleet shard` and `cli fleet top
    --once --replicas` against the worker, through cli.main here."""
    import io

    from k8s_llm_scheduler_tpu_torch import cli
    from k8s_llm_scheduler_tpu_torch.sched.replica import ReplicaClient

    with _cli_in(cwd, {}):
        rc_demo, demo = _cli_json(["fleet", "demo", "--json", "--pods", "64", "--nodes",
                                   "12", "--shapes", "16", "--replicas", "3"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_shard = cli.main(["fleet", "shard", "default/web-1"])
            shard = buf.getvalue().strip()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_top = cli.main(["fleet", "top", "--once", "--replicas", f"127.0.0.1:{port}"])
            top = buf.getvalue()
    client = ReplicaClient("127.0.0.1", port, request_timeout_s=60.0)
    try:
        worker_stats = client.telemetry_pull(timeout_s=60.0)["stats"]
    finally:
        client.close()
    rec = {"demo": {k: demo.get(k) for k in ("total_scheduled", "bind_count", "n_shards",
                                             "n_replicas", "fenced_binds", "wall_s")},
           "shard": shard, "top": top[-1500:],
           "worker_completed": worker_stats.get("completed")}
    ok = (rc_demo == rc_shard == rc_top == 0 and demo.get("total_scheduled") == 64
          and demo.get("bind_count") == 64 and demo.get("fenced_binds") == 0
          and shard.isdigit() and f"127.0.0.1:{port}" in top)
    return ok, rec


def fleet_phase(engine) -> tuple[bool, dict]:
    """Fleet and replicas on one card: (a) the fan-out to a worker child
    serving Llama-3.2-1B through cli._run_worker_replica, (b) the router
    with the 8B as its big arm, (c) `cli fleet demo|shard|top`. The 8B
    arm is a LocalLLMBackend of its own over the decision phase's engine
    (no second copy of the weights), as the loop and sim phases use one.
    See the module doc, phase 6m."""
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    rec: dict = {"worker_model": FLEET_WORKER_MODEL}
    backend = LocalLLMBackend(engine, request_timeout_s=600.0,
                              prewarm_idle_delay_s=NO_PREWARM_S)
    with tempfile.TemporaryDirectory() as d:
        cwd = Path(d)
        t0 = time.perf_counter()
        proc, port, err = _start_worker(cwd)
        rec["worker_start_s"] = time.perf_counter() - t0
        try:
            if port is None:
                raise RuntimeError("fleet: the worker never listened\n"
                                   + "".join(err)[-4000:])
            a_ok, rec["fanout"] = _fleet_fanout(backend, port)
            b_ok, rec["router"] = _fleet_router(backend)
            c_ok, rec["cli"] = _fleet_cli(port, cwd)
        finally:
            rec["worker_rc"] = _stop_worker(proc)
            backend.close()
    rec["checks"] = {"fanout": a_ok, "router": b_ok, "cli": c_ok,
                     "worker_exit": rec["worker_rc"] == 0}
    ok = all(rec["checks"].values())
    if not ok:
        print("".join(err)[-4000:], file=sys.stderr, flush=True)
    print(f"fleet: worker {FLEET_WORKER_MODEL} up in {rec['worker_start_s']:.1f} s; "
          f"fan-out {json.dumps(rec['fanout'])}; router {json.dumps(rec['router'])}; cli "
          f"{json.dumps({k: v for k, v in rec['cli'].items() if k != 'top'})}; worker exit "
          f"{rec['worker_rc']} | {_smi()} | checks {rec['checks']} ok={ok}", flush=True)
    print(rec["cli"]["top"], flush=True)
    return ok, rec


KV_NODES = 32  # the decision phase's cluster: the 5,488-token prefix
KV_PODS = 8
KV_DRIFTED = 2  # nodes drifted for the second burst: below the repin fraction
KV_CLI_TIMEOUT_S = 300.0


def _twin_engine(engine):
    """A second engine over `engine`'s params tree (one copy of the
    weights on the card) with its page, slot, bucket, chunk and sampling
    geometry: a replica built alike. Engines that share a tree must swap
    together (engine.swap_params)."""
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine

    return InferenceEngine(
        engine.params, engine.cfg, engine.tokenizer,
        num_pages=engine.kv.num_pages, page_size=engine.kv.page_size,
        max_slots=engine.max_slots, max_pages_per_seq=engine.kv.max_pages_per_seq,
        prefill_buckets=engine.prefill_buckets, chunk_steps=engine.chunk_steps,
        prefix_chunk=engine.prefix_chunk, paged_attn=engine.paged_attn,
        temperature=engine.temperature, top_k=engine.top_k,
        decode_matmul=engine.decode_matmul, graphs=engine._graphs.enabled,
        admission_chunk_tokens=engine.admission_chunk_tokens,
        fused_decode=engine.fused_decode,
    )


@contextlib.contextmanager
def _wave_tokens(engine):
    """The token streams of every wave the engine harvests, in order."""
    waves: list[list[list[int]]] = []
    harvest = engine.harvest_wave

    def recorded(handle):
        fins = harvest(handle)
        waves.append([f.token_ids for f in fins])
        return fins

    engine.harvest_wave = recorded
    try:
        yield waves
    finally:
        del engine.harvest_wave


def _sync_ms(fn):
    """(fn(), wall ms ending in a device sync)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1000.0


def _kv_engine_level(filler, adopter, nodes, pods) -> tuple[bool, dict]:
    """The plane's unit at 8B between two engines over one params tree:
    the filler pins the snapshot prefix and exports its pages in both
    transports; the adopter decides the batch after a local prefill of the
    same prefix (its baseline, capturing its wave programs), then after
    adopting each page set in turn, its prefix cache emptied between."""
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import adopt_pages, export_pages

    rec: dict = {}
    fb = LocalLLMBackend(filler, request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)
    ab = LocalLLMBackend(adopter, request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)
    try:
        items = [fb._prepare_item(p, nodes) for p in pods]
        suffixes = [it.suffix_ids for it in items]
        prefix = list(items[0].prefix_ids)

        def wave(backend):
            backend._switch_group(items[0])
            fins = backend.engine.decide_wave(suffixes, backend.max_new_tokens)
            return [f.token_ids for f in fins]

        # the filler starts from a cold prefix plane too: its pin is a fresh
        # chunked prefill, as the adopter's local one (an LCP-seeded one may
        # round differently)
        for k in list(filler._pinned_prefix_keys):
            filler.unpin_prefix(k)
        filler._prefix_cache.clear()
        key, _ = filler.pin_prefix(prefix)
        filler_tokens = wave(fb)
        pages = {}
        for transport in ("host", "d2d"):
            pages[transport], rec[f"export_{transport}_ms"] = _sync_ms(
                lambda t=transport: export_pages(filler, key, generation=0,
                                                 filler="filler", transport=t))
        p = pages["host"]
        rec["bytes"] = p.nbytes
        rec["shape"] = list(p.k.shape)
        rec["host_pinned"] = bool(p.k.is_pinned())
        # the adopter's baseline: a local prefill of the same prefix
        (akey, _), rec["local_prefix_prefill_ms"] = _sync_ms(lambda: adopter.pin_prefix(prefix))
        local_tokens = wave(ab)
        rec["local_matches_filler"] = local_tokens == filler_tokens
        for transport in ("host", "d2d"):
            adopter.unpin_prefix(akey)
            adopter._prefix_cache.clear()
            before = {k: adopter.stats[k] for k in ("prefix_prefills", "prefill_tokens")}
            captures = _graph_books(adopter)["captures"]
            (akey, _), rec[f"adopt_{transport}_ms"] = _sync_ms(
                lambda t=transport: adopt_pages(adopter, pages[t]))
            _zero_launch_counts()
            tokens = wave(ab)
            launches = _launch_counts()
            books = _graph_books(adopter)
            rec[transport] = {
                "tokens_match_filler": tokens == filler_tokens,
                "prefix_prefills_moved": adopter.stats["prefix_prefills"] - before["prefix_prefills"],
                "prefill_tokens_moved": adopter.stats["prefill_tokens"] - before["prefill_tokens"],
                "new_captures": books["captures"] - captures,
                "K1": launches["K1"], "K2": launches["K2"],
            }
        rec["adopted_prefixes"] = adopter.stats.get("adopted_prefixes", 0)
        rec["rows"] = len(filler_tokens)
        rec["tokens"] = sum(len(t) for t in filler_tokens)
        # leave both prefix planes cold for the backend level
        for eng, k in ((filler, key), (adopter, akey)):
            eng.unpin_prefix(k)
            eng._prefix_cache.clear()
        del pages, p
    finally:
        fb.close()
        ab.close()
    ok = rec["local_matches_filler"] and rec["adopted_prefixes"] == 2 and all(
        r["tokens_match_filler"] and r["prefix_prefills_moved"] == 0
        and r["new_captures"] == 0 and r["K1"] > 0 and r["K2"] > 0
        for r in (rec["host"], rec["d2d"]))
    return ok, rec


def _kv_backend_level(filler, adopter, nodes, pods) -> tuple[bool, dict]:
    """Two replicas of the config's delta-prompt admission plane (delta
    prompts, 4 pins; batches ride waves: a packed 8B decision decodes
    through step(), its grammar's dense table past the fused runtime's
    cap), one over each engine, joined to one
    KVPlaneStore. Burst 1 (the snapshot) on replica 0 then replica 1; the
    generation bump of a swap (both engines swap together: a no-op swap of
    their shared tree, then the store's bump); burst 2 (KV_DRIFTED nodes
    drifted: a delta tail over the pin) on replica 1 then replica 0."""
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import KVGeometry, KVPlaneStore, page_digest

    from k8s_llm_scheduler_tpu_torch.cli import _backend_kwargs
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    cfg = _default_config()
    kw = {k: v for k, v in _backend_kwargs(cfg).items() if k in ADMISSION_KEYS}
    kw.pop("admission_chunk_tokens")
    kw["packed_admission"] = False
    # the plane as the config's fleet.kvplane.* keys set it (a filler's
    # lease lives fill_ttl_s: its prefill and publish must fit in it)
    plane = {k: cfg.get(f"fleet.kvplane.{k}") for k in (
        "transport", "fill_ttl_s", "max_entries", "wait_checks")}
    store = KVPlaneStore(fill_ttl_s=float(plane["fill_ttl_s"]),
                         max_entries=int(plane["max_entries"]))
    replicas = [LocalLLMBackend(eng, request_timeout_s=600.0,
                                prewarm_idle_delay_s=NO_PREWARM_S, **kw)
                for eng in (filler, adopter)]
    rec: dict = {"plane": plane, "backend": kw}
    drifted = [dataclasses.replace(n, cpu_usage_percent=min(99.0, n.cpu_usage_percent + 35.0))
               if i < KV_DRIFTED else n for i, n in enumerate(nodes)]
    try:
        for i, b in enumerate(replicas):
            b.attach_kvplane(store, replica=f"replica-{i}", transport=plane["transport"],
                             wait_checks=int(plane["wait_checks"]))

        def burst(i, snapshot):
            b = replicas[i]
            before = dict(b.engine.stats)
            _zero_launch_counts()
            with _wave_tokens(b.engine) as waves:
                decisions = b.get_scheduling_decisions_batch(pods, snapshot)
            launches = _launch_counts()
            bad = [d for d in decisions if isinstance(d, Exception)]
            if bad:
                raise bad[0]
            pin = next(iter(b._pin_manager.pins.values()))
            return {
                "decisions": decisions,
                "nodes": [d.selected_node for d in decisions],
                "tokens": [t for w in waves for t in w],
                "source": pin.source,
                "pin_ids": pin.cache_key,
                "K1": launches["K1"], "K2": launches["K2"],
                **{k: b.engine.stats.get(k, 0) - before.get(k, 0) for k in (
                    "prefix_prefills", "prefill_tokens", "prefix_reused_tokens",
                    "adopted_prefixes")},
            }

        first = [burst(0, nodes), burst(1, nodes)]
        rec["burst_1"] = {"same": first[0]["nodes"] == first[1]["nodes"]
                          and first[0]["tokens"] == first[1]["tokens"],
                          "feasible": _feasible(nodes, list(zip(pods, first[0]["decisions"]))),
                          **{f"replica_{i}": _kv_burst_summary(r) for i, r in enumerate(first)}}
        stats_1 = [b.get_stats()["kvplane"] for b in replicas]
        for b in replicas:
            b.run_quiesced(lambda e=b.engine: e.swap_params(e.params), timeout_s=600.0)
        rec["generation"] = store.bump_generation()
        pin_ids = first[0]["pin_ids"]
        stale = store.lookup(page_digest(pin_ids), KVGeometry.of_engine(adopter),
                             generation=0, holder="replica-1")
        rec["stale_lookup_refused"] = stale is None and store.gauges()["stale_rejections"] == 1
        second = [burst(1, drifted), burst(0, drifted)]
        rec["burst_2"] = {"same": second[0]["nodes"] == second[1]["nodes"]
                          and second[0]["tokens"] == second[1]["tokens"],
                          **{f"replica_{i}": _kv_burst_summary(r)
                             for i, r in zip((1, 0), second)}}
        rec["clients_after_burst_1"] = {f"replica-{i}": s for i, s in enumerate(stats_1)}
        rec["clients"] = {f"replica-{i}": b.get_stats()["kvplane"]
                          for i, b in enumerate(replicas)}
        rec["store"] = store.gauges()
    finally:
        for b in replicas:
            b.close()
    c0, c1 = stats_1
    r1, r0 = rec["clients"]["replica-1"], rec["clients"]["replica-0"]
    checks = {
        "replica_0_filled": c0["elections_won"] == 1 and c0["publishes"] == 1,
        "replica_1_adopted": (c1["adoptions"] == 1 and first[1]["source"] == "shared"
                              and first[1]["prefix_prefills"] == 0),
        "burst_1_identical": rec["burst_1"]["same"] and rec["burst_1"]["feasible"],
        "stale_refused": rec["stale_lookup_refused"] and rec["generation"] == 1,
        "replica_1_refilled": (r1["generation_syncs"] == 1 and r1["elections_won"] == 1
                               and r1["publishes"] == 1 and second[0]["source"] == "local"),
        "replica_0_adopted_gen_1": r0["adoptions"] == 1 and second[1]["source"] == "shared",
        # replica 0 prefilled only the delta tail over the pin it adopted
        "burst_2_identical": rec["burst_2"]["same"] and (
            second[1]["prefix_reused_tokens"] == len(pin_ids)
            and 0 < second[1]["prefill_tokens"] < len(pin_ids)),
        "launches": all(r["K1"] > 0 and r["K2"] > 0 for r in first + second),
        "store": rec["store"]["fills"] == 2 and rec["store"]["adoptions"] == 2,
    }
    rec["checks"] = checks
    return all(checks.values()), rec


def _kv_burst_summary(burst_rec) -> dict:
    return {k: v for k, v in burst_rec.items() if k not in ("decisions", "tokens", "pin_ids")}


def _kv_cli(cwd: Path) -> tuple[bool, dict]:
    """The plane's and the chaos plane's CLI in children of their own, all
    at once (no model: StubPinEngines, stubs and HashPlacementBackend)."""
    import concurrent.futures as cf

    trace = cwd / "kv-plane-outage.trace"

    def child(argv, **env):
        cmd = [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", *argv]
        out = subprocess.run(cmd, cwd=cwd, env=_child_env(**env), capture_output=True,
                             text=True, timeout=KV_CLI_TIMEOUT_S)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr, flush=True)
        return out.returncode, out.stdout

    def last_json(text):
        lines = [line for line in text.splitlines() if line.startswith("{")]
        return json.loads(lines[-1]) if lines else {}

    def chaos():
        run = child(["chaos", "run", "--regime", "kv-plane-outage", "--seed", "3",
                     "--waves", "4", "--pods", "24", "--trace", str(trace)])
        return run, child(["chaos", "replay", str(trace)])

    with cf.ThreadPoolExecutor(5) as pool:
        kv = pool.submit(child, ["fleet", "kvplane", "--json", "--replicas", "4"])
        demo = pool.submit(child, ["fleet", "demo", "--json", "--pods", "64", "--nodes",
                                   "12", "--shapes", "16", "--replicas", "3"],
                           FLEET_KVPLANE_ENABLED="1")
        listed = pool.submit(child, ["chaos", "list"])
        runs = pool.submit(chaos)
        auto = pool.submit(child, ["fleet", "autoscale", "--json"])
        (kv_rc, kv_out), (demo_rc, demo_out), (list_rc, list_out) = (
            f.result() for f in (kv, demo, listed))
        (run_rc, run_out), (replay_rc, replay_out) = runs.result()
        auto_rc, auto_out = auto.result()
    kvrec, demorec, runrec, replayrec, autorec = (
        last_json(t) for t in (kv_out, demo_out, run_out, replay_out, auto_out))
    clients = kvrec.get("clients", {})
    rec = {
        "kvplane": {"rc": kv_rc, "dedup_ratio": kvrec.get("dedup_ratio"),
                    "store": kvrec.get("store"),
                    "accounted": len(clients) == 4 and all(
                        c["adoptions"] + c["elections_won"] + c["local_fallbacks"]
                        == kvrec["snapshots"] for c in clients.values())},
        "demo": {"rc": demo_rc, "total_scheduled": demorec.get("total_scheduled"),
                 "bind_count": demorec.get("bind_count"), "kvplane": demorec.get("kvplane")},
        "chaos_list": {"rc": list_rc, "regimes": len(list_out.splitlines())},
        "chaos_run": {"rc": run_rc, **{k: runrec.get(k) for k in (
            "clean", "plan_digest", "bound_frac", "injections")}},
        "chaos_replay": {"rc": replay_rc, "ok": replayrec.get("ok"),
                         "detail": replayrec.get("detail")},
        "autoscale": {"rc": auto_rc, "bind_count": autorec.get("bind_count"),
                      "scale_events": len(autorec.get("scale_events", []))},
    }
    ok = (kv_rc == 0 and (rec["kvplane"]["dedup_ratio"] or 0) > 1 and rec["kvplane"]["accounted"]
          and demo_rc == 0 and demorec.get("total_scheduled") == 64
          and demorec.get("bind_count") == 64 and isinstance(demorec.get("kvplane"), dict)
          and list_rc == 0 and rec["chaos_list"]["regimes"] >= 18
          and run_rc == 0 and runrec.get("clean") is True
          and replay_rc == 0 and replayrec.get("ok") is True
          and auto_rc == 0)
    return ok, rec


def kvplane_8b(engine) -> tuple[bool, dict]:
    """The shared prefix-KV plane at 8B (module doc, phase 6n): the engine
    level and the backend level over the decision phase's engine and a
    twin over its params tree, then the CLI children."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.graphs import DEVICE_WIDE
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    nodes, pods = synthetic_nodes(KV_NODES), fixture_pods(KV_PODS)
    adopter = _twin_engine(engine)
    rec: dict = {}
    try:
        e_ok, rec["engine"] = _kv_engine_level(engine, adopter, nodes, pods)
        b_ok, rec["backend"] = _kv_backend_level(engine, adopter, nodes, pods)
    finally:
        adopter.release()
        del adopter
        with DEVICE_WIDE:
            gc.collect()
            torch.cuda.empty_cache()
    rec["memory"] = _memory(start)
    with tempfile.TemporaryDirectory() as d:
        c_ok, rec["cli"] = _kv_cli(Path(d))
    rec["wall_s"] = time.perf_counter() - t0
    rec["checks"] = {"engine": e_ok, "backend": b_ok, "cli": c_ok}
    ok = all(rec["checks"].values())
    print(f"kvplane 8B: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------ tensor parallel
TP_MODEL = "llama-3.1-8b-instruct"
TP = 2  # ranks sharing the one card over gloo
TP_NODES = 8
TP_PODS = 4  # the burst
TP_REF_TOKENS = 64  # the first call: a whole-prompt prefill of these tokens
TP_LOGIT_TOL = 5e-2  # max |tp 2 - tp 1| over max |tp 1 logit|: bf16, one rounding moved
TP_GEN_TOKENS = 16
# the decisions' reasoning cap (320 by default): fewer model calls, which
# pay for the swap, plane and loop checks and the d2d arm's second group
TP_REASON_TOKENS = 8
# The tp group's hot swap, prefix-KV plane and resident loop (PR 21):
TP_SWAP_SEED = 1  # the second tree: seed 1's, each rank drawing its block
TP_SWAP_TOKENS = 4  # the unconstrained wave compared before, between and after the swaps
TP_SWAP_MARGIN = 2 << 30  # free memory kept beside the staged blocks
TP_PLANE_NODES = 32  # the plane's prefix: the decision phase's 5,488 tokens
TP_LOOP_TOKENS = 4  # each resident stream
TP_D2D_PAGES = 64  # the d2d adopter's paged KV (one wave, no paged decode): 0.25 GiB a rank
TP_LOOP_BUCKET = 256  # the loop's admission bucket: the decision suffixes fit
# K1/K2/K4 at one rank's shapes: Llama-3.3-70B at tp 8 (8 q heads over 1 kv
# head, group 8, hd 128) at the 8B decision path's geometry, timed; and
# Llama-3.1-8B at tp 2 (16 over 4), the tp 8B phase's, held. K1: (step, B,
# S, Sp, prefix_len, H, n_kv, hd); K2: (step, B, S, lens, H, n_kv, hd); K4:
# (step, q shape, pages shape, lens).
TP_K1_CASES = [
    ("70B tp8 suffix prefill", 8, 256, 6144, 5488, 8, 1, 128),
    ("70B tp8 block decode", 8, 24, 6144, 5488, 8, 1, 128),
    ("70B tp8 prefix chunk", 1, 2048, 6144, 2048, 8, 1, 128),
]
TP_K2_CASES = [
    ("70B tp8 suffix prefill", 8, 256, (229, 228, 230, 226, 231, 227, 229, 228), 8, 1, 128),
    ("70B tp8 prefix chunk", 1, 2048, (2048,), 8, 1, 128),
]
TP_K4_CASES = [
    ("70B tp8 decode step", (9, 8, 128), (512, 64, 1, 128),
     (242, 243, 244, 241, 246, 242, 244, 243, -5488)),
]
TP_HELD_K1 = [("8B tp2 suffix prefill", 4, 256, 2048, 1600, 16, 4, 128),
              ("8B tp2 block decode", 4, 24, 2048, 1600, 16, 4, 128)]
TP_HELD_K2 = [("8B tp2 suffix prefill", 4, 256, (229, 228, 230, 226), 16, 4, 128)]
TP_HELD_K4 = [("8B tp2 decode step", (5, 16, 128), (512, 64, 4, 128), (242, 243, 244, 241, -64))]


def _tp_k4_args(step, q_shape, pages_shape, lens):
    """A K4 case's (step, q shape, pages shape, tables, lens): each live
    sequence on distinct pages, the trash row on page 0."""
    import torch

    ps, P = pages_shape[1], 64
    gen = torch.Generator().manual_seed(19)
    live = sum(1 for n in lens if n > 0)
    ids = (1 + torch.randperm(pages_shape[0] - 1, generator=gen))[:live * 8].reshape(live, 8)
    tables = torch.zeros((len(lens), P), dtype=torch.int32)
    tables[:live, :8] = ids.to(torch.int32)
    return step, q_shape, pages_shape, tables, torch.tensor(lens, dtype=torch.int32)


def tp_kernel_phase() -> tuple[bool, dict]:
    """K1, K2 and K4 at one tp rank's shapes against their plain versions:
    70B tp 8 timed (beside the plain version, the bound and the library
    call), 8B tp 2 held."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = {"K1": [], "K2": [], "K4": []}
    runs = ([("K1", _prefix_case, c) for c in TP_K1_CASES]
            + [("K1", _prefix_check, c) for c in TP_HELD_K1]
            + [("K2", _causal_case, c) for c in TP_K2_CASES]
            + [("K2", _causal_check, c) for c in TP_HELD_K2])
    for name, run, case in runs:
        ok, rec = run(gen, *case)[:2]
        rec["ok"] = ok
        out[name].append(rec)
        _print_attention_case(name, rec)
        torch.cuda.empty_cache()
    for case, timed in [(c, True) for c in TP_K4_CASES] + [(c, False) for c in TP_HELD_K4]:
        args = _tp_k4_args(*case)
        if timed:
            _, rec = _k4_case(gen, *args, False)
        else:
            _, rec, _ = _k4_check(gen, *args, False)
        out["K4"].append(rec)
        _print_k4(rec)
        torch.cuda.empty_cache()
    return all(r["ok"] for recs in out.values() for r in recs), out


def tp_reference(engine, nodes, pods) -> dict:
    """The tp 8B phase's first call on the tp=1 8B engine (seed 0's full
    tree): the gathered-logits prefill of the first TP_REF_TOKENS tokens of
    the tp phase's first decision prompt, kept on the host."""
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.parallel import launch

    backend = LocalLLMBackend(engine, prewarm_idle_delay_s=NO_PREWARM_S)
    try:
        ids = backend._prepare_item(pods[0], nodes).prefix_ids[:TP_REF_TOKENS]
    finally:
        backend.close()
    return {"ids": ids, "logits": launch.prefill_logits(engine, ids)}


def _tp_per_call(steps) -> dict:
    return {step: rec["K1"] for step, rec in per_call(steps).items()}


def _tp_wave(eng, prefix_ids, suffixes, n) -> list:
    """An unconstrained greedy wave of `suffixes` against `prefix_ids`."""
    eng.set_prefix(prefix_ids)
    eng.set_grammar(None)
    return [f.token_ids for f in eng.decide_wave(suffixes, n)]


def _wait_complete_child(started) -> float:
    """Wait for cli complete's child (its output kept for finish_complete);
    the seconds waited."""
    child = started[0]
    t0 = time.perf_counter()
    if not hasattr(child, "smoke_output"):
        child.smoke_output = child.communicate(timeout=900)
    return time.perf_counter() - t0


def tp_swap_check(backend, items, complete_started) -> tuple[bool, dict]:
    """The tp group's hot swap to seed TP_SWAP_SEED's tree and back to seed
    0's, every rank restoring its own block (parallel/launch.stage_swap /
    install_swap in `double` mode, donate_swap when the card lacks room for
    both ranks' staged blocks beside the children), installed at the
    backend's wave barrier. Prints the card's free memory before the
    staging (waiting for cli complete's child first when it is short), the
    pause and each rank's install ms against 2 x a rank's block bytes /
    3.35 TB/s. Fails unless every data_ptr stays, the wave after the swap
    differs from the first, the wave after the swap back equals the first
    byte for byte, and every rank's prefix_epoch bumped twice."""
    import torch
    from k8s_llm_scheduler_tpu_torch.parallel import launch

    eng, group = backend.engine, backend.engine.rank_group
    prefix, suffixes = items[0].prefix_ids, [it.suffix_ids for it in items]
    block = launch._tree_bytes(eng.params)
    need = block * TP + TP_SWAP_MARGIN  # every rank's block stages on this card
    free = torch.cuda.mem_get_info()[0]
    rec = {"rank_block_bytes": block, "free_before": free, "need": need, "waited_s": 0.0}
    if free < need and complete_started is not None:
        rec["waited_s"] = _wait_complete_child(complete_started)
        rec["free_after_wait"] = free = torch.cuda.mem_get_info()[0]
    mode = rec["mode"] = "double" if free >= need else "donate"
    print(f"tp 8B swap: free {free / 2**30:.2f} GiB, {TP} blocks of {block / 2**30:.2f} GiB "
          f"+ margin need {need / 2**30:.2f} GiB: {mode}", flush=True)
    source = {seed: {"checkpoint_path": None, "quantize": None, "seed": seed}
              for seed in (0, TP_SWAP_SEED)}
    first = _tp_wave(eng, prefix, suffixes, TP_SWAP_TOKENS)
    ptrs = group.on_ranks(launch.param_ptrs)
    epochs = [s["prefix_epoch"] for s in group.on_ranks(launch.engine_state)]

    def swap(seed, prior):
        t0 = time.perf_counter()
        if mode == "double":
            group.on_ranks(launch.stage_swap, source[seed], eng.model_config)
            launch.wait_staged(eng)
            load_s = time.perf_counter() - t0
            out, pause_s = backend.run_quiesced(lambda: group.on_ranks(launch.install_swap))
        else:
            load_s = 0.0
            out, pause_s = backend.run_quiesced(lambda: group.on_ranks(
                launch.donate_swap, source[seed], eng.model_config, source[prior]))
        return {"seed": seed, "driver_load_s": load_s, "pause_ms": pause_s * 1000.0,
                "install_ms": [r["install_ms"] for r in out],
                "load_ms": [r.get("load_ms") for r in out]}

    rec["to"] = swap(TP_SWAP_SEED, 0)
    second = _tp_wave(eng, prefix, suffixes, TP_SWAP_TOKENS)
    rec["back"] = swap(0, TP_SWAP_SEED)
    back = _tp_wave(eng, prefix, suffixes, TP_SWAP_TOKENS)
    rec["bound_ms"] = 2 * block / PEAK_BYTES_PER_S * 1000.0
    rec["epochs"] = [s["prefix_epoch"] for s in group.on_ranks(launch.engine_state)]
    rec["checks"] = {"ptrs_kept": group.on_ranks(launch.param_ptrs) == ptrs,
                     "swapped_tokens_differ": second != first,
                     "back_equals_first": back == first,
                     "epochs_bumped": rec["epochs"] == [e + 2 for e in epochs]}
    ok = all(rec["checks"].values())
    print(f"tp 8B swap ({mode}): pause {rec['to']['pause_ms']:.1f} / "
          f"{rec['back']['pause_ms']:.1f} ms, install ms a rank {rec['to']['install_ms']} / "
          f"{rec['back']['install_ms']} against a bound of {rec['bound_ms']:.2f}; checks "
          f"{rec['checks']} ok={ok}", flush=True)
    return ok, rec


def tp_plane_check(backend, prefix, suffixes) -> tuple[bool, dict]:
    """The prefix-KV plane over the tp group: the 5,488-token prefix
    prefilled and pinned (its local prefill timed), a wave against it;
    its pages exported (host transport: the ranks' kv-head blocks gathered
    into the driver's pinned memory, 1 GiB); every rank's cache cleared;
    the pages adopted (each rank its own block, 512 MiB); the wave again.
    Fails unless the pages hold the whole model's heads at tp 2's
    geometry, the waves are equal and no rank prefilled a prefix after the
    adoption. Prints export and adopt ms against the local prefill's."""
    import torch
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import adopt_pages, export_pages
    from k8s_llm_scheduler_tpu_torch.parallel import launch
    from k8s_llm_scheduler_tpu_torch.testing import clear_prefix_cache

    eng, group = backend.engine, backend.engine.rank_group
    group.on_ranks(clear_prefix_cache)
    t0 = time.perf_counter()
    key, _ = eng.pin_prefix(prefix)
    local_ms = (time.perf_counter() - t0) * 1000.0
    local = _tp_wave(eng, prefix, suffixes, TP_SWAP_TOKENS)
    t0 = time.perf_counter()
    pages = export_pages(eng, key, generation=0, filler="tp8b")
    export_ms = (time.perf_counter() - t0) * 1000.0
    group.on_ranks(clear_prefix_cache)
    before = group.on_ranks(launch.engine_state)
    t0 = time.perf_counter()
    adopt_pages(eng, pages)
    torch.cuda.synchronize()
    adopt_ms = (time.perf_counter() - t0) * 1000.0
    adopted = _tp_wave(eng, prefix, suffixes, TP_SWAP_TOKENS)
    after = group.on_ranks(launch.engine_state)
    cfg = eng.model_config
    rec = {"local_wave": local, "prefix_tokens": len(prefix), "pages_shape": list(pages.k.shape),
           "geometry": pages.geometry.describe(), "bytes": pages.nbytes,
           "bytes_a_rank": pages.nbytes // TP, "pinned_host": bool(pages.k.is_pinned()),
           "local_prefill_ms": local_ms, "export_ms": export_ms, "adopt_ms": adopt_ms,
           "prefix_prefills_after_adopt": [a["prefix_prefills"] - b["prefix_prefills"]
                                           for a, b in zip(after, before)]}
    rec["checks"] = {"whole_model_heads": (pages.k.shape[0] == cfg.n_layers
                                           and pages.k.shape[2] == cfg.n_kv_heads),
                     "geometry_tp": pages.geometry.tp == TP,
                     "tokens_equal": adopted == local,
                     "no_prefix_prefill": rec["prefix_prefills_after_adopt"] == [0] * TP}
    ok = all(rec["checks"].values())
    print(f"tp 8B plane: {rec['geometry']} pages {rec['pages_shape']} "
          f"({pages.nbytes / 2**30:.2f} GiB), local prefill {local_ms:.1f} ms, export "
          f"{export_ms:.1f} ms, adopt {adopt_ms:.1f} ms; checks {rec['checks']} ok={ok}",
          flush=True)
    return ok, rec


def tp_d2d_check(backend, prefix, suffixes, plane, complete_started) -> tuple[bool, dict]:
    """The plane's d2d transport between two tp groups: tp 8B's group (the
    filler, `backend`, its pinned 5,488-token prefix and `suffixes` from
    tp_plane_check, whose record is `plane`) and a second tp group of
    TP_MODEL at full width and depth from seed 0, built as tp 8B's but with
    TP_D2D_PAGES pages of paged KV, once cli complete's 8B child has exited
    (the card's free memory printed first). The second adopts the prefix's
    pages exported `d2d` by the first (each rank's 512 MiB block left in
    its export table, rank 1's behind a CUDA IPC handle; each adopter rank
    copies the filler's same-rank block device to device), then runs the
    wave; the page set is dropped; the second group closes. Fails unless it
    was built, the wave equals the first group's local prefill's, no
    adopter rank prefilled, neither group booked a tp collective for the
    export or the adoption, rank 1's handles were CUDA IPC, K1 and K2
    launched on both adopter ranks in its wave (counts zeroed just before
    it), and every filler rank's export table is empty once the page set
    is gone. Prints export and adopt ms beside the host arm's."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import adopt_pages, export_pages
    from k8s_llm_scheduler_tpu_torch.parallel import launch

    rec = {"waited_s": 0.0}
    if complete_started is not None:
        rec["waited_s"] = _wait_complete_child(complete_started)
    rec["free_before_build"] = torch.cuda.mem_get_info()[0]
    print(f"tp 8B d2d: free {rec['free_before_build'] / 2**30:.2f} GiB before the "
          f"adopter's build (waited {rec['waited_s']:.1f} s for cli complete's child)",
          flush=True)
    t0 = time.perf_counter()
    try:
        abackend = build_local_backend(
            TP_MODEL, device="cuda", seed=0, mesh_axes={"tp": TP}, graphs=False,
            temperature=0.0, packed_admission=False, num_pages=TP_D2D_PAGES,
            max_pages_per_seq=TP_D2D_PAGES, paged_attn="pallas",
            max_reason_tokens=TP_REASON_TOKENS, request_timeout_s=600.0,
            prewarm_idle_delay_s=NO_PREWARM_S)
    except Exception as exc:  # a check that failed, not the phase's end
        rec["error"] = f"{type(exc).__name__}: {exc}"
        print(f"tp 8B d2d: the adopter was not built ({rec['error']}) ok=False", flush=True)
        return False, rec
    rec["build_s"] = time.perf_counter() - t0
    try:
        eng, group = backend.engine, backend.engine.rank_group
        aeng, agroup = abackend.engine, abackend.engine.rank_group
        books = [g.on_ranks(launch.rank_collectives) for g in (group, agroup)]
        before = agroup.on_ranks(launch.engine_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pages = export_pages(eng, tuple(prefix), generation=0, filler="tp8b", transport="d2d")
        rec["export_ms"] = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        adopt_pages(aeng, pages)
        torch.cuda.synchronize()
        rec["adopt_ms"] = (time.perf_counter() - t0) * 1000.0
        booked = [g.on_ranks(launch.rank_collectives) for g in (group, agroup)]
        export_id = pages.k.export.export_id
        rec.update(pages_shape=list(pages.k.shape), bytes=pages.nbytes,
                   handles=[h["kind"] for pair in pages.k.export.handles for h in pair],
                   tables_held=group.on_ranks(launch.export_table))
        agroup.on_ranks(launch.reset_launch_counts)
        wave = _tp_wave(aeng, prefix, suffixes, TP_SWAP_TOKENS)
        rec["launches"] = agroup.on_ranks(launch.launch_counts)
        after = agroup.on_ranks(launch.engine_state)
        del pages
        gc.collect()
        rec["tables_after_drop"] = group.on_ranks(launch.export_table)
    finally:
        abackend.close()
    rec["prefix_prefills_after_adopt"] = [a["prefix_prefills"] - b["prefix_prefills"]
                                          for a, b in zip(after, before)]
    counts = rec["launches"]
    rec["checks"] = {"tokens_equal": wave == plane["local_wave"],
                     "no_prefix_prefill": rec["prefix_prefills_after_adopt"] == [0] * TP,
                     "no_collectives": booked == books,
                     "cuda_ipc": rec["handles"] == ["cuda", "cuda"] * (TP - 1),
                     "tables_held": rec["tables_held"] == [[export_id]] * TP,
                     "k1_k2_launched": (counts[0] == counts[1] and counts[0]["K1"] > 0
                                        and counts[0]["K2"] > 0),
                     "tables_empty": rec["tables_after_drop"] == [[]] * TP}
    ok = all(rec["checks"].values())
    print(f"tp 8B d2d: pages {rec['pages_shape']} ({rec['bytes'] / 2**30:.2f} GiB, "
          f"{rec['bytes'] // TP / 2**20:.0f} MiB a rank), adopter built in "
          f"{rec['build_s']:.1f} s; export {rec['export_ms']:.1f} ms, adopt "
          f"{rec['adopt_ms']:.1f} ms (host arm: export {plane['export_ms']:.1f}, adopt "
          f"{plane['adopt_ms']:.1f}); adopter launches {counts} | {_smi()} | checks "
          f"{rec['checks']} ok={ok}", flush=True)
    return ok, rec


def tp_loop_check(eng, prefix, suffixes) -> tuple[bool, dict]:
    """The resident loop over the tp group (the driver's resident thread
    deciding each iteration, the follower's running what it sends): the
    suffixes admitted one call on the dispatch path and drained by
    decode_fused, then through the command ring and step_persistent. Fails
    unless the streams are equal, every rank's counter block agrees, and
    K1 and K2 launched in the loop's admissions, equal across the ranks."""
    from k8s_llm_scheduler_tpu_torch.parallel import launch

    group = eng.rank_group
    eng.set_prefix(prefix)
    eng.set_grammar(None)
    ids = eng.add_requests(suffixes, max_new_tokens=TP_LOOP_TOKENS)
    done = {}
    while len(done) < len(ids):
        done.update({f.req_id: f.token_ids for f in eng.decode_fused()})
    want = [done[i] for i in ids]
    group.on_ranks(launch.reset_launch_counts)
    t0 = time.perf_counter()
    entered = eng.enter_persistent()
    ids = eng.add_requests(suffixes, max_new_tokens=TP_LOOP_TOKENS)
    out = _drain_resident(eng, len(ids))
    eng.exit_persistent()
    wall = time.perf_counter() - t0
    states = group.on_ranks(launch.engine_state)
    counts = group.on_ranks(launch.launch_counts)
    counters = [s["counters"] for s in states]
    rec = {"suffix_tokens": [len(x) for x in suffixes], "tokens": TP_LOOP_TOKENS,
           "wall_s": wall, "counters": counters, "launches": counts,
           "admissions": [s["persistent_admissions"] for s in states]}
    rec["checks"] = {"entered": entered,
                     "tokens_equal": [out.get(i) for i in ids] == want,
                     "counters_agree": counters[0] == counters[1] and bool(counters[0]),
                     "k1_k2_in_admissions": (counts[0] == counts[1] and counts[0]["K1"] > 0
                                             and counts[0]["K2"] > 0)}
    ok = all(rec["checks"].values())
    print(f"tp 8B resident: {len(suffixes)} streams of {TP_LOOP_TOKENS} in {wall:.1f} s, "
          f"counters a rank {counters[0]}, launches {counts}; checks {rec['checks']} ok={ok}",
          flush=True)
    return ok, rec


def tp_8b_phase(ref, tp1_per_call, complete_started=None,
                after_d2d=None) -> tuple[bool, dict]:
    """Llama-3.1-8B at full width and depth served tensor parallel: TP
    ranks, this process and one it spawns, sharing the card over gloo,
    eager (gloo's host collectives cannot be captured), each rank's shard
    drawn from seed 0 in the full tree's order. Rank 0's first-call logits
    against the tp=1 engine's (`ref`), one decision and a burst of
    TP_PODS that name feasible nodes, one path-B generate through K4, each
    rank's K1/K2/K4 launches and K1 launches per model call against tp
    1's (`tp1_per_call`), wall time and each rank's peak memory. Then, in
    the same group: the hot swap (tp_swap_check), the prefix-KV plane
    (tp_plane_check), the plane's d2d transport to a second group
    (tp_d2d_check; `after_d2d` is called once that group is closed) and
    the resident loop (tp_loop_check)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.parallel import launch
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    nodes, pods = synthetic_nodes(TP_NODES), fixture_pods(TP_PODS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = build_local_backend(
        TP_MODEL, device="cuda", seed=0, mesh_axes={"tp": TP}, graphs=False,
        temperature=0.0, packed_admission=False, max_pages_per_seq=64, paged_attn="pallas",
        max_reason_tokens=TP_REASON_TOKENS, request_timeout_s=600.0,
        prewarm_idle_delay_s=NO_PREWARM_S, persistent_loop=True,
        persistent_suffix_bucket=TP_LOOP_BUCKET)
    # the decisions stay on the wave path (their K1-per-call checks); the
    # resident loop is driven through the engine by tp_loop_check
    backend._persistent_loop = False
    rec = {"model": TP_MODEL, "tp": TP, "build_s": time.perf_counter() - t0}
    try:
        eng, group = backend.engine, backend.engine.rank_group
        rec["backend"] = eng.plane.backend
        rec["ranks"] = eng.mesh.axis_ranks("tp")
        rec["rank_geometry"] = {"n_heads": eng.cfg.n_heads, "n_kv_heads": eng.cfg.n_kv_heads,
                                "head_dim": eng.cfg.head_dim, "d_ff": eng.cfg.d_ff}
        print(f"tp 8B: {TP} ranks {rec['ranks']} over {rec['backend']}, built in "
              f"{rec['build_s']:.1f} s, rank geometry {rec['rank_geometry']}", flush=True)
        first = group.on_ranks(launch.prefill_logits, ref["ids"])
        want = ref["logits"]
        err = (first[0] - want).abs().max().item()
        scale = want.abs().max().item()
        rec["first_call"] = {"tokens": len(ref["ids"]), "max_abs_err": err,
                             "max_abs_ref": scale, "rel_err": err / scale, "tol": TP_LOGIT_TOL,
                             "ranks_equal": bool(torch.equal(first[0], first[1])),
                             "finite": bool(torch.isfinite(first[0]).all())}
        logits_ok = (rec["first_call"]["rel_err"] <= TP_LOGIT_TOL
                     and rec["first_call"]["ranks_equal"] and rec["first_call"]["finite"])
        group.on_ranks(launch.reset_launch_counts)
        t1 = time.perf_counter()
        with launches_by_step(eng) as steps:
            single = backend.get_scheduling_decision(pods[0], nodes)
            rec["single_s"] = time.perf_counter() - t1
            t2 = time.perf_counter()
            burst = backend.get_scheduling_decisions_batch(pods, nodes)
            rec["burst_s"] = time.perf_counter() - t2
        decisions = [(pods[0], single)] + list(zip(pods, burst))
        bad = [d for _, d in decisions if isinstance(d, Exception)]
        decide_ok = not bad and _feasible(nodes, decisions)
        rec["decisions"] = [None if isinstance(d, Exception) else d.selected_node
                            for _, d in decisions]
        rec["decision_errors"] = [repr(d) for d in bad]
        rec["decision_launches"] = group.on_ranks(launch.launch_counts)
        rec["model_calls"] = {k: eng.stats[k] for k in ("wave_model_calls", "wave_block_calls",
                                                         "waves", "prefix_prefills")}
        rec["k1_per_call_by_step"] = _tp_per_call(steps)
        # K1 launches per model call of each step, against tp 1's: one a
        # layer (every rank runs K1 on its own heads in one launch)
        same = {step: k1 == tp1_per_call[step] for step, k1 in rec["k1_per_call_by_step"].items()
                if step in tp1_per_call}
        rec["k1_per_call_as_tp1"] = same
        calls_ok = bool(same) and all(same.values()) and all(
            k1 == eng.cfg.n_layers for step, k1 in rec["k1_per_call_by_step"].items()
            if step.startswith(("suffix prefill", "block decode")))
        item = backend._prepare_item(pods[0], nodes)
        eng.set_prefix(item.prefix_ids)
        eng.set_grammar(None)
        t3 = time.perf_counter()
        gen = eng.generate(item.suffix_ids, max_new_tokens=TP_GEN_TOKENS)
        rec["generate"] = {"tokens": len(gen.token_ids), "s": time.perf_counter() - t3,
                           "paged_attn": eng.paged_attn}
        rec["launches"] = group.on_ranks(launch.launch_counts)
        rec["peak_memory"] = group.on_ranks(launch.peak_memory)
        rec["wall_s"] = time.perf_counter() - t0
        counts = rec["launches"]
        launch_ok = (counts[0] == counts[1] and all(counts[0][k] > 0 for k in ("K1", "K2", "K4"))
                     and counts[0]["K3"] == 0)
        gen_ok = len(gen.token_ids) == TP_GEN_TOKENS
        items = [backend._prepare_item(p, nodes) for p in pods]
        t4 = time.perf_counter()
        swap_ok, rec["swap"] = tp_swap_check(backend, items, complete_started)
        rec["swap"]["s"] = time.perf_counter() - t4
        plane_items = [backend._prepare_item(p, synthetic_nodes(TP_PLANE_NODES)) for p in pods]
        t4 = time.perf_counter()
        plane_suffixes = [it.suffix_ids for it in plane_items]
        plane_ok, rec["plane"] = tp_plane_check(backend, plane_items[0].prefix_ids,
                                                plane_suffixes)
        rec["plane"]["s"] = time.perf_counter() - t4
        t4 = time.perf_counter()
        d2d_ok, rec["d2d"] = tp_d2d_check(backend, plane_items[0].prefix_ids, plane_suffixes,
                                          rec["plane"], complete_started)
        rec["d2d"]["s"] = time.perf_counter() - t4
        if after_d2d is not None:
            after_d2d()
        t4 = time.perf_counter()
        loop_ok, rec["persistent"] = tp_loop_check(eng, items[0].prefix_ids,
                                                   [it.suffix_ids for it in items])
        rec["persistent"]["s"] = time.perf_counter() - t4
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        backend.close()
    ok = (logits_ok and decide_ok and calls_ok and launch_ok and gen_ok and swap_ok
          and plane_ok and d2d_ok and loop_ok)
    rec["checks"] = {"logits": logits_ok, "decisions": decide_ok, "k1_per_call": calls_ok,
                     "launches": launch_ok, "generate": gen_ok, "swap": swap_ok,
                     "plane": plane_ok, "d2d": d2d_ok, "persistent": loop_ok}
    print(f"tp 8B: first call rel err {rec['first_call']['rel_err']:.4g} (tol {TP_LOGIT_TOL}), "
          f"single {rec['single_s']:.1f} s, burst of {TP_PODS} {rec['burst_s']:.1f} s, "
          f"generate {rec['generate']['tokens']} tokens {rec['generate']['s']:.1f} s, "
          f"model calls {rec['model_calls']}, "
          f"launches {counts}, K1/call {rec['k1_per_call_by_step']} (tp 1: {same}), "
          f"peak {rec['peak_memory']}, wall {rec['wall_s']:.1f} s | {_smi()} | "
          f"checks {rec['checks']} ok={ok}", flush=True)
    return ok, rec


def _timed_phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the full record to this JSON file")
    parser.add_argument("--train-parallel-child", metavar="FILE",
                        help="run phase 6n alone (the smoke's child) and write its record")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from k8s_llm_scheduler_tpu_torch.ops import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    if args.train_parallel_child:
        ok, rec = train_parallel_phase()
        Path(args.train_parallel_child).write_text(json.dumps(rec, indent=1))
        return 0 if ok else 1

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    reports = kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(reports)} libraries in {build_s:.1f} s", flush=True)
    print_ptxas(reports)

    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    # cli verify's child (TINY) runs beside cli run's; no other 8B model is
    # resident on the card while cli run's child holds one
    verify_child = start_verify()
    run_ok, run = _timed_phase("cli run", run_phase)
    v_ok, verify = _timed_phase("cli verify", finish_verify, verify_child)
    nodes = synthetic_nodes(32)
    pods = fixture_pods(8)
    backend, backend_s = build_backend()
    try:
        k1_cases, k2_cases = path_shapes(backend, nodes, pods, N_SINGLES)
        k_ok, k1, k2 = _timed_phase("kernels", kernel_phase, k1_cases, k2_cases)
        r_ok, ref = _timed_phase("reference", reference_phase)
        d_ok, dec = _timed_phase("decision", decision_phase, backend, backend_s, nodes, pods)
        sw_ok, swap = _timed_phase("swap 8B", swap_8b, backend, nodes, pods)
        adm_ok, adm = _timed_phase("admission", admission_phase, backend.engine, nodes, pods,
                                   dec["batch_tokens"])
        l_ok, loop = _timed_phase("loop", loop_phase, backend.engine)
        fl_ok, fleet = _timed_phase("fleet", fleet_phase, backend.engine)
        kv_ok, kvplane = _timed_phase("kvplane 8B", kvplane_8b, backend.engine)
        sim_ok, simrec = _timed_phase("sim", sim_phase, backend)
        rs_ok, resident = _timed_phase("resident", resident_phase, backend.engine, nodes)
        # the TINY children of cli demo and spec's (f) run beside path A
        demo_child, spec_children = start_demo(), start_spec_complete()
        a_ok, path_a, totals = _timed_phase("path A", path_a_phase, backend, nodes, pods)
        c_ok, demo = _timed_phase("cli demo", finish_demo, demo_child)
        torch.cuda.empty_cache()
        b_ok, path_b, k4_cases = _timed_phase("path B", path_b_phase, backend, nodes, pods)
        f_ok, fused = _timed_phase("fused", fused_phase, backend, nodes, pods, path_b)
        p8_ok, pers8 = _timed_phase("persistent 8B", persistent_8b, backend, nodes, pods)
        sp_ok, spec = _timed_phase("spec", spec_phase, backend, nodes, pods, spec_children)
        h8_ok, hidden = _timed_phase("hidden 8B", hidden_8b, backend, nodes, pods)
        k1 += spec["k1_cases"]
        cfg = backend.engine.cfg
        tp_ref = tp_reference(backend.engine, synthetic_nodes(TP_NODES), fixture_pods(TP_PODS))
    finally:
        backend.close()
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    # cli complete's child builds its own 8B model and train parallel 1B's
    # child trains its layouts; tp 8B's two ranks, the TINY phases, train 1B
    # and learn 1B run beside them, the timed kernel phases after them
    complete_child = start_complete()
    # train parallel 1B's child starts once tp 8B's d2d arm has closed its
    # second group: that group, tp 8B's and the training child's step do
    # not fit on the card at once, nor the swap's staging beside cli
    # complete's 8B child and that step
    train_par = {}

    def start_train_par():
        train_par["child"] = start_train_parallel()

    tp_ok, tp8 = _timed_phase("tp 8B", tp_8b_phase, tp_ref, dec["k1_per_call_by_step"],
                              complete_child, after_d2d=start_train_par)
    train_par_child = train_par["child"]
    gc.collect()
    torch.cuda.empty_cache()
    ck_ok, ckpt = _timed_phase("checkpoint", checkpoint_phase)
    s_ok, sampled = _timed_phase("sampled", sampled_phase)
    pt_ok, pers_tiny = _timed_phase("persistent TINY", persistent_tiny)
    jr_ok, journal_restart = _timed_phase("journal restart", journal_restart_phase)
    ro_ok, rollout = _timed_phase("rollout TINY", rollout_tiny)
    cc_ok, complete = _timed_phase("cli complete", finish_complete, complete_child)
    with tempfile.TemporaryDirectory() as train_dir:
        tr_ok, train = _timed_phase("train 1B", train_1b, Path(train_dir))
        ln_ok, learn = _timed_phase("learn 1B", learn_1b, train["checkpoint"])
    # the timed kernel phases want the card to themselves
    tpar_ok, train_par = _timed_phase("train parallel 1B", finish_train_parallel,
                                      train_par_child)
    k3_ok, k3 = _timed_phase("K3", k3_phase, cfg, totals)
    k4_ok, k4 = _timed_phase("K4", k4_phase, k4_cases, long_cases=[k4_long_case()])
    tpk_ok, tpk = _timed_phase("tp kernels", tp_kernel_phase)

    def tp_fields(kernel):
        # each rank's launches in the tp 8B phase's run and in its d2d
        # adopter's wave, and the kernel at one rank's shapes (70B tp 8
        # timed, 8B tp 2 held)
        return {"tp_launches": {f"rank{r}": c[kernel] for r, c in enumerate(tp8["launches"])},
                "tp_d2d_launches": {f"rank{r}": c[kernel] for r, c in enumerate(
                    tp8["d2d"].get("launches") or [])},
                "tp_shapes": [{k: rec.get(k) for k in (
                    "step", "shape", "ok", "max_abs_err", "ms", "ms_hot", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")} for rec in tpk.get(kernel, [])]}

    def entry(name, recs, source, replaces, launches, main, **extra):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **extra,
            "shapes": recs,
        }

    def kvplane_launches(kernel):
        # the adopter's wave after each adoption, and each replica's burst
        eng, back = kvplane["engine"], kvplane["backend"]
        return {"adopt_host": eng["host"][kernel], "adopt_d2d": eng["d2d"][kernel],
                **{f"{burst}_{r}": back[burst][r][kernel] for burst in ("burst_1", "burst_2")
                   for r in ("replica_0", "replica_1")}}

    def widest_suffix_prefill(recs):
        # K1/K2 headline: the batch's suffix prefill, the widest wave call
        return max((r for r in recs if r["step"] == "suffix prefill"),
                   key=lambda r: r["flops"])

    # K3 headline: int8 w_gate at R=8 and the batch's median total; K4:
    # partials at the step shape after one chunk, beside the long shape
    k3_main = next((r for r in k3 if r["int8"] and r["weight"] == "w_gate"
                    and r["step"] == "R=8" and r.get("median_total")),
                   max((r for r in k3 if "ms" in r), key=lambda r: r["flops"]))
    k1_main = widest_suffix_prefill(k1)
    k2_main = widest_suffix_prefill(k2)
    k4_main = next(r for r in k4 if r["mode"] == "parts"
                   and r["step"] == "step after one chunk")
    k4_long = next(r for r in k4 if r["step"] == K4_LONG[0])
    line = {
        "kernels": [
            entry("flash_prefix_attention_parts", k1,
                  "k8s_llm_scheduler_tpu_torch/csrc/prefix_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:365",
                  dec["launches"]["K1"], k1_main, ms_hot=k1_main["ms_hot"],
                  library_ms_hot=k1_main["library_ms_hot"], cold_l2=True,
                  launches_by_step=dec["k1_launches_by_step"],
                  loop_launches=loop["launches"]["K1"],
                  run_launches=(run["launches"] or {}).get("K1"),
                  complete_launches=(complete.get("launches") or {}).get("K1"),
                  persistent_launches=(pers8.get("launches") or {}).get("K1"),
                  spec_launches=spec["k1_spec_launches"],
                  hidden_8b_launches=hidden["serve"]["launches"]["K1"],
                  train_1b_decision_launches=train["decision_launches"]["K1"],
                  learn_launches={k: (v or {}).get("K1") for k, v in learn["launches"].items()
                                  if k in ("mine", "cycle_mine", "weakness_gate", "arena_gate")},
                  fleet_launches={"coordinator": fleet["fanout"]["coordinator_launches"]["K1"],
                                  "worker": fleet["fanout"]["worker_launches"]["K1"],
                                  "router_big": fleet["router"]["arm_launches"]["big"]["K1"],
                                  "router_fast": fleet["router"]["arm_launches"]["fast"]["K1"]},
                  kvplane_launches=kvplane_launches("K1"),
                  spec_verify={r["shape"]: {k: r.get(k) for k in (
                      "ms", "ms_hot", "plain_ms", "bound_ms", "library_ms", "bound_share")}
                      for r in spec["k1_cases"]},
                  pack_chunk={k: v for k, v in next(
                      r for r in k1 if r["step"] == "pack chunk").items() if k in (
                      "shape", "ms", "ms_hot", "plain_ms", "bound_ms", "library_ms")},
                  pack_chunk_launches=adm["packed_batch"]["pack_chunk_k1"], **tp_fields("K1")),
            entry("flash_causal_attention_parts", k2,
                  "k8s_llm_scheduler_tpu_torch/csrc/causal_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:285",
                  dec["launches"]["K2"], k2_main, ms_cold=k2_main["ms_cold"],
                  ratio=k2_main["ratio"], loop_launches=loop["launches"]["K2"],
                  run_launches=(run["launches"] or {}).get("K2"),
                  complete_launches=(complete.get("launches") or {}).get("K2"),
                  persistent_launches=(pers8.get("launches") or {}).get("K2"),
                  train_1b_decision_launches=train["decision_launches"]["K2"],
                  learn_launches={k: (v or {}).get("K2") for k, v in learn["launches"].items()
                                  if k in ("mine", "cycle_mine", "weakness_gate", "arena_gate")},
                  fleet_launches={"coordinator": fleet["fanout"]["coordinator_launches"]["K2"],
                                  "worker": fleet["fanout"]["worker_launches"]["K2"],
                                  "router_big": fleet["router"]["arm_launches"]["big"]["K2"],
                                  "router_fast": fleet["router"]["arm_launches"]["fast"]["K2"]},
                  kvplane_launches=kvplane_launches("K2"), **tp_fields("K2")),
            entry("ragged_matmul", k3,
                  "k8s_llm_scheduler_tpu_torch/csrc/ragged_matmul.cu",
                  "k8s_llm_scheduler_tpu/ops/ragged_matmul.py:108",
                  path_a["launches"]["K3"], k3_main, ms_hot=k3_main["ms_hot"],
                  library_ms_hot=k3_main["library_ms_hot"], cold_l2=True,
                  **tp_fields("K3"), tp_note="refused at tp > 1, as in the JAX engine"),
            entry("paged_decode_attention", k4,
                  "k8s_llm_scheduler_tpu_torch/csrc/paged_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_paged_attention.py:276",
                  path_b["launches"]["K4"], k4_main, status="redesigned PR 7",
                  fused_launches=fused["launches"]["K4"],
                  ms_hot=k4_main["ms_hot"], library_ms_hot=k4_main["library_ms_hot"],
                  cold_l2=True, splits=k4_main.get("splits"),
                  long={k: k4_long[k] for k in ("shape", "ms", "bound_ms", "library_ms",
                                                "splits") if k in k4_long},
                  **tp_fields("K4")),
        ],
        "not_ported": [],
    }
    phases = {"cli_verify": v_ok, "cli_run": run_ok, "kernels": k_ok, "reference": r_ok,
              "decision": d_ok, "swap_8b": sw_ok, "admission": adm_ok, "loop": l_ok,
              "cli_demo": c_ok, "sim": sim_ok, "resident": rs_ok,
              "path_a": a_ok, "path_b": b_ok, "fused": f_ok, "persistent_8b": p8_ok,
              "spec": sp_ok, "hidden_8b": h8_ok, "fleet": fl_ok, "kvplane_8b": kv_ok,
              "checkpoint": ck_ok, "sampled": s_ok, "persistent_tiny": pt_ok,
              "journal_restart": jr_ok, "rollout_tiny": ro_ok, "cli_complete": cc_ok,
              "train_1b": tr_ok, "learn_1b": ln_ok, "tp_8b": tp_ok,
              "train_parallel_1b": tpar_ok,
              "k3": k3_ok, "k4": k4_ok, "tp_kernels": tpk_ok}
    record = {"device": kind, "smi": smi, "build_s": build_s, "kernels": line,
              "cli_verify": verify, "cli_run": run, "reference": ref, "decision": dec,
              "swap_8b": swap, "admission": adm, "loop": loop, "cli_demo": demo,
              "sim": simrec, "resident": resident, "rollout_tiny": rollout, "path_a": path_a,
              "path_b": path_b, "fused": fused, "persistent_8b": pers8, "spec": spec,
              "hidden_8b": hidden, "train_1b": train, "fleet": fleet, "kvplane_8b": kvplane,
              "learn_1b": learn, "tp_8b": tp8, "tp_kernels": tpk,
              "train_parallel_1b": train_par,
              "checkpoint": ckpt, "sampled": sampled, "persistent_tiny": pers_tiny,
              "journal_restart": journal_restart, "cli_complete": complete,
              "phases_ok": phases}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    if not all(phases.values()):
        print(f"chip_smoke: FAILED phases {record['phases_ok']}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
