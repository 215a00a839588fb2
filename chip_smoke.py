#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # adds a torch.profiler pass after each path
                                     # (and gates K1/K5/K7 inside graph replays)

Phases (any failure exits non-zero; no phase's failure is caught):
  0. the card: `nvidia-smi` name and power limit, compute capability 9.0;
  1. build the CUDA kernels from ray_tpu_torch/csrc with nvcc (sm_90a) and
     print each kernel's registers and spills from ptxas' report;
  2. each kernel against its plain PyTorch version on the card, in bf16
     and f32, at the serving path's shapes: max error against the stated
     tolerance, device time (CUDA events, L2 flushed before each call, host
     launch overhead excluded; see device_ms), the plain version's time,
     the least time the card could take (bound), and one PyTorch library
     call computing the same function where one exists;
     K1's forward at every shape of the three paths (decode [8, 4096],
     verify [40, 4096], a prefill chunk [256, 4096], in bf16 and f32, and
     the training block [8192, 2560] with bf16 x and f32 w) and its backward
     (rms_norm_bwd) at the training shape and at [8, 4096], each beside the
     one-element floor (a one-element PyTorch kernel under device_ms); the
     backward's dw must be bit-identical over two calls, and the profiler
     must show both kernels by name; checked, untimed, at moe-1b's width
     (forward [8|40|256, 1536] in bf16 and f32 and [2048, 1536]; backward
     [2048, 1536] in bf16 and f32) and the backward with phase 4f's bf16
     weights at [8192, 2560] (norm_checks);
     K2 also with its lse output, and the backward kernels K3 (dq) and K4
     (dk, dv) at the training shape (llama-2b: B=4, T=2048, 20/5 heads of
     128), at a ragged T, at g = 1 and at moe-1b's training shape (B=2,
     T=1024, 12/4 heads: g = 3); K2 untimed at moe-1b's prefill shapes;
     K5, K6 and K7 also at moe-1b's heads (g = 3, so one position's query
     heads straddle the 64-row tiles) at the engine's batch, chunks and
     verify widths S = 1, 2, 3, 5; K5 (split-KV decode) at the
     engine's batch and at its edges: one sequence of 1024 keys, lengths at
     split boundaries +- 1, lengths past the table, g = 1 and g = 8, two
     calls back to back, and at page size 8 (phase 3m (b)'s destination:
     the engine's batch over 128 pages of 8 a sequence, lengths off the
     page edges and at split edges +- 1); K6 (paged chunked prefill) at the chunks of a
     700-token prompt and at its edges: key tiles +- 1, a ragged C, total
     below start + C, keys past the table, no visible key (exact zeros),
     g = 1 and g = 8, each also with [start, total] as int32 on the card
     (bit-identical to the int form); K7 (speculative verify attention, split-KV on the
     tensor cores) at the engine's span (B=8, S=5) and at S = 1 (where it
     must also equal K5), S = 2, S = 65, g = 1, g = 8, inactive slots, a
     span past the table, positions at split edges +- 1, spans crossing a
     split, one sequence of 1024 keys, and two calls back to back.
     First, at every K2, K3 and K4 shape and at K6's and K7's engine
     shapes, a profiler pass around one launch must show the kernel that
     (dtype, head_dim) selects: the tensor-core (wgmma) tile for bf16, the
     FMA tile for f32 (tile_identity_checks);
  3. the serving path: LLMServer serving llama3-8b at full width and depth
     (random weights from a seed) with five concurrent requests — short
     prompts (bucketed prefill, kernel K2), a ~700-token prompt (chunked
     prefill, K6), one request sampled at temperature 0.8 / top_p 0.9 —
     32 tokens each. The server captures every device program as a CUDA
     graph at warm-up: decode spans, the chunk and the bucketed prefill
     per bucket (its build time, the capture's share, the graph pools'
     size and the prefill thread's share of both are printed, and what
     prefill_batch_size=8 would take is reckoned from them). Launch counts
     are reset just before and read just after; every serving kernel
     (SERVE_KERNELS) must have run, and every launch must have come from
     a graph replay (dispatch counts replayed launches apart). Each
     prefill replay's wait behind the stream's earlier work is printed
     (PrefillClock). The
     engine's logprobs are held against log-softmax of the port's own
     `forward` over prompt + output; as negative controls, the same burst
     with fresh prompts is served once per planted engine fault (FAULTS),
     each on a server built inside the fault's block so that the fault is
     captured into its graphs, and the gate must fail each. After the
     plain burst its telemetry is printed beside what the burst measured
     (telemetry_report: the serve_* counters and histogram counts, the SLO
     digests' TTFT p50 and max against the burst's within the digest's
     12.2 % relative error, the time-between-tokens p50 against TPOT, and
     the host time the telemetry takes on the engine's threads during the
     burst, per decode span: TelemetryClock); none of it decides the run;
  3m. KV migration (migrate_path), on phase 3's server before it shuts
     down: a second engine over the same parameter tensors imports what
     phase 3's exports (Request(prefill_only=True)): prompts of 200 tokens
     (bucketed prefill, K2) and 700 (chunked, K6), each a fresh prompt.
     (a) page size 16: each length as a one-shot blob and as a layer-major
     stream (kv_window 256), imported alone, must continue for 32 tokens
     exactly as the source's own run of the prompt; each planted import
     fault (IMPORT_FAULTS: the last layer slab not ingested, the staged KV
     scattered one page late) must fail that gate; then four requests
     decode on each engine, alone and then while the blobs and streams of
     fresh prompts migrate. (b) page size 8: the layer-major and
     token-major streams; under load and (b) are held to phase 3's logprob
     gate. Launch counts are read around each export and import of (a)
     (round_trip) and around (b): K1, K2, K5 and K6 must have run, every
     launch from a graph replay. Prints the bytes on the wire, each
     export's gather + host copy, the first frame's time after the first
     token, the import's staging, the export's host copy in its two forms
     (host_copy_forms), the gathers' and scatters' waits behind the
     stream's earlier work (CallClock, of which PrefillClock is one), and
     the background requests' TPOT and longest gap between tokens with and
     without migrations;
  3w. live weights (live_path), on phase 3's server after 3m: first what
     a readback in one thread does to another's enqueue (readback_probe,
     printed); the seed-1 llama3-8b tree is built on the card and a fresh
     engine over it, which answers three fresh prompts (bucketed, 200 and
     700 tokens: K2 and K6); four greedy streams of 96 tokens decode while
     server.update_weights swaps it in, and a 200-token prefill submitted
     inside the swap must run on the new weights (every stream
     token-valid, version stamps 0 or 1, stats and the
     serve_weights_version gauge at 1; the swap's time on the card, where
     its host time went (SwapClock), the wait for the replay lock, the
     streams' longest gap between tokens against four streams without an
     update and four beside a prefill, and the prefill's TTFT against the
     same prefill on the idle server and beside the streams are printed);
     then the three prompts served alone on the updated server must agree
     with the fresh engine's token for token with bit-identical logprobs,
     and pass phase 3's logprob gate under the seed-1 forward; launch
     counts around the update and these requests, the fresh engine's
     outside them: K1, K2, K5 and K6 ran, all from graph replays. Each planted
     update fault (LIVE_FAULTS: the f32 head copy not refreshed, the last
     layer's FFN output projection not copied), applied from the seed-0
     weights, must fail that exactness gate. The seed-0 weights are then
     restored, bit-exact by per-leaf checksums and the head copy; the
     planted-fault servers and phase 3s after it run on them;
  3r. the task/actor runtime (runtime_path), on phase 3's tensors after 3w,
     before phase 3's server shuts down: ray_tpu_torch.init() in thread
     mode; (a) cluster_resources()["GPU"] equals the CUDA device count, a
     second num_gpus=1 actor stays pending while the first lives and
     places after kill, and a placement group's {"GPU": 1} bundle takes an
     actor (planted: an agent that does not hold a created actor's GPU,
     which the pending gate must catch); (b) put of the 16.06 GB parameter
     tree and get of its ref return the same tensors (data_ptr), with the
     put/get times and the process RSS around them printed and RSS growth
     under RSS_GROWTH_MAX (planted: a seal_value that pickles device
     trees, on a 64 MiB tree, which the identity gate must catch); (c) a
     num_gpus=1 task runs K1 (ops.rms_norm) on a [8, 4096] bf16 activation
     that arrives as a ref, within TOL of the plain version, K1's launch
     count rising; the task's round trip p50/p99 over 200 tasks beside the
     direct call's; (d) a GPU actor (num_gpus=1, max_concurrency=8)
     builds an LLMServer over the tree's ref (the same tensors) and serves
     phase 3's five prompts submitted concurrently through its handle:
     every request its 32 tokens, phase 3's logprob gate, TTFT/TPOT/tok/s
     beside phase 3's direct figures, greedy agreement printed; (e)
     update_weights({"ref": ..., "version": 2}) through the handle, the
     ref that of a tree whose final norm has a seeded half of its signs
     flipped, reports version 2, writes the ref's values into phase 3's
     tensors, and a 12-token prompt's logprobs then pass phase 3's gate
     against the forward over that tree and fail it against the old one;
     a second update (version 3) restores phase 3's tensors and tokens;
     (f) a call parked behind eight on the actor fails with RayActorError
     on kill, and no thread started in the phase outlives shutdown().
     Launches are counted from before (c) to the end of (d)'s burst and
     over (e)'s prompts and updates, the yardstick forwards left out: K1,
     K2, K5 and K6 must have run;
  3d. the serve runtime (deploy_path), on phase 3's tensors after 3r,
     before phase 3's server shuts down: serve.run(LLMServer.options(
     num_replicas=2).bind(model_name="llama3-8b", params_fn=<phase 3's
     tensors>, engine_config=ENGINE)) starts two replicas on the card over
     the same tensors (process RSS and card memory read around their
     build; a copy of the tree must not show); each replica's readiness
     and capture time; phase 3's burst of fresh prompts through the handle
     (every response carries its own request_id), then one 12-token greedy
     prompt whole and streamed through the handle (the same tokens); then
     build_openai_app over the same tensors (IdTokenizer, so that a
     returned text gives back its token ids) behind serve.http_port():
     /-/healthz, the burst as concurrent SSE streams with logprobs, a
     completion whole and streamed (the
     stream whole: 32 one-token chunks, a terminal chunk with its
     finish_reason, [DONE]; its text the whole completion's), a chat
     completion and /v1/models. Every response passes phase 3's logprob
     gate against the forward over its own prompt and output; both
     replicas served requests (ServeReplica.stats); every launch came from
     a graph replay; each planted DEPLOY_FAULTS entry (the handle hands
     two requests each other's responses; the proxy's event stream loses
     its last chunk) must fail its gate; no thread the phase started
     outlives serve.shutdown(). Prints TTFT, TPOT and tokens/s through the
     handle (the engine's clock; the hop from call to result beside it)
     and through HTTP (the client's clock, with each response's headers)
     beside phase 3's direct burst, peak card memory and the phase's
     wall. Launches are counted over the handle and HTTP sections, the
     replicas' warm-up and the yardstick forwards left out: K1, K2, K5 and
     K6 must have run;
  3g. disaggregated prefill/decode serving (disagg_path), on phase 3's
     tensors after 3d, before phase 3's server shuts down: a prefill-role
     and a decode-role LLMServer (build and capture time per role) behind
     DisaggCoordinator([EngineWorker], [EngineWorker]). (a) each greedy
     prompt of a fresh burst (23/100/200/700 tokens, 32 out), alone, on
     the decode engine itself and then through the coordinator under the
     stream, channel and object transports: tokens and logprobs bit for
     bit the decode engine's (exact_gate); four requests decoding on the
     decode engine, alone and while two 700-token prompts migrate into it
     (TPOT, longest gap). (b) a fresh burst at once, the sampled request
     included: phase 3's logprob gate; its TTFT/TPOT/tok/s beside phase
     3's and 3d's. (c) (a)'s 700-token prompt, warm on the decode engine,
     through a coordinator with prefix routing on: no prefill hop, zero
     migration bytes, kv_migrations unchanged, exact against (a). Per
     request: TTFT, the prefill leg's prefill_s, migration seconds and
     bytes, TPOT. (e) each planted DISAGG_FAULTS entry on the KV sender's
     channel (two requests' frames crossed in one flush; a request's last
     frame lost, which must fail with KvMigrationError within
     kv_stream_idle_s and leave the next request exact and the decode
     pages free) must fail its gate. (d) build_openai_app(disagg=...)
     (deploy_disagg through the serve runtime) over the same tensors
     behind serve.http_port(): a coordinator over the role deployments and
     greedy SSE completions one at a time give (a)'s tokens; a burst as
     concurrent SSE streams comes back whole (TTFT/TPOT/tok/s on the
     client's clock), and one as concurrent whole completions passes phase
     3's logprob gate; no thread the phase started outlives
     serve.shutdown(), and the card
     memory left after the replicas retire stays within
     SERVE_RETIRED_MEMORY_TOL (split by kind, memory_split: graph pools,
     f32 head copies, cuBLAS workspaces, the rest, cached blocks; and the
     allocation sites of what is left, from the allocator's recorded
     stacks). Launches are counted only while the
     coordinators serve (a)-(c) and (d); the decode engine's own runs, the
     builds, the planted runs and the yardstick forwards are left out: K1,
     K2, K5 and K6 must have run, every launch from a graph replay;
  3f. the health plane and the serve fleet (fleet_path), on phase 3's
     tensors after 3g, before phase 3's server shuts down: the process's
     HealthPlane with the stock rules (FLEET_SYSTEM_CONFIG: queue_depth past
     4 requests for two passes 0.25 s apart), deploy_disagg with one
     prefill and one decode replica, and a FleetController(FLEET_CONFIG:
     one to two replicas a role, 0.5 s evaluations, no cooldown, three idle
     evaluations, the default pressure past two waiting requests a replica,
     legs a replica runs, or will have run before another could be built,
     not counted as waiting) acting
     through the serve controller. (a) a burst of 16
     greedy requests (23/100/200/700-token prompts, 32 out): queue_depth
     fires on the prefill role, the fleet raises its target to 2 (and holds
     it while the replica builds), the controller builds the replica on the
     card, the coordinator's _sync adds it, and of eight requests sent once
     it is ready it serves at least one; every request bit for bit phase
     3's engine's own run of its
     prompt (exact_gate); alert -> target -> serving latency, the build and
     capture, TTFT/TPOT/tok/s beside 3g's (b); the fleet steps the role
     down as soon as the traffic stops, while (b) runs, and (e) (below) is
     read after (b). (b) four
     greedy streams of 96 tokens on the decode replica when an alert naming
     it is injected: quarantine, drain, restart and rejoin each count once,
     every stream not finished on the replica resumes on the replacement
     (serve_fleet_resumes counts them), equal to phase 3's engine's own run
     up to its resume and, tokens and logprobs bit for bit, to that
     engine's own run of its continuation after it; where a resumed stream
     leaves the uninterrupted run (the peer recomputes the committed
     tokens' KV in a prefill, whose bf16 rounds otherwise), the two runs'
     tokens lie within LOGPROB_TOL["max"] of each other under a plain f32
     forward (forward_f32_plain), and the longest gap between tokens is
     printed; the fleet takes no prefill scale-up action from (b)'s start
     to its rejoin (C15). (c) sync_weights of phase 3's tree as version 1: every
     replica's stats() reports it and a fresh prompt keeps its tokens. (d)
     distribute_adapter: serve_fleet_adapter_residency equals the decode
     replicas and an adapter-named request reaches a resident one. (e) with
     no traffic each role steps down one replica per idle window to one and
     holds for three evaluations; (a) and (e) run again after (d), and the
     card memory after the second retirement stays within
     SERVE_RETIRED_MEMORY_TOL of the first's (C10's gate). Each planted
     FLEET_FAULTS entry (a target recorded but never sent to the
     controller; a replica reported synced without the call; a restart
     before the drain with resume off) must fail its gate. status() shows
     the alerts; no thread the phase started outlives serve.shutdown() and
     the plane's stop, and the card memory after them is back within
     SERVE_RETIRED_MEMORY_TOL of the phase's start (C14). Launches are counted only while the coordinator
     serves (a)-(d), replica builds (BuildLaunches), the engine's own runs
     and planted runs left out: K1, K2, K5 and K6 must have run, every
     launch from a graph replay;
  3s. the speculation path: the serving server is shut down and its
     parameters go to LLMServer(engine_config={"speculation": ...}), again
     llama3-8b at full width and depth, twice. (1) mode "draft", k = 4,
     self-speculation: phase 3's five prompts, all greedy. Launch counts
     are reset just before and read just after: K7 must have run a
     multiple of n_layers times (once per layer per verify round), K5
     (propose), K6 (draft prefill, the long prompt), K1 and K2 must have
     run, every launch must have come from a graph replay, and tokens per
     decode step must exceed SPEC_TOKENS_PER_STEP_MIN.
     (2) mode "ngram", k = 4: prompts that hold their own first output
     tokens (planted_prompt, so that drafts exist), a short pattern
     repeated, a random prompt (zero-draft rounds fall back to the plain span), one
     request sampled at temperature 0.8 / top_p 0.9 (the top-k/top-p
     verify); K7 and K5 must both have run, all in graph replays. The
     gate: speculative commits carry no logprobs and bf16 greedy tokens
     are not stable across batch
     shapes, so per greedy request the port's own `forward` over prompt +
     output gives, per output token, (largest logprob of the row) -
     (logprob of the committed token), 0 where the committed token is
     forward's argmax; its mean and max per request must stay under
     SPEC_REGRET_TOL, and each planted fault (spec_faults: verify mask one
     key short, span KV one position late, and, on a server with a distinct
     two-layer draft, every draft accepted), each on a server built inside
     its block, must exceed it. Prints TTFT, TPOT and tokens/s beside phase
     3's, acceptance, tokens per step and the round's host wall split. On
     the idle draft-mode engine the captured programs are held against
     their eager bodies (graph_checks: decode span, verify and propose give
     identical tokens; the bucketed prefill at every bucket, the chunk at
     start 0 and 512 and the draft chunk write bit-identical pages and
     logits within GRAPH_LOGPROB_TOL; sampled replays draw fresh numbers,
     launches per replay equal the eager body's, the profiler sees
     K1/K2/K5/K6/K7 inside replays), and round_vs_step times a decode step,
     the verify at every
     width and a propose as replays and as eager bodies and fits the span
     picker's cost model (SpecDecoder._SPAN_ALPHA);
  4. the training path: with the server's memory freed, train.lm trains
     llama-2b at full width and depth (f32 master weights from seed 0,
     bf16 compute, remat, AdamW from a warmup of 2) for TRAIN_STEPS steps
     on one fixed synthetic batch of 4 x 2048 tokens. Launch counts are
     reset just before and read just after: K3 and K4 run once per layer
     per step, K2 with lse twice (forward and remat recompute), K1's forward
     4 x layers + 1 times and its backward 2 x layers + 1. The first
     step must leave the parameters bit-identical (its learning rate is 0),
     every loss must be finite and the last below the first. Then the
     gradient gate: one step's loss and gradients on the kernel path
     against the plain path (transformer's flash_attention and rms_norm
     swapped for mha_reference and rms_norm_reference under autograd);
     every leaf's relative L2 gap must stay under GRAD_TOL, and each
     planted backward fault (BWD_FAULTS) must exceed it;
  4f. llama-2b under the reference's train2b recipe (bench.py:2429): full
     width and depth, make_optimizer(factored=True) (adafactor), parameters
     cast to bf16 after init (bf16_params), 4 x 2048 tokens, TRAIN_STEPS
     steps, after phase 4 freed its state. The optimizer state's bytes must
     equal what the leaf shapes give (factored_bytes) and stay under 1 % of
     the bf16 parameters; then phase 4's launch, lr-0 and loss gates
     (train_steps), and the step time, tokens/s, MFU and peak memory beside
     phase 4's;
  4p. the reference's pretrain -> checkpoint -> serve flow at llama-2b
     (pretrain_path): data.from_numpy token rows stream through
     iter_device_batches into TorchTrainer(...).fit() under phase 4f's
     recipe for 12 steps, with AsyncCheckpointWriter checkpoints after
     steps 3, 7 and 11; the losses against train.lm run directly on the
     same batches (step 0 bit-identical, every step within LOSS_GAP_TOL),
     exact launch counts, the kept checkpoints bit for bit as reported; a
     second fit fails after step 9 and resumes from step 7's checkpoint
     (losses as before, card memory and threads back where they were);
     then serve.run(LLMServer.bind(params_fn=<load_pytree of the last
     checkpoint>)) serves phase 3's burst under phase 3's logprob gate,
     every launch from a graph replay, the wgmma and split kernels by
     name; two planted faults (a snapshot taken after the next update, a
     restart whose error keeps its frames) must fail their gates; each
     fit() logs through an MLflowLoggerCallback (its local files), whose
     history must hold the losses fit() reported;
  4i. llama-2b pretraining fed by worker processes (procs_path), the
     runtime at its defaults (worker and actor processes on): synthetic
     documents (numpy seed 0) packed into [N, 2049] rows by map_batches
     tasks in the forkserver worker pool, shifted into inputs and targets
     by a callable class's actor pool in actor processes,
     iter_device_batches(batch_size=4) into TorchTrainer.fit for 12 steps
     on the card in this process. Gates: (a) the tasks and pool actors ran
     in other pids and no child holds a /dev/nvidia* file or maps a CUDA
     library beyond what the package's import maps;
     (b) the rows bit-equal to thread mode's, the losses to train.lm's over
     them, exact launches; (c) a worker and a pool actor SIGKILLed
     mid-epoch change neither; (d) a CUDA-tensor task runs in this pid and
     is counted, env_vars reach a worker, Pool.map runs in workers; (e)
     native, shm-handoff and chunked pulls of 180-300 MiB blobs byte-equal
     with their GB/s; (f) after shutdown no child but the resource tracker,
     no /dev/shm segment of the run, card memory as before. Three planted
     faults (pool_runs_in_process, child_touches_cuda,
     buffer_released_before_copy) must each be caught;
  4t. tune/ and the shared ingest service at llama-2b (tune_path): four
     tenants, one at weight 3, drain the same rows (phase 4f's batch, once
     a step: tune_rows) from one IngestService
     to the card, and while all four wait the weight-3 tenant must get
     >= FAIR_SHARE_MIN times a weight-1 tenant's blocks; then a Tuner runs
     four trials (lr 0, 1e-4, 3e-4, 1e-3) under phase 4f's recipe as GPU
     actors sharing the card (resources_per_trial {"GPU": 0.25}), each
     reading its batches as a tenant of one ingest service, under
     AsyncHyperBandScheduler(max_t=12, grace_period=2, reduction_factor=2):
     step 0 bit-equal across trials, to train.lm's and to phase 4f's; a
     trial stopped early, the lr-0 trial not the best; a full trial's
     losses within LOSS_GAP_TOL of train.lm directly; each trial's own
     thread's launches and the fit's exact; a stopped trial's lanes and
     state freed within its
     step (STOP_SLACK_S); card memory and threads back after fit(). Then
     PopulationBasedTraining over two trials restores checkpoints (saved
     with sorted keys) through load_pytree(target=<the trial's init
     state>): the first loss after a restore equals the source's at that
     step, with no earlier copy alive. Three planted faults (a stop that
     does not stop the trainable, tenants' weights ignored, the old
     key-order check of the restore) must fail their gates;
  4r. rl/ at llama-600m (rl_path): (a) GRPO at the reference's bench_grpo
     configuration (f32 parameters from seed 0, group 8, 16 new tokens,
     factored): an lr-0 step leaves the parameters bit-identical, then
     three steps at 1e-5 with finite losses, the frozen reference policy
     bit-identical to the init, KL > 0 after the first nonzero step,
     exact launches (grpo_launches), samples/s printed, and the gradient
     gate on the GRPO loss at the init: in bf16 the kernel path's gap to
     the f32 plain path's gradients within WITNESS_RATIO times the bf16
     plain path's (at an untrained init the two bf16 paths part by more
     than GRAD_TOL), and in f32 phase 4's gate; (b) OnlineRLLoop over a
     FleetController of a prefill- and a decode-role engine over bf16
     copies of the trainer's weights, three iterations: rollouts stamped
     with logprobs and the loop's version, iteration 1's rollout logprobs
     within LOGPROB_TOL of the trainer's, every replica, asked itself, at
     the loop's version after each sync, the ledger a partition, no
     fleet scale-up (C15), K3/K4 in the updates; a greedy stream of a
     300-token prompt across a sync ends whole, and K1/K2/K5/K6 ran in
     graph replays over the iterations and the stream; rollout tok/s,
     phase times, the sync stall fraction and rewards printed; (c) three
     planted RL_FAULTS fail their gates; (d) card memory and threads back
     after the loop and engines stop; (e) PPO on CartPole with the
     learner on the card, one update against the CPU's within 1e-4;
  4o. single-host observability and tooling (observe_path) around a named
     llama3-8b server, in one process: (a) the concurrency sanitizer
     installed, then init() at its defaults with control-plane snapshots
     every second, a named GPU actor "llm" building LLMServer from its
     config (weights from seed 0) and 8 greedy prompts of 32 tokens (one
     of 700: K6) served through its handle, after a warm-up burst three
     times without and three times with the flight recorder attached and
     every request traced (TPOT of each); (b) the node agent's device
     trace (kind="torch") over a burst must name K1's and K5's kernels,
     the top kernels by device time printed; (c) its sampling profiler
     over three bursts takes samples (TPOT under it), and a stack dump of
     an actor process names the method it sits in; (d)
     device_memory_snapshot's bytes in use equal memory_allocated and hold
     the weights, and a pool task's snapshot is zeros with no device file
     open; (e) the health payload has a utilization row for the node and a
     goodput ledger that partitions its wall; (f) after a snapshot,
     shutdown() gives the card's memory back (within 1 GiB), and
     init(resume_from=) re-creates "llm", whose tokens for the same prompts
     are bit-equal to (a)'s (time from init to the first token; TPOT of
     three bursts after a warm-up on stock locks against the sanitizer's);
     (g) a job runs K1 against its plain version in a driver process of its
     own and its line is in the job's logs, and a LogMonitor reads a pool
     task's line with its pid; (h) the core microbenchmarks; (i) no
     lock-order cycle among the sanitizer's reports (lock holds printed),
     spans of the served requests in the flight recorder, and a pool
     worker killed with SIGKILL leaves a postmortem that load_postmortem
     reads;
  4n. the network (network_path, after 4o): a direct llama3-8b engine
     (weights from seed 0) gives the tokens of phase 4o's 8 greedy prompts
     of 32 tokens and is freed (the card's memory read back); the smoke
     process becomes a head that serves its control plane over RPC and
     advertises no card (init(num_gpus=0, control_plane_rpc_port=0),
     health timeout NETWORK_HEALTH_TIMEOUT_MS); two worker processes join
     with init(address=), each advertising a share of the card and
     {"replica_pool": 2} (room for the controller to replace the killed
     host's replica on the survivor); serve.run(LLMServer.options(
     num_replicas=2)) places one llama3-8b replica on each joined host by
     resource demand (spread; both built at once); the 8 requests through the handle
     across the dispatch plane must give tokens bit-equal to the direct
     engine's, both replicas serving; one host SIGKILLed NETWORK_KILL_AT of
     the way into a second burst must be reaped within the health timeout,
     every request answered bit-equal or failed with a typed error, none
     hung, and nvidia-smi's compute apps one fewer without its pid; the
     controller's replacement replica must be built on the survivor; there
     a K1 task over the head's numpy rows (one launch there, the
     result back over the transfer plane as a CPU tensor, against the
     plain rms_norm within TOL) and a task that calls the deployment's
     handle through the head back-channel (tokens bit-equal); then
     serve.shutdown() and shutdown() leave no host process and no compute
     app of the phase. Prints the walls: reference engine, head init,
     join, replica build, burst TPOT p50, time to reap, K1 round trip,
     back-channel call, phase;
  5. LLMServer serving moe-1b (8 experts, top 2) at full width and depth,
     random bf16 weights from seed 0, phase 3's engine sizes and burst
     shapes: every serving kernel runs, every launch from a graph replay;
     TTFT, TPOT, tok/s and a decode step's replay time beside its byte
     bound (decode_step_figures). The logprob gate runs on servers over the
     same weights whose capacity factor drops no token (see
     MOE_LOGPROB_TOL), and each planted MoE fault (MOE_FAULTS: gate weights
     from a softmax over all experts, the second choice's weight given to
     the first, the combine reading the next slot) must fail it. Then an
     ngram burst (k = 4, planted prompts) runs K7 and K5 in graph replays,
     and on its idle engine the decode span, verify, prefill buckets and
     chunks are held against their eager bodies (graph_checks); before
     that, one streamed KV migration of a 700-token prompt into a second
     engine at page size 16 must continue token-exactly (round_trip,
     phase 3m's gate (a)); and one live update from a host tree
     (moe_live_update): the seed-1 moe-1b weights as numpy float32 are
     staged onto the card on a side stream and cast to bf16 while two
     streams decode (staging time and the streams' TPOT and longest gap
     while it ran, against two streams without an update), then two fresh
     prompts must agree exactly with a fresh engine over the same weights,
     and the seed-0 weights come back bit-exact;
  6. moe-1b trained as the reference's bench_moe (bench.py:1711): 2 x 1024
     tokens, factored, bf16 parameters, 2 warm and 8 timed steps, then its
     dense twin (llama-600m at moe-1b's backbone, d_ff = 2 x 4096): phase
     4f's gates for each, moe_dispatch_overhead_pct by bench_moe's formula,
     and on the trained layer 0 the gather form against the dense form at
     the training shape within MOE_FORM_TOL. Then phase 4's gradient gate
     on the trained moe-1b: the kernel path in the gather form against the
     plain attention and norms in the dense form (plain_moe_path), every
     pass on the first pass's routing (OneRouting), router and expert
     leaves included; BWD_FAULTS and the MoE faults MOE_BWD_FAULTS (gate
     weights detached, expert inputs detached, the combine reading the
     next slot) must each exceed GRAD_TOL.

The second-to-last line of stdout is {"kernels": [...]} (eight kernels:
K1's forward and backward, K2-K7; launches by path: serve, spec, train,
train2b, moe_serve, moe_train, migrate (phase 3m), moe_migrate (phase 5's
round trip), live (phase 3w's update and gate, phase 5's update and
gate), runtime (phase 3r's tasks, hosted server and updates), deploy
(phase 3d's handle and HTTP sections), disagg (the coordinators' requests
of phase 3g's (a)-(c) and (d)), fleet (the coordinator's requests of phase
3f's (a)-(d), both cycles), pretrain (phase 4p's first fit and
its served burst), tune (phase 4t's ASHA and PBT fits), rl (phase 4r's
GRPO steps at lr 1e-5 and the online loop's iterations), observe (phase
4o's bursts), network (phase 4n: the head launches nothing, its replicas'
kernels run in the joined hosts' processes; the K1 task's launch there)),
then a table of each phase's wall, the last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits non-zero and prints no result.

    python3 chip_smoke.py --ab DIR   # kernel variants side by side

builds the kernels of this checkout and those of DIR (a changed copy of
ray_tpu_torch/csrc), checks both, times K1 (forward and backward), K4, K5,
K6 and K7 with each in turns in one process (ab_compare), and prints no
result line.

    python3 chip_smoke.py --moe-dynamics

builds the kernels and trains moe-1b as phase 6 does under variants of its
recipe and path (moe_dynamics), printing every step's metrics, and prints
no result line.

    python3 chip_smoke.py --readback-ab

builds phase 3's llama3-8b server and serves phase 3's burst, fresh
prompts each time, with the engine's readbacks into pinned memory
(programs.read_back) and into pageable memory, in turns (readback_ab);
prints each burst's figures and no result line.

    python3 chip_smoke.py --runtime

builds the kernels and phase 3's llama3-8b server, serves phase 3's burst,
then runs phase 3r on its tensors (runtime_only); no result line.

    python3 chip_smoke.py --deploy

builds the kernels and phase 3's llama3-8b server, serves phase 3's burst,
then runs phase 3d on its tensors (deploy_only); no result line.

    python3 chip_smoke.py --disagg

builds the kernels and phase 3's llama3-8b server, serves phase 3's burst,
then runs phase 3g on its tensors (disagg_only); no result line.

    python3 chip_smoke.py --fleet

builds the kernels and phase 3's llama3-8b server, serves phase 3's burst,
then runs phase 3f on its tensors (fleet_only); no result line.

    python3 chip_smoke.py --pretrain

builds the kernels and runs phase 4p alone (pretrain_path: data ->
TorchTrainer -> checkpoints -> serve.run at llama-2b); no result line.

    python3 chip_smoke.py --tune

builds the kernels and runs phase 4t alone (tune_path: the ingest
service's fair share, ASHA and PBT over llama-2b trials on the card); no
result line.

    python3 chip_smoke.py --rl

builds the kernels and runs phase 4r alone (rl_path: GRPO and the online
RL loop at llama-600m, PPO with its learner on the card); no result line.

    python3 chip_smoke.py --observe

builds the kernels and runs phase 4o alone (observe_path: profiling,
device memory, the health payload, snapshot and resume of a named
llama3-8b actor, jobs, logs, microbenchmarks, the sanitizer and
postmortems); no result line.

    python3 chip_smoke.py --procs

builds the kernels and runs phase 4i alone (procs_path: llama-2b
pretraining fed by the worker-process pool and actor processes, the
transfer plane's native and shm-handoff pulls); no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import weakref

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances: |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # f32: the kernels sum in another order than the plain versions
    ("rms_norm", torch.float32): (1e-5, 1e-5),
    ("attention", torch.float32): (2e-3, 2e-3),
    # bf16: both round their f32 results to bf16 (one ulp is 2^-8 relative)
    ("rms_norm", torch.bfloat16): (2e-2, 1.6e-2),
    ("attention", torch.bfloat16): (2e-2, 1.6e-2),
    # K2's lse residual is f32 in both dtypes; the kernel sums the scores
    # of bf16 inputs in another order than the plain version
    ("lse", torch.float32): (1e-4, 1e-5),
    ("lse", torch.bfloat16): (1e-3, 1e-5),
    # K1's backward: f32 dw sums up to 8192 rows of f32 terms of size ~1
    # in another order than torch's sum; bf16 dw is rounded once by both
    ("rms_norm_dw", torch.float32): (1e-3, 1e-4),
    ("rms_norm_dw", torch.bfloat16): (2e-2, 1.6e-2),
}
# nats, per request, on |engine - forward| over its output logprobs: the
# largest and the mean. The engine (bucketed/chunked prefill, then decode
# over the bf16 page pool) and the full forward round bf16 activations at
# different places, so sound runs differ a little; the sampled request,
# whose tokens change from run to run, read up to 0.30 (max) and 0.065
# (mean) on the H100. The weakest planted fault in FAULTS read 0.57 and
# 0.21 (PERF.md). The mean separates them best, so its limit sits near
# their geometric middle; the max limit guards against a fault confined
# to a few tokens, which the mean would dilute.
LOGPROB_TOL = {"max": 0.5, "mean": 0.12}

SOURCES = {
    "rms_norm": ("ray_tpu_torch/csrc/rms_norm.cu", "ray_tpu/ops/norm.py:31"),
    "rms_norm_bwd": ("ray_tpu_torch/csrc/rms_norm.cu", "ray_tpu/ops/norm.py:76"),
    "flash_attention": ("ray_tpu_torch/csrc/flash_attention.cu", "ray_tpu/ops/attention.py:84"),
    "flash_attention_bwd_dq": ("ray_tpu_torch/csrc/flash_attention_bwd.cu",
                               "ray_tpu/ops/attention.py:205"),
    "flash_attention_bwd_dkv": ("ray_tpu_torch/csrc/flash_attention_bwd.cu",
                                "ray_tpu/ops/attention.py:248"),
    "paged_attention_decode": ("ray_tpu_torch/csrc/paged_attention.cu",
                               "ray_tpu/ops/paged_attention.py:129"),
    "paged_attention_chunk": ("ray_tpu_torch/csrc/paged_attention.cu",
                              "ray_tpu/ops/paged_attention.py:222"),
    "paged_attention_verify": ("ray_tpu_torch/csrc/paged_attention.cu",
                               "ray_tpu/ops/paged_attention.py:371"),
}
# the kernels the serving path must launch (the training path's launch
# counts are checked exactly, in train_main_path)
SERVE_KERNELS = ("rms_norm", "flash_attention", "paged_attention_decode",
                 "paged_attention_chunk")
# the kernels the speculation path must launch, in draft mode
SPEC_KERNELS = SERVE_KERNELS + ("paged_attention_verify",)
TRAIN_STEPS = 8
# name stems of the CUDA kernels in ray_tpu_torch/csrc, as a profiler shows them
PORT_KERNEL_STEMS = ("rms_norm_fwd_", "rms_norm_bwd_", "rms_norm_dw_", "flash_fwd_",
                     "flash_bwd_", "paged_")


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# --------------------------------------------------------------- timing


_FLUSH = None
_CLOCK_HZ = 1.98e9  # the H100 SXM's top boost clock: a sleep of n cycles lasts >= n / this


def _flush_l2():
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    _FLUSH.zero_()


def device_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one fn() with a cold L2, in ms: median over trials of
    (reps x [flush, fn] - reps x [flush]) / reps, each run timed with CUDA
    events while the card first sleeps long enough for the host to enqueue
    the whole run, so host launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    _flush_l2()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(_CLOCK_HZ * (5e-3 + 3 * reps * host_s))

    def run(with_fn: bool) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            _flush_l2()
            if with_fn:
                fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    return statistics.median((run(True) - run(False)) / reps for _ in range(trials))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, kind, dtype, got, want) -> float:
    atol, rtol = TOL[(kind, dtype)]
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name} {dtype}: non-finite output")
    if bool((err > limit).any()):
        fail(f"{name} {dtype}: max |err| {err.max().item():.3e} exceeds "
             f"atol {atol} + rtol {rtol}")
    return err.max().item()


def _kernel_name(mangled: str) -> str:
    """identifier<template arguments> of a mangled kernel name: the last
    length-prefixed segment of its nested name, then its int, bool and
    type arguments; the mangled name where that reading fails."""
    m = re.match(r"_ZN(.*)", mangled)
    pos, seg = 0, None
    rest = m.group(1) if m else ""
    while pos < len(rest) and rest[pos].isdigit():
        n = re.match(r"\d+", rest[pos:]).group(0)
        pos += len(n)
        seg = rest[pos:pos + int(n)]
        pos += int(n)
    if seg is None or not rest[pos:].startswith("I"):
        return mangled
    names = []  # a type seen before comes back as a substitution, S<n>_
    for a, b, c, _sub in re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|(f)|(S\d*_)",
                                   rest[pos + 1:rest.find("EEv", pos)]):
        types = [n for n in names if not n.isdigit()]
        names.append(a or ("bf16" if b else "f32" if c else types[-1] if types else "?"))
    return f"{seg}<{', '.join(names)}>"


def ptxas_report(build_log: str) -> dict:
    """Per kernel entry in nvcc's build log (-Xptxas -v): registers and
    spill bytes, by `_kernel_name`."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def launched_kernels(fn) -> list:
    """Names of the CUDA kernels that three calls of fn() launched, from
    torch.profiler. The profiler on the H100 now and then loses records:
    a pass around one short launch recorded no kernel, or only the second
    of two (PERF.md), so each pass makes three calls, and a pass that
    recorded no kernel at all is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a margin on both sides of the launches: late in a process a
            # pass without it recorded no kernel at all (PERF.md)
            time.sleep(0.25)
            for _ in range(3):
                fn()
                torch.cuda.synchronize()
            time.sleep(0.25)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def tile_identity_checks(gen) -> None:
    """A profiler pass around one launch of K2 (without lse at the serving
    shapes, with lse at the training shapes), of K3 and K4 (training
    shapes), and of K6 and K7 at the engine's shapes (a 256-query chunk at
    start 512, the verify span B=8, S=5), in f32 and bf16: each must show the
    kernel that (dtype, head_dim) selects (check_tile). Run first in phase 2,
    on inputs of its own."""
    from ray_tpu_torch.ops import attention, paged_attention

    D = 128
    serving = [(1, T, 32, 8) for T in (64, 100, 128, 256)]
    training = [(4, 2048, 20, 5), (2, 1000, 20, 5), (2, 1024, 8, 8)]

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    def attn(op, dtype):
        return attention.kernel_symbol(op, dtype, D)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for B, T, H, KVH in serving + training:
            shape = f"B={B} T={T} H={H}/{KVH}"
            q, k, v = rnd((B, T, H, D), dtype), rnd((B, T, KVH, D), dtype), rnd((B, T, KVH, D),
                                                                                dtype)
            if (B, T, H, KVH) in serving:
                name = check_tile(f"K2 {tag} {shape}", attn("flash_attention", dtype),
                                  lambda: attention.flash_attention(q, k, v))
                log(f"tile K2 {tag} {shape}: {name}")
                continue
            do = rnd((B, T, H, D), dtype)
            lse = torch.zeros((B, H, T), device="cuda")
            k2 = check_tile(f"K2+lse {tag} {shape}", attn("flash_attention", dtype),
                            lambda: attention.flash_attention_with_lse(q, k, v))
            k3 = check_tile(f"K3 {tag} {shape}", attn("flash_attention_bwd_dq", dtype),
                            lambda: attention.flash_attention_bwd_dq(q, k, v, do, lse, lse))
            k4 = check_tile(f"K4 {tag} {shape}", attn("flash_attention_bwd_dkv", dtype),
                            lambda: attention.flash_attention_bwd_dkv(q, k, v, do, lse, lse))
            log(f"tile K2+lse {tag} {shape}: {k2}; K3: {k3}; K4: {k4}")
            del do, lse
        del q, k, v
        # K6 and K7 over the engine's pool (512 pages of 16, 8 kv heads)
        kp, vp = rnd((8, 512, 16, D), dtype), rnd((8, 512, 16, D), dtype)
        table = torch.randint(1, 512, (8, 64), generator=gen, device="cuda", dtype=torch.int32)
        q6, q7 = rnd((256, 32, D), dtype), rnd((8, 5, 32, D), dtype)
        positions = torch.tensor([20, 100, 333, 500, 640, 777, 850, 900], dtype=torch.int32,
                                 device="cuda")
        k6 = check_tile(f"K6 {tag} C=256 start 512",
                        paged_attention.kernel_symbol("paged_attention_chunk", dtype, D),
                        lambda: paged_attention.paged_attention_chunk(q6, kp, vp, table[5], 512,
                                                                      768))
        k7 = check_tile(f"K7 {tag} B=8 S=5",
                        paged_attention.kernel_symbol("paged_attention_verify", dtype, D),
                        lambda: paged_attention.paged_attention_verify(q7, kp, vp, table,
                                                                       positions))
        log(f"tile K6 {tag} C=256: {k6}; K7 {tag} B=8 S=5: {k7}")
        del kp, vp, q6, q7
    torch.cuda.empty_cache()


def check_tile(label: str, want: str, fn) -> str:
    """Fails unless fn(), one call of an attention op, launched kernel
    `want`: the name `kernel_symbol` gives for the op's dtype and head_dim
    (the wgmma tile for bf16 at head_dim 64/128, the FMA tile otherwise);
    returns it."""
    names = launched_kernels(fn)
    if not any(want in n for n in names):
        fail(f"{label}: expected a launch of {want}, the profiler saw {names}")
    return want


# -------------------------------------------------------------- phase 2


def norm_checks(gen) -> dict:
    """K1's forward and backward vs their plain versions at the shapes of the
    three paths, each timed beside its bound, the plain version, the library
    call and the one-element floor, then checked, untimed, at moe-1b's width
    and with phase 4f's bf16 weights. Returns the bf16 figures of the forward
    at decode ([8, 4096]) and at the training block, and of the backward at
    the training block."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import norm

    bf16, f32 = torch.bfloat16, torch.float32
    eps = 1e-5
    out = {}
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.add_(1))
    log(f"K1 floor: one one-element PyTorch kernel (add_) {floor:.4f} ms")

    def inputs(rows, D, xd, wd):
        x = torch.randn((rows, D), generator=gen, device="cuda").to(xd)
        g = torch.randn((rows, D), generator=gen, device="cuda").to(xd)
        w = (1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(wd)
        return x, w, g

    def tag(xd, wd):
        return "/".join("bf16" if d == bf16 else "f32" for d in (xd, wd))

    # (rows, D, x dtype, w dtype): decode, verify span (B*(k+1)), a prefill
    # chunk, then the training block (bf16 activations, f32 master scale)
    fwd_shapes = [(rows, 4096, d, d) for d in (f32, bf16) for rows in (8, 40, 256)]
    fwd_shapes.append((8192, 2560, bf16, f32))
    for rows, D, xd, wd in fwd_shapes:
        x, w, _g = inputs(rows, D, xd, wd)
        ex, ew = x.element_size(), w.element_size()
        err = check_close(f"rms_norm [{rows},{D}]", "rms_norm", xd, norm.rms_norm(x, w, eps),
                          norm.rms_norm_reference(x, w, eps))
        reps = 10 if rows >= 8192 else 20
        ms = device_ms(lambda: norm.rms_norm(x, w, eps), reps)
        plain = device_ms(lambda: norm.rms_norm_reference(x, w, eps), reps)
        lib = device_ms(lambda: F.rms_norm(x, (D,), w, eps), reps)
        # x read and y written once, w read once; its arithmetic is f32
        bnd, by = bound_ms(2 * rows * D * ex + D * ew, 4 * rows * D, f32)
        log(f"K1 rms_norm {tag(xd, wd)} [{rows},{D}] [{norm.kernel_symbol('rms_norm', x, w)}]: "
            f"max_err {err:.3e} (tol {TOL[('rms_norm', xd)]}) ms {ms:.4f} plain {plain:.4f} "
            f"bound {bnd:.4f} ({by}) F.rms_norm {lib:.4f} floor {floor:.4f} "
            f"(kernel / bound {ms / bnd:.1f}, kernel / F.rms_norm {ms / lib:.2f})")
        fig = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                   library_ms=lib, floor_ms=floor)
        if (rows, xd) == (8, bf16):
            out["rms_norm"] = fig
        if rows == 8192:
            out["rms_norm_training"] = fig
        del x, w
    # moe-1b's width (d_model 1536), checked only: its serving rows in f32
    # and bf16, its training block (2 x 1024 rows; bf16 weights, as phase 6
    # casts them)
    for rows, D, xd, wd in ([(rows, 1536, d, d) for d in (f32, bf16) for rows in (8, 40, 256)]
                            + [(2048, 1536, bf16, bf16)]):
        x, w, _g = inputs(rows, D, xd, wd)
        err = check_close(f"rms_norm [{rows},{D}]", "rms_norm", xd, norm.rms_norm(x, w, eps),
                          norm.rms_norm_reference(x, w, eps))
        log(f"K1 rms_norm {tag(xd, wd)} [{rows},{D}] (moe-1b) "
            f"[{norm.kernel_symbol('rms_norm', x, w)}]: max_err {err:.3e} "
            f"(tol {TOL[('rms_norm', xd)]})")
        del x, w
    x, w, _g = inputs(8, 4096, bf16, bf16)
    names = launched_kernels(lambda: norm.rms_norm(x, w, eps))
    if not any("rms_norm_fwd_vec_kernel" in n for n in names):
        fail(f"rms_norm: the profiler saw {names}, not rms_norm_fwd_vec_kernel")

    # the backward: the training block first, then decode rows
    for rows, D, xd, wd in [(8192, 2560, bf16, f32), (8, 4096, bf16, bf16), (8, 4096, f32, f32)]:
        x, w, g = inputs(rows, D, xd, wd)
        ex, ew = x.element_size(), w.element_size()
        dx, dw = norm.rms_norm_bwd(x, w, g, eps)
        want_dx, want_dw = norm._rms_bwd(x, w, g, eps)
        err = max(check_close(f"rms_norm_bwd dx [{rows},{D}]", "rms_norm", xd, dx, want_dx),
                  check_close(f"rms_norm_bwd dw [{rows},{D}]", "rms_norm_dw", wd, dw, want_dw))
        dx2, dw2 = norm.rms_norm_bwd(x, w, g, eps)
        if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
            fail(f"rms_norm_bwd [{rows},{D}]: two calls on the same inputs differ")
        del dx, dw, dx2, dw2, want_dx, want_dw
        reps = 10 if rows >= 8192 else 20
        ms = device_ms(lambda: norm.rms_norm_bwd(x, w, g, eps), reps)
        plain = device_ms(lambda: norm._rms_bwd(x, w, g, eps), reps)
        # yardstick: autograd of F.rms_norm, several launches
        xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        yr = F.rms_norm(xr, (D,), wr, eps)
        lib = device_ms(lambda: torch.autograd.grad(yr, (xr, wr), g, retain_graph=True), reps)
        del yr, xr, wr
        # x and g read and dx written once, w read and dw written once
        bnd, by = bound_ms(3 * rows * D * ex + 2 * D * ew, 12 * rows * D, f32)
        log(f"K1 rms_norm_bwd {tag(xd, wd)} [{rows},{D}] "
            f"[{norm.kernel_symbol('rms_norm_bwd', x, w, g)} + rms_norm_dw_kernel]: "
            f"max_err {err:.3e} (dx tol {TOL[('rms_norm', xd)]}, dw tol "
            f"{TOL[('rms_norm_dw', wd)]}; dw bit-identical over two calls) ms {ms:.4f} "
            f"plain {plain:.4f} bound {bnd:.4f} ({by}) autograd of F.rms_norm (several "
            f"launches) {lib:.4f} floor {floor:.4f} (kernel / bound {ms / bnd:.1f}, "
            f"kernel / plain {ms / plain:.3f})")
        if rows == 8192:
            out["rms_norm_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                       bound_by=by, library_ms=lib, floor_ms=floor)
            names = launched_kernels(lambda: norm.rms_norm_bwd(x, w, g, eps))
            for want in ("rms_norm_bwd_vec_kernel", "rms_norm_dw_kernel"):
                if not any(want in n for n in names):
                    fail(f"rms_norm_bwd: the profiler saw {names}, not {want}")
        del x, w, g
    # checked only: moe-1b's training block (bf16 weights and f32 weights
    # with f32 activations) and llama-2b's with phase 4f's bf16 weights
    for rows, D, xd, wd in [(2048, 1536, bf16, bf16), (2048, 1536, f32, f32),
                            (8192, 2560, bf16, bf16)]:
        x, w, g = inputs(rows, D, xd, wd)
        dx, dw = norm.rms_norm_bwd(x, w, g, eps)
        want_dx, want_dw = norm._rms_bwd(x, w, g, eps)
        err = max(check_close(f"rms_norm_bwd dx [{rows},{D}]", "rms_norm", xd, dx, want_dx),
                  check_close(f"rms_norm_bwd dw [{rows},{D}]", "rms_norm_dw", wd, dw, want_dw))
        log(f"K1 rms_norm_bwd {tag(xd, wd)} [{rows},{D}] "
            f"[{norm.kernel_symbol('rms_norm_bwd', x, w, g)} + rms_norm_dw_kernel]: "
            f"max_err {err:.3e} (dx tol {TOL[('rms_norm', xd)]}, dw tol "
            f"{TOL[('rms_norm_dw', wd)]})")
        del x, w, g, dx, dw, want_dx, want_dw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def kernel_checks(gen) -> dict:
    """K2, K5, K6 and K7 vs their plain versions at the serving path's
    shapes, llama3-8b's (32/8 heads) and moe-1b's (12/4). Returns, per
    kernel, the bf16 figures at the main shape."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention, paged_attention

    out = {}
    H, KVH, hd = 32, 8, 128
    P, ps, pps, B = 512, 16, 64, 8

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"

        # K2: bucketed prefill, one prompt: the buckets the main path uses
        # (64, 128, 256) and a ragged T
        for T in (64, 100, 128, 256):
            q, k, v = rnd((1, T, H, hd), dtype), rnd((1, T, KVH, hd), dtype), rnd((1, T, KVH, hd), dtype)
            err = check_close("flash_attention", "attention", dtype,
                              attention.flash_attention(q, k, v), attention.mha_reference(q, k, v))
            tile = attention.kernel_symbol("flash_attention", dtype, hd)
            ms = device_ms(lambda: attention.flash_attention(q, k, v))
            plain = device_ms(lambda: attention.mha_reference(q, k, v))
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = T * (T + 1) // 2
            bnd, by = bound_ms((2 * q.numel() + k.numel() + v.numel()) * el,
                               4 * H * hd * pairs, dtype)
            log(f"K2 flash_attention {tag} T={T} [{tile}]: max_err {err:.3e} "
                f"(tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by}) sdpa {lib:.4f} (kernel / sdpa {ms / lib:.2f})")
            if dtype == torch.bfloat16 and T == 256:
                out["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bnd, bound_by=by, library_ms=lib)

        # K2 at moe-1b's heads (12 over 4 kv heads, g = 3), checked only:
        # one prompt at each bucket and a ragged T, and a tier of 8 prompts
        for Bm, T in ((1, 64), (1, 100), (1, 128), (1, 256), (8, 64)):
            q = rnd((Bm, T, 12, hd), dtype)
            k, v = rnd((Bm, T, 4, hd), dtype), rnd((Bm, T, 4, hd), dtype)
            err = check_close(f"flash_attention moe-1b B={Bm} T={T}", "attention", dtype,
                              attention.flash_attention(q, k, v), attention.mha_reference(q, k, v))
            log(f"K2 flash_attention {tag} moe-1b B={Bm} T={T} H=12/4: max_err {err:.3e} "
                f"(tol {TOL[('attention', dtype)]})")

        # K5: the engine's decode batch: 8 slots, one inactive, lengths not
        # multiples of the page size, pages scattered over the pool
        kp, vp = rnd((KVH, P, ps, hd), dtype), rnd((KVH, P, ps, hd), dtype)
        table = torch.randint(1, P, (B, pps), generator=gen, device="cuda", dtype=torch.int32)
        lengths = torch.tensor([0, 1, 17, 100, 333, 700, 1000, 1024], dtype=torch.int32,
                               device="cuda")
        q = rnd((B, H, hd), dtype)
        got = paged_attention.paged_attention_decode(q, kp, vp, table, lengths)
        want = paged_attention._paged_reference(q, kp, vp, table, lengths, hd ** -0.5)
        if bool(got[0].float().abs().max() != 0):
            fail("paged_attention_decode: a length-0 slot must give zeros")
        err = check_close("paged_attention_decode", "attention", dtype, got, want)
        ms = device_ms(lambda: paged_attention.paged_attention_decode(q, kp, vp, table, lengths))
        plain = device_ms(lambda: paged_attention._paged_reference(q, kp, vp, table, lengths,
                                                                 hd ** -0.5))
        bnd, by = decode_bound(q, kp, table, lengths)
        log(f"K5 paged_attention_decode {tag} B={B} lengths {lengths.tolist()}: "
            f"max_err {err:.3e} (tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
            f"bound {bnd:.4f} ({by})")
        if dtype == torch.bfloat16:
            out["paged_attention_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                 bound_ms=bnd, bound_by=by, library_ms=None)
        # K5's edges, beside the engine's batch: K5 cuts each sequence into
        # splits of DECODE_SPLIT_KEYS keys (128) and merges them on the card.
        # name -> (kv heads, q heads, lengths); a table of 64 pages of 16
        ctx = pps * ps
        decode_edges = {
            "B=1 length 1024": (KVH, H, [1024]),
            "split edges +-1": (KVH, H, [127, 128, 129, 255, 256, 257, 0, 895]),
            "past the table": (KVH, H, [ctx + 1, 5000, ctx, ctx - 1, 0, 2, 700, 1500]),
            "g=1": (KVH, KVH, lengths.tolist()),
            "g=8": (KVH // 2, H, lengths.tolist()),
            "moe-1b g=3": (4, 12, lengths.tolist()),
        }
        for name, (KVHe, He, lens) in decode_edges.items():
            le = torch.tensor(lens, dtype=torch.int32, device="cuda")
            te = table[:len(lens)].contiguous()
            qe = rnd((len(lens), He, hd), dtype)
            kpe, vpe = kp[:KVHe].contiguous(), vp[:KVHe].contiguous()
            got = paged_attention.paged_attention_decode(qe, kpe, vpe, te, le)
            want = paged_attention._paged_reference(qe, kpe, vpe, te, le, hd ** -0.5)
            err = check_close(f"paged_attention_decode {name}", "attention", dtype, got, want)
            if bool(got[le == 0].float().abs().sum() != 0):
                fail(f"paged_attention_decode {name}: a length-0 slot must give zeros")
            ms = device_ms(lambda: paged_attention.paged_attention_decode(qe, kpe, vpe, te, le))
            bnd, by = decode_bound(qe, kpe, te, le)
            log(f"K5 paged_attention_decode {tag} {name}: max_err {err:.3e} ms {ms:.4f} "
                f"bound {bnd:.4f} ({by})")
        # two calls back to back on one stream with other lengths: the
        # second call's workspace is the first's, returned to the allocator
        la = torch.tensor([1024, 0, 129, 5, 333, 1, 640, 1023], dtype=torch.int32, device="cuda")
        lb = torch.tensor([1, 1024, 0, 300, 128, 900, 17, 256], dtype=torch.int32, device="cuda")
        a = paged_attention.paged_attention_decode(q, kp, vp, table, la)
        b = paged_attention.paged_attention_decode(q, kp, vp, table, lb)
        err = max(check_close("paged_attention_decode back to back (1)", "attention", dtype, a,
                              paged_attention._paged_reference(q, kp, vp, table, la, hd ** -0.5)),
                  check_close("paged_attention_decode back to back (2)", "attention", dtype, b,
                              paged_attention._paged_reference(q, kp, vp, table, lb, hd ** -0.5)))
        log(f"K5 paged_attention_decode {tag} two calls back to back: max_err {err:.3e}")
        # K5 at page size 8, as phase 3m (b)'s destination decodes its
        # imports: the engine's batch of 8 slots, 1024 tokens a sequence in
        # 128 pages of 8 (16 pages a split) from a pool of 1024 such pages;
        # lengths off the page edges, at split edges +- 1 and across them
        kp8, vp8 = rnd((KVH, 2 * P, 8, hd), dtype), rnd((KVH, 2 * P, 8, hd), dtype)
        table8 = torch.randint(1, 2 * P, (B, 2 * pps), generator=gen, device="cuda",
                               dtype=torch.int32)
        for name, lens in (("engine's batch", [0, 3, 9, 129, 255, 701, 1001, 1023]),
                           ("split edges +-1", [127, 128, 129, 255, 256, 257, 7, 1017])):
            le = torch.tensor(lens, dtype=torch.int32, device="cuda")
            qe = rnd((B, H, hd), dtype)
            got = paged_attention.paged_attention_decode(qe, kp8, vp8, table8, le)
            want = paged_attention._paged_reference(qe, kp8, vp8, table8, le, hd ** -0.5)
            err = check_close(f"paged_attention_decode page size 8 {name}", "attention", dtype,
                              got, want)
            if bool(got[le == 0].float().abs().sum() != 0):
                fail(f"paged_attention_decode page size 8 {name}: a length-0 slot must give "
                     f"zeros")
            ms = device_ms(lambda: paged_attention.paged_attention_decode(qe, kp8, vp8, table8,
                                                                          le))
            plain = device_ms(lambda: paged_attention._paged_reference(qe, kp8, vp8, table8, le,
                                                                     hd ** -0.5))
            bnd, by = decode_bound(qe, kp8, table8, le)
            log(f"K5 paged_attention_decode {tag} page size 8 {name} lengths {lens}: max_err "
                f"{err:.3e} (tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by})")
        del kp8, vp8, table8

        def chunk_meta_on_card(label, got, q, kp, vp, t, start, total):
            """K6 with [start, total] as int32 tensors on the card, both as
            two tensors of their own (joined on the card) and as the two
            halves of one [2] tensor that K6 reads in place, as the captured
            chunk programs pass them: each bit-identical to the int form.
            -> the halves, which K6's timings use (the int form adds a
            host-to-card copy of the two ints to every call)."""
            meta = torch.tensor([start, total], dtype=torch.int32, device="cuda")
            apart = [torch.tensor([x], dtype=torch.int32, device="cuda") for x in (start, total)]
            for form in (apart, [meta[:1], meta[1:]]):
                if not torch.equal(paged_attention.paged_attention_chunk(q, kp, vp, t, *form),
                                   got):
                    fail(f"paged_attention_chunk {label}: start/total on the card differ from "
                         f"the int form")
            return [meta[:1], meta[1:]]

        # K6: the chunks of a 700-token prompt (C = 256, starts 0/256/512)
        C = 256
        t1 = table[5].contiguous()
        for start in (0, 256, 512):
            total = start + C
            q = rnd((C, H, hd), dtype)
            got = paged_attention.paged_attention_chunk(q, kp, vp, t1, start, total)
            meta = chunk_meta_on_card(f"{tag} start={start}", got, q, kp, vp, t1, start, total)
            want = paged_attention._chunk_reference(q, kp, vp, t1, start, total, hd ** -0.5)
            err = check_close("paged_attention_chunk", "attention", dtype, got, want)
            ms = device_ms(lambda: paged_attention.paged_attention_chunk(q, kp, vp, t1, *meta))
            plain = device_ms(lambda: paged_attention._chunk_reference(q, kp, vp, t1, start,
                                                                     total, hd ** -0.5))
            bnd, by = chunk_bound(q, kp, t1, start, total)
            log(f"K6 paged_attention_chunk {tag} C={C} start={start}: max_err {err:.3e} "
                f"(tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by}); start/total on the card: bit-identical")
            if dtype == torch.bfloat16 and start == 512:
                out["paged_attention_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                    bound_ms=bnd, bound_by=by, library_ms=None)
        # K6's edges: name -> (C, kv heads, q heads, start, total); key tiles
        # of 64 at +- 1, a ragged C, total below start + C, keys past the
        # table, no visible key (exact zeros), g = 1 and g = 8
        chunk_edges = {
            "tile edges": (65, KVH, H, 63, 128),
            "ragged C=100": (100, KVH, H, 48, 148),
            "total below start + C": (100, KVH, H, 48, 120),
            "past the table": (64, KVH, H, ctx - 20, ctx + 44),
            "no visible key": (16, KVH, H, 0, 0),
            "g=1": (100, KVH, KVH, 30, 130),
            "g=8": (100, KVH // 2, H, 30, 130),
            # moe-1b's chunks of the 700-token prompt: g = 3, so one
            # position's query heads straddle the 64-row tiles
            "moe-1b g=3 start=0": (C, 4, 12, 0, C),
            "moe-1b g=3 start=256": (C, 4, 12, 256, 256 + C),
            "moe-1b g=3 start=512": (C, 4, 12, 512, 512 + C),
            "moe-1b g=3 ragged C=100": (100, 4, 12, 48, 148),
        }
        for name, (Ce, KVHe, He, start, total) in chunk_edges.items():
            qe = rnd((Ce, He, hd), dtype)
            kpe, vpe = kp[:KVHe].contiguous(), vp[:KVHe].contiguous()
            got = paged_attention.paged_attention_chunk(qe, kpe, vpe, t1, start, total)
            meta = chunk_meta_on_card(f"{tag} {name}", got, qe, kpe, vpe, t1, start, total)
            want = paged_attention._chunk_reference(qe, kpe, vpe, t1, start, total, hd ** -0.5)
            err = check_close(f"paged_attention_chunk {name}", "attention", dtype, got, want)
            if total == 0 and bool(got.float().abs().max() != 0):
                fail(f"paged_attention_chunk {name}: rows with no visible key must give zeros")
            ms = device_ms(lambda: paged_attention.paged_attention_chunk(qe, kpe, vpe, t1, *meta))
            bnd, by = chunk_bound(qe, kpe, t1, start, total)
            log(f"K6 paged_attention_chunk {tag} {name}: max_err {err:.3e} ms {ms:.4f} "
                f"bound {bnd:.4f} ({by})")

        # K7: the engine's verify span: 8 slots, k = 4 drafts + the last
        # committed token, positions spread over the context. Bytes: q and o
        # once, each sequence's live K/V rows once per kv head.
        S = 5
        positions = torch.tensor([20, 100, 333, 500, 640, 777, 850, 900], dtype=torch.int32,
                                 device="cuda")
        q = rnd((B, S, H, hd), dtype)
        got = paged_attention.paged_attention_verify(q, kp, vp, table, positions)
        want = paged_attention._verify_reference(q, kp, vp, table, positions, hd ** -0.5)
        err = check_close("paged_attention_verify", "attention", dtype, got, want)
        ms = device_ms(lambda: paged_attention.paged_attention_verify(q, kp, vp, table,
                                                                      positions))
        plain = device_ms(lambda: paged_attention._verify_reference(q, kp, vp, table, positions,
                                                                  hd ** -0.5))
        bnd, by = verify_bound(q, kp, table, positions)
        log(f"K7 paged_attention_verify {tag} B={B} S={S} positions {positions.tolist()}: "
            f"max_err {err:.3e} (tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
            f"bound {bnd:.4f} ({by}); library: none (no single PyTorch call attends over a "
            f"page table)")
        if dtype == torch.bfloat16:
            out["paged_attention_verify"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                 bound_ms=bnd, bound_by=by, library_ms=None)
        # K7's edges: (S, heads, kv heads, positions, zero table). On the
        # tensor cores K7 cuts each sequence's keys into splits of
        # VERIFY_SPLIT_KEYS (128) and merges them on the card.
        sk = paged_attention.VERIFY_SPLIT_KEYS
        edges = {
            "S=1 (decode)": (1, H, KVH, [0, 1, 17, 100, 333, 700, 1000, 1023], False),
            "S=2": (2, H, KVH, [0, 15, 16, 100, 333, 700, 1000, 1022], False),
            "S=65 (k=64)": (65, H, KVH, [0, 3, 64, 100, 333, 700, 900, 959], False),
            "g=1": (S, KVH, KVH, [0, 20, 100, 333, 500, 640, 777, 900], False),
            "g=8": (S, H, KVH // 2, [0, 20, 100, 333, 500, 640, 777, 900], False),
            # moe-1b's ngram verify widths S = 1..k+1 at g = 3
            "moe-1b g=3 S=1": (1, 12, 4, [0, 1, 17, 100, 333, 700, 1000, 1023], False),
            "moe-1b g=3 S=2": (2, 12, 4, [0, 15, 16, 100, 333, 700, 1000, 1022], False),
            "moe-1b g=3 S=3": (3, 12, 4, [20, 100, 333, 500, 640, 777, 850, 900], False),
            "moe-1b g=3 S=5": (S, 12, 4, [20, 100, 333, 500, 640, 777, 850, 900], False),
            "moe-1b g=3 split edges +-1": (S, 12, 4, [sk - 2, sk - 1, sk, sk + 1, 2 * sk - 1,
                                                      2 * sk, 7 * sk - 1, 7 * sk], False),
            "inactive slots": (S, H, KVH, [0] * B, True),
            "span past the table": (S, H, KVH, [1023, 1022, 1020, 1019, 1000, 7, 0, 1023],
                                    False),
            "split edges +-1": (S, H, KVH, [sk - 2, sk - 1, sk, sk + 1, 2 * sk - 1, 2 * sk,
                                            7 * sk - 1, 7 * sk], False),
            "span crosses a split": (S, H, KVH, [sk - 3, 2 * sk - 4, 3 * sk - 2, 4 * sk - 3,
                                                 5 * sk - 1, 6 * sk - 4, 0, 7 * sk - 2], False),
            "B=1 one sequence of 1024 keys": (S, H, KVH, [1019], False),
        }
        for name, (Se, He, KVHe, pos, zero_table) in edges.items():
            pe = torch.tensor(pos, dtype=torch.int32, device="cuda")
            te = torch.zeros_like(table) if zero_table else table
            te = te[:len(pos)].contiguous()
            qe = rnd((len(pos), Se, He, hd), dtype)
            kpe, vpe = kp[:KVHe].contiguous(), vp[:KVHe].contiguous()
            got = paged_attention.paged_attention_verify(qe, kpe, vpe, te, pe)
            want = paged_attention._verify_reference(qe, kpe, vpe, te, pe, hd ** -0.5)
            err = check_close(f"paged_attention_verify {name}", "attention", dtype, got, want)
            if Se == 1:  # one row per sequence is a decode step
                dec = paged_attention.paged_attention_decode(qe[:, 0].contiguous(), kpe, vpe,
                                                             te, pe + 1)
                err = max(err, check_close("paged_attention_verify S=1 vs K5", "attention",
                                           dtype, got[:, 0], dec))
            ms = device_ms(lambda: paged_attention.paged_attention_verify(qe, kpe, vpe, te, pe))
            bnd, by = verify_bound(qe, kpe, te, pe)
            log(f"K7 paged_attention_verify {tag} {name}: max_err {err:.3e} ms {ms:.4f} "
                f"bound {bnd:.4f} ({by})")
        # two calls back to back on one stream with other positions: the
        # second call's split workspace is the first's, returned to the
        # allocator
        pa = torch.tensor([1019, 0, 129, 5, 333, 1, 640, 127], dtype=torch.int32, device="cuda")
        pb = torch.tensor([1, 1019, 0, 300, 128, 900, 17, 256], dtype=torch.int32, device="cuda")
        a = paged_attention.paged_attention_verify(q, kp, vp, table, pa)
        b = paged_attention.paged_attention_verify(q, kp, vp, table, pb)
        err = max(check_close("paged_attention_verify back to back (1)", "attention", dtype, a,
                              paged_attention._verify_reference(q, kp, vp, table, pa,
                                                                hd ** -0.5)),
                  check_close("paged_attention_verify back to back (2)", "attention", dtype, b,
                              paged_attention._verify_reference(q, kp, vp, table, pb,
                                                                hd ** -0.5)))
        log(f"K7 paged_attention_verify {tag} two calls back to back: max_err {err:.3e}")
    torch.cuda.synchronize()
    return out


def decode_bound(q, k_pages, table, lengths) -> tuple:
    """K5's bound: q and o once, each sequence's live K/V rows (up to the
    table's end) once per kv head, the table and lengths once."""
    ctx = table.shape[1] * k_pages.shape[2]
    keys = int(lengths.clamp(max=ctx).sum())
    KVH, hd, el = k_pages.shape[0], k_pages.shape[3], k_pages.element_size()
    return bound_ms((2 * q.numel() + 2 * keys * KVH * hd) * el
                    + 4 * (table.numel() + lengths.numel()), 4 * keys * q.shape[1] * hd, q.dtype)


def chunk_bound(q, k_pages, table, start: int, total: int) -> tuple:
    """K6's bound: q and o once, the live K/V rows (below total, up to the
    table's end) once per kv head, the table once; operations over the
    visible (row, key) pairs."""
    ctx = table.shape[0] * k_pages.shape[2]
    KVH, hd, el = k_pages.shape[0], k_pages.shape[3], k_pages.element_size()
    keys = max(0, min(total, ctx))
    pairs = sum(max(0, min(start + c + 1, total, ctx)) for c in range(q.shape[0]))
    return bound_ms((2 * q.numel() + 2 * keys * KVH * hd) * el + 4 * table.numel(),
                    4 * q.shape[1] * hd * pairs, q.dtype)


def verify_bound(q, k_pages, table, positions) -> tuple:
    """K7's bound: q and o once, each sequence's live K/V rows (up to the
    table's end) once per kv head, the table and positions once; operations
    over the visible (row, key) pairs."""
    B, S, H, hd = q.shape
    ctx = table.shape[1] * k_pages.shape[2]
    KVH, el = k_pages.shape[0], k_pages.element_size()
    pos = [max(p, 0) for p in positions.tolist()]
    keys = sum(min(p + S, ctx) for p in pos)
    pairs = sum(min(p + s + 1, ctx) for p in pos for s in range(S))
    return bound_ms((2 * q.numel() + 2 * keys * KVH * hd) * el + 4 * (table.numel() + B),
                    4 * H * hd * pairs, q.dtype)


def training_kernel_checks(gen) -> dict:
    """K2 with lse, K3 and K4 vs their plain versions at the training path's
    shape (llama-2b, batch 4 x 2048), at a ragged T, at g = 1 and at
    moe-1b's training shape (2 x 1024, 12/4 heads). Returns,
    per kernel, the bf16 figures at the training shape."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    out = {}
    D = 128
    # (B, T, H, KVH): the training shape first, then a ragged T, g = 1 and
    # moe-1b's training shape (g = 3)
    shapes = [(4, 2048, 20, 5), (2, 1000, 20, 5), (2, 1024, 8, 8), (2, 1024, 12, 4)]

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for B, T, H, KVH in shapes:
            main = (B, T, H, KVH) == shapes[0]
            reps, trials = (5, 3) if main else (3, 3)
            q, do = rnd((B, T, H, D), dtype), rnd((B, T, H, D), dtype)
            k, v = rnd((B, T, KVH, D), dtype), rnd((B, T, KVH, D), dtype)
            pairs = T * (T + 1) // 2
            rows = 4 * B * H * T  # bytes of one f32 [B, H, T]
            shape = f"B={B} T={T} H={H}/{KVH}"

            # K2 with lse
            o, lse = attention.flash_attention_with_lse(q, k, v)
            want_o, want_lse = attention._fwd_reference_with_lse(q, k, v)
            err = max(check_close("flash_attention+lse", "attention", dtype, o, want_o),
                      check_close("flash_attention+lse lse", "lse", dtype, lse, want_lse))
            tile = attention.kernel_symbol("flash_attention", dtype, D)
            ms = device_ms(lambda: attention.flash_attention_with_lse(q, k, v), reps, trials)
            plain = device_ms(lambda: attention._fwd_reference_with_lse(q, k, v), reps, trials)
            bnd, by = bound_ms((2 * q.numel() + k.numel() + v.numel()) * el + rows,
                               4 * B * H * D * pairs, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps, trials)
            log(f"K2+lse flash_attention {tag} {shape} [{tile}]: max_err {err:.3e} ms {ms:.4f} "
                f"plain {plain:.4f} bound {bnd:.4f} ({by}) sdpa {lib_fwd:.4f} "
                f"(kernel / sdpa {ms / lib_fwd:.2f})")
            del want_o, want_lse

            # K3 / K4 from the plain forward's o and lse
            o, lse = attention._fwd_reference_with_lse(q, k, v)
            delta = attention._attention_delta(o, do)
            dq = attention.flash_attention_bwd_dq(q, k, v, do, lse, delta)
            err_dq = check_close("flash_attention_bwd_dq", "attention", dtype, dq,
                                 attention._dq_reference(q, k, v, do, lse, delta))
            tile_dq = attention.kernel_symbol("flash_attention_bwd_dq", dtype, D)
            dk, dv = attention.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
            want_dk, want_dv = attention._dkv_reference(q, k, v, do, lse, delta)
            err_dkv = max(check_close("flash_attention_bwd_dkv dk", "attention", dtype, dk,
                                      want_dk),
                          check_close("flash_attention_bwd_dkv dv", "attention", dtype, dv,
                                      want_dv))
            del dq, dk, dv, want_dk, want_dv
            ms_dq = device_ms(lambda: attention.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                              reps, trials)
            ms_dkv = device_ms(lambda: attention.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                         delta), reps, trials)
            plain_dq = device_ms(lambda: attention._dq_reference(q, k, v, do, lse, delta),
                                 reps, trials)
            plain_dkv = device_ms(lambda: attention._dkv_reference(q, k, v, do, lse, delta),
                                  reps, trials)
            # the reference's cost estimates (ray_tpu/ops/attention.py:334, :366)
            # over the causal (q, k) pairs; bytes: each input read once, each
            # output written once
            bnd_dq, by_dq = bound_ms((3 * q.numel() + k.numel() + v.numel()) * el + 2 * rows,
                                     6 * B * H * D * pairs, dtype)
            bnd_dkv, by_dkv = bound_ms((2 * q.numel() + 2 * k.numel() + 2 * v.numel()) * el
                                       + 2 * rows, 8 * B * H * D * pairs, dtype)
            # yardstick: one autograd.grad through SDPA, dq + dk + dv together
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib = device_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                        retain_graph=True), reps, trials)
            del ot, qt, kt, vt
            log(f"K3 flash_attention_bwd_dq {tag} {shape} [{tile_dq}]: max_err {err_dq:.3e} "
                f"ms {ms_dq:.4f} plain {plain_dq:.4f} bound {bnd_dq:.4f} ({by_dq}); "
                f"SDPA backward (dq+dk+dv) {lib:.4f} (kernel / sdpa {ms_dq / lib:.2f})")
            tile_dkv = attention.kernel_symbol("flash_attention_bwd_dkv", dtype, D)
            log(f"K4 flash_attention_bwd_dkv {tag} {shape} [{tile_dkv}]: max_err {err_dkv:.3e} "
                f"ms {ms_dkv:.4f} plain {plain_dkv:.4f} bound {bnd_dkv:.4f} ({by_dkv}); "
                f"SDPA backward (dq+dk+dv) {lib:.4f} (kernel / sdpa {ms_dkv / lib:.2f}); "
                f"K3+K4 {ms_dq + ms_dkv:.4f}")
            if dtype == torch.bfloat16 and main:
                out["flash_attention_lse"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                  bound_ms=bnd, bound_by=by, library_ms=lib_fwd)
                out["flash_attention_bwd_dq"] = dict(
                    max_abs_err=err_dq, ms=ms_dq, plain_ms=plain_dq, bound_ms=bnd_dq,
                    bound_by=by_dq, library_ms=lib)
                out["flash_attention_bwd_dkv"] = dict(
                    max_abs_err=err_dkv, ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bnd_dkv,
                    bound_by=by_dkv, library_ms=lib)
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


# -------------------------------------------------------------- phase 3


def run_requests(server, requests):
    """All requests at once, one thread each -> (results, wall s, errors)."""
    results = [None] * len(requests)
    errors = []

    def run(i):
        try:
            results[i] = server(requests[i])
        except Exception as e:  # noqa: BLE001 — reported as this phase's failure
            errors.append(f"request {i}: {e!r}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    if any(t.is_alive() for t in threads):
        errors.append("a request did not finish in 600 s")
    return results, time.monotonic() - t0, errors


# host-side launch calls a profiler records: one per eager kernel launch,
# one per graph replay; and calls that wait for the card (a synchronise,
# or a copy that PyTorch follows with one)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cuGraphLaunch")
WAIT_APIS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy")


def profile_report(run) -> dict:
    """run() under torch.profiler: device time by kernel (the top 20, then
    the port's own kernels below them), the card's busy share of the wall
    time that run() returns, in seconds, and the host's launch calls and
    waits for the card by API, with the host time spent in them (summed
    over threads). Returns {"kernels": kernel executions seen, "names":
    their names, "api": launch calls by API}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    rows, api, host_ms = [], {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            # host events carry their kernels' device time too: not summed
            if ev.key in LAUNCH_APIS + WAIT_APIS:
                if ev.key in LAUNCH_APIS:
                    api[ev.key] = api.get(ev.key, 0) + ev.count
                host_ms[ev.key] = (ev.count, ev.cpu_time_total / 1e3)
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    log(f"profile: wall {wall:.3f}s, device busy {busy_s:.3f}s "
        f"({100 * busy_s / wall:.1f}% busy, {100 - 100 * busy_s / wall:.1f}% idle), "
        f"{launches} kernels ran; host calls (count, host ms summed over threads): "
        + ", ".join(f"{k} {n} ({ms:.1f} ms)" for k, (n, ms) in sorted(host_ms.items())))
    for dev_us, count, key in rows[:20]:
        log(f"  {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    for dev_us, count, key in rows[20:]:  # the port's kernels below the top 20
        if any(stem in key for stem in PORT_KERNEL_STEMS):
            log(f"  {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    return {"kernels": launches, "names": [r[2] for r in rows], "api": api}


def require_kernels(label: str, names, stems) -> None:
    """Fails unless, for each stem, some kernel name holds it."""
    for stem in stems:
        if not any(stem in n for n in names):
            fail(f"{label}: no kernel named *{stem}* ran; the profiler saw {sorted(set(names))}")


@contextlib.contextmanager
def swapped(module, **attrs):
    """Bind module.<name> to the given objects while the block runs."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, obj in attrs.items():
        setattr(module, name, obj)
    try:
        yield
    finally:
        for name, obj in saved.items():
            setattr(module, name, obj)


def planted(module, fault):
    """Swap one of the module's kernel wrappers for a wrong one while the
    block runs (the negative controls of a gate)."""
    name, make = fault
    return swapped(module, **{name: make(getattr(module, name))})


# Engine faults the logprob gate must catch, each planted by wrapping the
# kernel wrapper the engine's device programs call: name -> (attribute of
# serve.programs, wrapper maker)
FAULTS = {
    # decode attends over pos keys, not pos + 1: it misses its own key
    "decode_length_off_by_one": ("paged_attention_decode", lambda f: (
        lambda q, kp, vp, tables, lengths: f(q, kp, vp, tables, (lengths - 1).clamp(min=0)))),
    # each slot reads its neighbour's page table: pages of another sequence
    "decode_wrong_pages": ("paged_attention_decode", lambda f: (
        lambda q, kp, vp, tables, lengths: f(q, kp, vp, tables.roll(1, 0).contiguous(),
                                             lengths))),
    # chunked prefill: every row also sees the key one position ahead
    "chunk_mask_off_by_one": ("paged_attention_chunk", lambda f: (
        lambda q, kp, vp, table, start, total: f(q, kp, vp, table, start + 1, total))),
}


def within_logprob_tol(gap) -> bool:
    mx, mean = gap
    return mx <= LOGPROB_TOL["max"] and mean <= LOGPROB_TOL["mean"]


def logprob_gaps(params, cfg, requests, results, yardstick: bool = False,
                 tol=LOGPROB_TOL) -> list:
    """Per request, (max, mean) of |engine logprob - log-softmax of the
    port's full forward| over the output tokens. With `yardstick`, also
    prints both against the same forward run in f32 over the same bf16
    weights, as a measure of bf16 rounding."""
    from ray_tpu_torch.models import transformer

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = params["embed"].device
    gaps = []
    for i, (req, res) in enumerate(zip(requests, results)):
        seq = req["prompt_ids"] + res["token_ids"]
        T = len(req["prompt_ids"])
        toks = torch.tensor([seq[:-1]], device=dev)
        picked = torch.tensor(res["token_ids"], device=dev)[:, None]

        def forward_logprobs(c):
            with torch.no_grad():
                logits, _ = transformer.forward(params, toks, c)
            return torch.log_softmax(logits[0, T - 1:], dim=-1).gather(1, picked)[:, 0]

        ref = forward_logprobs(cfg)
        got = torch.tensor(res["logprobs"], device=dev, dtype=torch.float32)
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            fail(f"request {i}: non-finite logprobs")
        diff = (got - ref).abs()
        gaps.append((diff.max().item(), diff.mean().item()))
        if yardstick:
            ref32 = forward_logprobs(cfg32)
            log(f"request {i}: logprob |engine - forward| max {gaps[-1][0]:.4f} mean "
                f"{gaps[-1][1]:.4f} (tol {tol}); against the f32 forward: "
                f"engine max {(got - ref32).abs().max().item():.4f}, bf16 forward max "
                f"{(ref - ref32).abs().max().item():.4f}")
    return gaps


def report_burst(label: str, requests, results, wall: float) -> str:
    """Per request and for the burst: TTFT, time per output token, tokens/s;
    fails unless every request returned all its tokens. Returns the burst's
    figures in one line."""
    total_tokens = 0
    for i, (req, res) in enumerate(zip(requests, results)):
        n = len(res["token_ids"])
        if n != req["max_tokens"] or res["finish_reason"] != "length":
            fail(f"{label} request {i}: {n} tokens, finish_reason {res['finish_reason']}")
        total_tokens += n
        log(f"{label} request {i}: prompt {len(req['prompt_ids'])} tokens, ttft "
            f"{res['ttft_s']:.3f}s, latency {res['latency_s']:.3f}s, first tokens "
            f"{res['token_ids'][:6]}")
    ttfts = sorted(r["ttft_s"] for r in results)
    tpots = sorted((r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in results)
    log(f"{label}: TTFT s: p50 {statistics.median(ttfts):.4f} max {ttfts[-1]:.4f}; time per "
        f"output token after the first, ms: p50 {1e3 * statistics.median(tpots):.2f} max "
        f"{1e3 * tpots[-1]:.2f} (decode tok/s per request p50 "
        f"{1 / statistics.median(tpots):.2f}); aggregate output tok/s "
        f"{total_tokens / wall:.2f} over {wall:.2f}s wall; {len(results)} requests, "
        f"0 failed")
    return (f"TTFT p50 {statistics.median(ttfts):.4f} s max {ttfts[-1]:.4f} s, TPOT p50 "
            f"{1e3 * statistics.median(tpots):.2f} ms, {total_tokens / wall:.2f} tok/s over "
            f"{wall:.2f} s")


# the serving engines' sizes, phases 3 and 3s
ENGINE = dict(max_batch_size=8, max_seq_len=1024)


def new_server(label: str, **kwargs):
    """An LLMServer (which warms up: captures every program its threads
    can pick); prints the build time, the capture's share and the graph
    pools' size, and the prefill thread's share of both."""
    from ray_tpu_torch.serve import LLMServer

    t0 = time.monotonic()
    server = LLMServer._target(**kwargs)
    torch.cuda.synchronize()
    st = server.engine.capture_stats
    log(f"{label}: built + warmed in {time.monotonic() - t0:.1f}s, of which capture "
        f"{st['seconds']:.1f}s for {st['programs']} programs (graph pools and static "
        f"buffers {st['pool_bytes'] / 2**30:.3f} GiB; of these the prefill thread's "
        f"{st['prefill_programs']} programs {st['prefill_seconds']:.1f}s, "
        f"{st['prefill_pool_bytes'] / 2**30:.3f} GiB in their own pool); memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return server


def reckon_prefill_tiers(engine, batch_size: int = 8) -> None:
    """What the prefill programs would take at prefill_batch_size =
    batch_size, reckoned from this engine's captures without capturing:
    the prefill pool scaled from the measured one by the largest program's
    tokens (a graph's scratch is its body's peak of activations, and one
    pool serves the programs one at a time), the capture time by the
    programs' summed tokens."""
    ecfg, st = engine.ecfg, engine.capture_stats
    buckets, have = ecfg.prefill_buckets, ecfg.prefill_tiers()
    tiers = dataclasses.replace(ecfg, prefill_batch_size=batch_size).prefill_tiers()
    largest, measured = max(buckets) * max(tiers), max(buckets) * max(have)
    pool = st["prefill_pool_bytes"] * largest / measured
    seconds = st["prefill_seconds"] * sum(tiers) / sum(have)
    log(f"reckoned, not captured: prefill_batch_size={batch_size} (tiers {tiers}) captures "
        f"{len(buckets) * len(tiers)} prefill programs, the largest {max(buckets)} x "
        f"{max(tiers)} = {largest} tokens: prefill pool ~{pool / 2**30:.2f} GiB (measured "
        f"{st['prefill_pool_bytes'] / 2**30:.3f} GiB at {measured} tokens, scaled by tokens), "
        f"capture ~{seconds:.0f}s (measured {st['prefill_seconds']:.1f}s for tiers {have}, "
        f"scaled by summed tokens)")


class CallClock:
    """Times calls of some callables on the card while the block runs: the
    entries `names` of `owner`, a dict (an engine's programs) or a module
    or class (its functions). Each call notes the host's clock and records
    a CUDA event before the call (its input copies included) and one after.
    One event synchronised on an idle card at the start ties the card's
    clock to the host's, so each call's wait is when the card reached its
    first event less when the host made the call: the time it queued
    behind work already on the stream (the decode thread's spans, and any
    other engine's on the same card). `timings` holds (name, wait ms, card
    ms between the events, host ms) per call, in call order; the card ms
    include any work another thread enqueued between the two events."""

    def __init__(self, owner, names):
        self.owner, self.names, self.calls = owner, list(names), []

    def _get(self, name):
        return self.owner[name] if isinstance(self.owner, dict) else getattr(self.owner, name)

    def _set(self, name, fn) -> None:
        if isinstance(self.owner, dict):
            self.owner[name] = fn
        else:
            setattr(self.owner, name, fn)

    def __enter__(self):
        torch.cuda.synchronize()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.ref.synchronize()
        self.t_ref = time.perf_counter()
        self.saved = {name: self._get(name) for name in self.names}
        for name, fn in self.saved.items():
            self._set(name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*args):
            t0 = time.perf_counter()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.calls.append((name, t0, a, b, time.perf_counter()))
            return out
        return call

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            self._set(name, fn)
        torch.cuda.synchronize()
        self.timings = [(name, 1e3 * (self.t_ref + self.ref.elapsed_time(a) / 1e3 - t0),
                         a.elapsed_time(b), 1e3 * (t1 - t0))
                        for name, t0, a, b, t1 in self.calls]
        return False

    def column(self, name, field: int) -> str:
        """One field (1 wait, 2 card, 3 host) of the named calls, in ms."""
        return "[" + ", ".join(f"{t[field]:.2f}" for t in self.timings if t[0] == name) + "]"


class PrefillClock(CallClock):
    """The bucketed prefill replays of an engine, timed by CallClock: each
    replay's wait behind the stream's earlier work (the decode thread's
    spans) and its time on the card."""

    def __init__(self, engine):
        super().__init__(engine._programs, [k for k in engine._programs if k[0] == "prefill"])

    def report(self, label: str) -> None:
        log(f"{label}: {len(self.timings)} prefill replays; wait behind the stream's earlier "
            f"work (ms, call order) {[round(t[1], 2) for t in self.timings]}; replay on the card "
            f"(copies + graph, and any work the decode thread enqueued between them, ms) "
            f"{[round(t[2], 2) for t in self.timings]}")


def require_no_eager_launches(label: str) -> None:
    """Fails unless every kernel launch since the counts were reset came
    from a graph replay (dispatch counts replayed launches apart)."""
    from ray_tpu_torch.ops import dispatch

    eager = {name: n for name, n in dispatch.eager_launch_counts().items() if n}
    log(f"{label}: eager launches of the port's kernels {eager or 'none'}: every launch "
        f"came from a graph replay")
    if eager:
        fail(f"{label}: kernels launched outside graph replays: {eager}")


def release() -> None:
    """Free what dropped servers held: their pools and graphs (the weights
    stay while a caller holds them)."""
    gc.collect()
    torch.cuda.empty_cache()


def metric_counts() -> dict:
    """{(sample, tags): value} of the port's counters and histogram counts."""
    from ray_tpu_torch.core import metrics

    out = {}
    for fam in metrics.registry.snapshot():
        for sample, tags, value in fam["samples"]:
            if fam["kind"] == "counter" or sample.endswith("_count"):
                out[(sample, tuple(tuple(t) for t in tags))] = value
    return out


class TelemetryClock:
    """Host time the engine's telemetry takes on each thread while the block
    runs: every metric update (Counter.inc, Gauge.set and add,
    Histogram.observe, slo.Digest.add) and the engine's _note_tokens_per_step
    and _slo_digest, each timed at its outermost call, less the timer's own
    share (the same timer around a call that does nothing); and the decode
    spans the engine ran. The engine's own calls, at their own points: no
    stand-in."""

    def __init__(self, engine):
        self.engine, self.ns, self.calls, self.spans = engine, {}, {}, 0
        self._local, self._stack = threading.local(), contextlib.ExitStack()

    def _timed(self, fn):
        local, ns, calls = self._local, self.ns, self.calls

        def timed(*args, **kwargs):
            if getattr(local, "inside", False):
                return fn(*args, **kwargs)
            local.inside = True
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter_ns() - t0
                local.inside = False
                name = threading.current_thread().name
                ns[name] = ns.get(name, 0) + dt
                calls[name] = calls.get(name, 0) + 1
        return timed

    def __enter__(self):
        from ray_tpu_torch.core import metrics
        from ray_tpu_torch.util import slo

        probe = TelemetryClock(None)
        nothing = probe._timed(lambda: None)
        for _ in range(20000):
            nothing()
        self.timer_ns = sum(probe.ns.values()) / 20000
        engine, span = self.engine, self.engine._decode_span

        def counted_span(*args, **kwargs):
            self.spans += 1
            return span(*args, **kwargs)

        enter = self._stack.enter_context
        for cls, names in ((metrics.Counter, ("inc",)), (metrics.Gauge, ("set", "add")),
                           (metrics.Histogram, ("observe",)), (slo.Digest, ("add",))):
            enter(swapped(cls, **{n: self._timed(getattr(cls, n)) for n in names}))
        enter(swapped(engine, _note_tokens_per_step=self._timed(engine._note_tokens_per_step),
                      _slo_digest=self._timed(engine._slo_digest),
                      _decode_span=counted_span))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        for name in ("_note_tokens_per_step", "_slo_digest", "_decode_span"):
            self.engine.__dict__.pop(name, None)
        return False

    def us(self, thread: str) -> float:
        """The thread's telemetry host time in µs, the timer's share taken off."""
        return max(0.0, self.ns.get(thread, 0) - self.calls.get(thread, 0) * self.timer_ns) / 1e3


def telemetry_report(engine, results, before: dict, clock: TelemetryClock) -> None:
    """After phase 3's plain burst: what the engine's metrics and SLO
    digests saw, beside what the burst measured. Printed; nothing here
    decides the run."""
    delta = {k: v - before.get(k, 0.0) for k, v in metric_counts().items()
             if v - before.get(k, 0.0)}
    emitted = sum(len(r["token_ids"]) for r in results)
    tokens = delta.get(("serve_tokens_generated", ()), 0.0)
    finished = {dict(tags)["finish_reason"]: v for (sample, tags), v in delta.items()
                if sample == "serve_requests_finished"}
    phases = {dict(tags)["phase"]: int(v) for (sample, tags), v in delta.items()
              if sample == "serve_decode_step_phase_seconds_count"}
    log(f"telemetry, plain burst: serve_tokens_generated +{tokens:.0f} against {emitted} "
        f"tokens returned ({'equal' if tokens == emitted else 'DIFFERENT'}); "
        f"serve_requests_finished {finished}; serve_ttft_seconds count "
        f"+{delta.get(('serve_ttft_seconds_count', ()), 0.0):.0f}; decode phase observations "
        f"{phases}")
    ttft, e2e, tbt = (engine._slo_digest(n) for n in ("serve_ttft_seconds", "serve_e2e_seconds",
                                                      "serve_tbt_seconds"))
    measured = sorted(r["ttft_s"] for r in results)
    tpot = statistics.median((r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1)
                             for r in results)
    rel = 10 ** (1 / 20) - 1
    pairs = ((ttft.quantile(0.5), statistics.median(measured)), (ttft.max, measured[-1]))
    within = all(abs(d - m) <= rel * m for d, m in pairs)
    log(f"  SLO digests (role {engine.slo_role}): counts ttft {ttft.count}, e2e {e2e.count}, tbt "
        f"{tbt.count}; serve_ttft_seconds p50 {pairs[0][0]:.4f} max {pairs[1][0]:.4f} s against "
        f"the burst's {pairs[0][1]:.4f} and {pairs[1][1]:.4f} s: "
        f"{'within' if within else 'OUTSIDE'} the digest's relative error {100 * rel:.1f} %; "
        f"serve_tbt_seconds p50 {1e3 * tbt.quantile(0.5):.2f} ms against TPOT p50 "
        f"{1e3 * tpot:.2f} ms")
    decode, prefill = clock.us("engine-decode"), clock.us("engine-prefill")
    log(f"  telemetry's host time on the engine's threads during the burst (every metric "
        f"update, _note_tokens_per_step and _slo_digest, timed where the engine calls them; "
        f"timer's share {clock.timer_ns:.0f} ns a call taken off): decode thread "
        f"{decode:.2f} us in {clock.calls.get('engine-decode', 0)} calls over {clock.spans} "
        f"decode spans, {decode / max(clock.spans, 1):.2f} us a span; prefill thread "
        f"{prefill:.2f} us in {clock.calls.get('engine-prefill', 0)} calls over "
        f"{len(results)} requests; other threads "
        f"{sum(clock.us(t) for t in clock.ns if not t.startswith('engine-')):.2f} us")


def burst_requests(cfg, rng) -> list:
    """Phase 3's burst: five prompts drawn from `rng`, 32 tokens each."""
    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    return [
        {"prompt_ids": prompt(23), "max_tokens": 32},
        {"prompt_ids": prompt(100), "max_tokens": 32},
        {"prompt_ids": prompt(200), "max_tokens": 32},
        {"prompt_ids": prompt(700), "max_tokens": 32},
        {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9},
    ]


def runtime_only(card: str) -> None:
    """`--runtime`: phase 3's server and plain burst, then phase 3r on its
    tensors (no other phase, no result line)."""
    server = new_server("phase 3: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    requests = burst_requests(server.engine.cfg, torch.Generator().manual_seed(1))
    results, wall, errors = run_requests(server, requests)
    if errors:
        fail(f"phase 3 burst: {errors}")
    plain = report_burst("plain", requests, results, wall)
    runtime_path(server, card, requests, results, plain)
    server.shutdown()


def deploy_only(card: str) -> None:
    """`--deploy`: phase 3's server and plain burst, then phase 3d on its
    tensors (no other phase, no result line)."""
    server = new_server("phase 3: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    requests = burst_requests(server.engine.cfg, torch.Generator().manual_seed(1))
    results, wall, errors = run_requests(server, requests)
    if errors:
        fail(f"phase 3 burst: {errors}")
    deploy_path(server, card, report_burst("plain", requests, results, wall))
    server.shutdown()


def serve_main_path(card: str, profile: bool) -> dict:
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve import programs

    server = new_server("phase 3: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    cfg = server.engine.cfg
    log(f"phase 3: llama3-8b d_model {cfg.d_model}, layers {cfg.n_layers}, heads "
        f"{cfg.n_heads}/{cfg.kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")

    rng = torch.Generator().manual_seed(1)  # prompts: seeded, host-side

    def burst():
        return burst_requests(cfg, rng)

    reckon_prefill_tiers(server.engine)
    requests = burst()
    counts = metric_counts()
    dispatch.reset_launches()
    with PrefillClock(server.engine) as clock, TelemetryClock(server.engine) as telemetry:
        results, wall, errors = run_requests(server, requests)
    launches = dispatch.launch_counts()
    if errors:
        server.shutdown()
        fail(f"main path: {errors}")
    log(f"launches on the serving path: {launches}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"serving path never launched kernel {name}")
    require_no_eager_launches("serving path")

    plain = report_burst("plain", requests, results, wall)
    clock.report("plain")
    telemetry_report(server.engine, results, counts, telemetry)

    if profile:  # the same requests again
        def profiled():
            _results, wall, errs = run_requests(server, requests)
            if errs:
                fail(f"profiled run: {errs}")
            return wall

        spans = server.engine._step_count
        seen = profile_report(profiled)
        spans = server.engine._step_count - spans
        tokens = sum(r["max_tokens"] for r in requests)
        log(f"profiled plain burst: {spans} engine iterations, {tokens} output tokens; host "
            f"launch calls per output token {sum(seen['api'].values()) / tokens:.1f} "
            f"(eager: cudaLaunchKernel*/cuLaunchKernel*, graph: cudaGraphLaunch; "
            f"{seen['api']}), kernels run per output token {seen['kernels'] / tokens:.1f}")
        require_kernels("profiled plain burst (K1, K2, K5 and K6 inside graph replays)",
                        seen["names"], ("rms_norm_fwd_", "flash_fwd_wgmma_kernel",
                                        "paged_decode_split_kernel", "paged_chunk_wgmma_kernel"))
    migrate = migrate_path(server, card)  # phase 3m, on this server
    live = live_path(server, card)  # phase 3w, on this server
    runtime = runtime_path(server, card, requests, results, plain)  # phase 3r, its tensors
    deploy, deploy_figures = deploy_path(server, card, plain)  # phase 3d, its tensors
    disagg, disagg_figures = disagg_path(server, card, plain, deploy_figures)  # phase 3g
    fleet = fleet_path(server, card, disagg_figures)  # phase 3f, its tensors
    params = server.engine.params
    server.shutdown()
    del server
    release()
    # the negative controls: a burst of fresh prompts (no prefix hits) per
    # planted fault, each on a server built inside the fault's block, so
    # that the fault is captured into the graphs it must spoil
    faulted = []
    for name, fault in FAULTS.items():
        reqs = burst()
        with planted(programs, fault):
            fs = new_server(f"planted fault {name}", params_fn=lambda: (params, cfg),
                            engine_config=ENGINE)
            res, _wall, errs = run_requests(fs, reqs)
            fs.shutdown()
        del fs
        release()
        if errs:
            fail(f"planted fault {name}: {errs}")
        faulted.append((name, reqs, res))

    # the gate: the engine's logprobs against the port's own full forward,
    # which must pass the sound run and fail each planted fault
    sound = logprob_gaps(params, cfg, requests, results, yardstick=True)
    caught = {}
    for name, reqs, res in faulted:
        gaps = logprob_gaps(params, cfg, reqs, res)
        caught[name] = any(not within_logprob_tol(g) for g in gaps)
        log(f"planted fault {name}: logprob |engine - forward| per request max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]}")
    for i, gap in enumerate(sound):
        if not within_logprob_tol(gap):
            fail(f"request {i}: logprobs differ from the forward by max {gap[0]:.4f}, "
                 f"mean {gap[1]:.4f} (tol {LOGPROB_TOL})")
    for name, hit in caught.items():
        if not hit:
            fail(f"the logprob gate {LOGPROB_TOL} passes planted fault {name}")
    return {"launches": launches, "migrate": migrate, "live": live, "runtime": runtime,
            "deploy": deploy, "disagg": disagg, "fleet": fleet, "params": params, "cfg": cfg,
            "requests": requests, "results": results}


# ------------------------------------------------------------- phase 3m

# Planted import faults, each of which its gate must catch: name ->
# (object, attribute, wrapper maker). The frames and blobs themselves are
# sound; the fault sits in the importing engine.
IMPORT_FAULTS = {
    # the stream's last layer slab never reaches the staging buffer, so
    # the top layers decode over zero KV
    "last_layer_slab_not_ingested": ("engine", "ingest_kv_chunk", lambda f: (
        lambda self, req, frame: None if (
            frame.get("layer0", 0) > 0
            and frame["layer0"] + len(frame["k"]) == self.cfg.n_layers) else f(self, req, frame))),
    # the staged KV lands one page late: token t's KV at position t + page_size
    "scatter_one_page_late": ("module", "_scatter_pages", lambda f: (
        lambda kp, vp, k, v, pages: f(kp, vp, *(
            torch.cat([x.new_zeros((x.shape[0], kp.shape[3]) + tuple(x.shape[2:])), x],
                      1)[:, :x.shape[1]] for x in (k, v)), pages))),
}


def _ms(xs) -> str:
    return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"


def export_kv(engine, prompt, layout=None):
    """One prefill_only request on `engine`: a one-shot blob (layout None,
    export_kv_pages) or a frame stream in `layout` with kv_window 256.
    Returns (frames, or [blob]; the first token's time; the first frame's
    time; host seconds of each gather + host copy)."""
    from ray_tpu_torch.serve import engine as engine_mod

    frames, arrivals, gathers = [], [], []

    def sink(frame):
        arrivals.append(time.monotonic())
        frames.append(frame)

    gather = engine_mod.InferenceEngine._gather_kv

    def timed(self, pages, t):
        t0 = time.perf_counter()
        out = gather(self, pages, t)
        gathers.append(time.perf_counter() - t0)
        return out

    req = engine_mod.Request(request_id=f"export-{time.monotonic_ns()}", prompt=list(prompt),
                             max_tokens=32, prefill_only=True,
                             kv_sink=sink if layout else None, kv_frame_layout=layout or "")
    with swapped(engine_mod.InferenceEngine, _gather_kv=timed):
        engine.add_request(req)
        if not layout:
            frames = [engine.export_kv_pages(req, timeout_s=120)]
        elif not req.done.wait(120):
            fail(f"export of a {len(prompt)}-token prompt did not finish in 120 s")
    if req.error or req.finish_reason != "prefill_done":
        fail(f"export of a {len(prompt)}-token prompt: {req.error or req.finish_reason}")
    return frames, req.first_token_at, (arrivals[0] if arrivals else None), gathers


class TokenStamps:
    """A request's stream_q stand-in that notes when each token is emitted
    (`since`: when the window that finish_busy reads begins)."""

    def __init__(self):
        self.at, self.since = [], 0.0

    def put(self, tok) -> None:
        if tok is not None:
            self.at.append(time.monotonic())


def keep_busy(engine, prompt, n: int = 4, max_tokens: int = 300) -> list:
    """n requests decoding on `engine` (prompts of 100 tokens cut from
    `prompt`), each noting its tokens' times; returns once all n hold a
    decode slot, which opens their window."""
    from ray_tpu_torch.serve.engine import Request

    busy = [Request(request_id=f"busy-{i}-{time.monotonic_ns()}", prompt=prompt[i:i + 100],
                    max_tokens=max_tokens, stream_q=TokenStamps()) for i in range(n)]
    for r in busy:
        engine.add_request(r)
    deadline = time.monotonic() + 60
    while engine.stats()["active"] < n:
        if time.monotonic() > deadline:
            fail("the background requests did not reach their decode slots in 60 s")
        time.sleep(0.002)
    for r in busy:
        r.stream_q.since = time.monotonic()
    return busy


def finish_busy(busy) -> str:
    """Wait for the background requests -> over the tokens of their window
    (from when all held a slot to their end), their TPOT p50 and max and
    the longest gap between two of a request's tokens (a decode span's
    tokens arrive together, so a gap is a span, or a span and what held it
    up)."""
    for r in busy:
        if not r.done.wait(120) or r.error:
            fail(f"a background request failed: {r.error}")
    return stream_figures(busy, max(r.stream_q.since for r in busy))


def import_kv(engine, prompt, frames):
    """Import a blob ([blob]) or a frame stream into `engine` and decode 32
    tokens -> (result dict as the server gives it, host seconds of the
    staging: begin + ingest + finish)."""
    from ray_tpu_torch.serve.engine import Request

    req = Request(request_id=f"import-{time.monotonic_ns()}", prompt=list(prompt), max_tokens=32)
    t0 = time.perf_counter()
    if "seq" not in frames[0]:
        engine.import_kv_pages(req, frames[0])
    else:
        meta, last = frames[0], frames[-1]
        if engine.begin_kv_import(req, meta["true_len"], meta):
            for f in frames:
                engine.ingest_kv_chunk(req, f)
            engine.finish_kv_import(req, last["first_token"], last["first_logprob"])
    staged = time.perf_counter() - t0
    if not req.done.wait(120):
        fail(f"import of a {len(prompt)}-token prompt did not finish in 120 s")
    if req.error:
        fail(f"import of a {len(prompt)}-token prompt: {req.error}")
    return {"token_ids": list(req.output), "logprobs": list(req.output_logprobs),
            "finish_reason": req.finish_reason}, staged


def host_copy_forms(shape, reps: int = 5) -> str:
    """The export's host copy of one gathered K (or V) of `shape` [L, T,
    KVH, hd] in bf16, in two forms taken in turns on an idle card: widened
    to float32 on the card and then copied (twice the bytes over the bus),
    and copied in bf16 and then widened on the host (_gather_kv's form).
    -> host ms, medians over `reps` turns, and the copies' rates."""
    x = torch.randn(shape, device="cuda").to(torch.bfloat16)
    on_card, copy, widen = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = x.float().cpu()
        t1 = time.perf_counter()
        b = x.cpu()
        t2 = time.perf_counter()
        c = b.float()
        t3 = time.perf_counter()
        if not torch.equal(a, c):
            fail("the two host copy forms of the export differ")
        on_card.append(1e3 * (t1 - t0))
        copy.append(1e3 * (t2 - t1))
        widen.append(1e3 * (t3 - t2))
    mib = x.numel() * 2 / 2**20
    m = [statistics.median(v) for v in (on_card, copy, widen)]
    return (f"{mib:.2f} MiB of bf16 {list(shape)}: widened on the card, then copied "
            f"{m[0]:.2f} ms ({2 * mib / 1024 / m[0] * 1e3:.2f} GiB/s); copied in bf16 {m[1]:.2f} "
            f"ms ({mib / 1024 / m[1] * 1e3:.2f} GiB/s), then widened on the host {m[2]:.2f} ms: "
            f"{m[1] + m[2]:.2f} ms in all (medians of {reps} turns)")


def wire_bytes(frames) -> int:
    return sum(f["k"].nbytes + f["v"].nbytes for f in frames)


def migration_line(label, p, frames, got, want=None) -> str:
    line = (f"{label}, {len(p)}-token prompt: {len(frames)} frame(s), "
            f"{wire_bytes(frames) / 2**20:.2f} MiB on the wire")
    if want is not None:
        lp = max(abs(a - b) for a, b in zip(got["logprobs"], want["logprobs"]))
        same = got["token_ids"] == want["token_ids"]
        line += (f"; tokens {'identical' if same else 'differ'}, logprob |import - source| "
                 f"max {lp:.2e}")
    return line


def export_timings(gathers, first_at, frame_at, staged=None) -> str:
    out = f"  export: gather + host copy {_ms(1e3 * g for g in gathers)} ms"
    if frame_at is not None:
        out += f"; first frame {1e3 * (frame_at - first_at):+.2f} ms after the first token"
    return out + (f"; import staging {1e3 * staged:.2f} ms" if staged is not None else "")


def round_trip(server, dst, prompt, layout, label: str) -> tuple:
    """Gate (a), for one prompt: export it from the server's engine (a
    one-shot blob where layout is None, else a frame stream in `layout`),
    import it into engine `dst`, alone on both, and then run it on the
    source uninterrupted (after the export, so that the export's prefill
    finds nothing cached). The import's 32 tokens must equal the source's,
    and every launch of the export and the import must come from a graph
    replay; the launch counts are read around those two only. -> (frames,
    the source's result, the export's and the import's launch counts)."""
    from ray_tpu_torch.ops import dispatch

    dispatch.reset_launches()
    frames, first_at, frame_at, gathers = export_kv(server.engine, prompt, layout)
    got, staged = import_kv(dst, prompt, frames)
    launches = dispatch.launch_counts()
    require_no_eager_launches(label)
    want = server({"prompt_ids": prompt, "max_tokens": 32})
    log(migration_line(label, prompt, frames, got, want))
    log(export_timings(gathers, first_at, frame_at, staged))
    if got["token_ids"] != want["token_ids"]:
        fail(f"{label}: the import of a {len(prompt)}-token prompt gave "
             f"{got['token_ids'][:8]}..., the source {want['token_ids'][:8]}...")
    return frames, want, launches


def migrate_path(server, card: str) -> dict:
    """Phase 3m: KV migration from phase 3's llama3-8b server (page size
    16) into a second engine over the same parameter tensors: (a) at page
    size 16, token-exact against the source's own uninterrupted run, with
    the planted import faults, then under load on both engines; (b) at
    page size 8. Under load and (b) are held to phase 3's logprob gate.
    Every export has a fresh prompt, so that no prefix-cache hit shortens
    its prefill; the source's own run of a prompt comes after its export.
    Returns the launch counts of (a) and (b), summed."""
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve import engine as engine_mod

    src = server.engine
    cfg, params = src.cfg, src.params
    rng = torch.Generator().manual_seed(3)

    def prompt(n):  # 200: bucketed prefill (K2) on the source; 700: chunked (K6)
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    per_token = 2 * cfg.n_layers * cfg.kv_heads * cfg.hdim
    log(f"phase 3m: KV migration, llama3-8b ({card}): per token {per_token * 2 / 2**10:.0f} KiB "
        f"of bf16 KV in the pool and on the host copy, {per_token * 4 / 2**10:.0f} KiB as "
        f"float32 on the wire")

    # (a) page size 16: prompts of 200 and 700 tokens, each once as a blob
    # and once streamed layer-major (kv_window 256), each imported alone
    dst = new_server("phase 3m: destination engine, page size 16",
                     params_fn=lambda: (params, cfg), engine_config=ENGINE)
    streamed, wants, launches_a = [], [], {}
    with CallClock(engine_mod, ("_gather_pages", "_scatter_pages")) as clock:
        for n in (200, 700):
            for layout in (None, "layer"):
                p = prompt(n)
                frames, want, counts = round_trip(
                    server, dst.engine, p, layout,
                    f"phase 3m (a) {'streamed layer-major' if layout else 'blob'}")
                launches_a = {k: launches_a.get(k, 0) + c for k, c in counts.items()}
                if layout:
                    streamed.append((p, frames))
                    wants.append(want)
    for what in clock.names:
        log(f"  {what} (a, source and destination alone): wait behind the stream's earlier "
            f"work {clock.column(what, 1)} ms; on the card (the scatter with its copy to the "
            f"card) {clock.column(what, 2)} ms")

    log(f"  the export's host copy of the 700-token prompt's K (its V the same), idle card: "
        f"{host_copy_forms((cfg.n_layers, 700, cfg.kv_heads, cfg.hdim))}")

    # the planted import faults, on the streamed frames of (a)
    for name, (owner, attr, make) in IMPORT_FAULTS.items():
        target = engine_mod.InferenceEngine if owner == "engine" else engine_mod
        caught = []
        with swapped(target, **{attr: make(getattr(target, attr))}):
            for (p, frames), want in zip(streamed, wants):
                got, _staged = import_kv(dst.engine, p, frames)
                same = sum(a == b for a, b in zip(got["token_ids"], want["token_ids"]))
                caught.append(got["token_ids"] != want["token_ids"])
                log(f"phase 3m planted fault {name}, {len(p)}-token prompt: {same} of 32 tokens "
                    f"agree with the source")
        if not any(caught):
            fail(f"phase 3m: gate (a) passes planted import fault {name}")

    # under load: four requests decode on each engine, first alone, then
    # while blobs and streams of fresh prompts migrate from the source to
    # the destination, so that the gathers queue behind decode spans and
    # the exports and scatters hold up the decode threads; the imports
    # share their batch with others, so this step is held to the logprob
    # gate
    busy = keep_busy(src, prompt(400)), keep_busy(dst.engine, prompt(400))
    alone = [finish_busy(b) for b in busy]
    loaded = [[], []]
    busy = keep_busy(src, prompt(400)), keep_busy(dst.engine, prompt(400))
    with CallClock(engine_mod, ("_gather_pages", "_scatter_pages")) as clock:
        for n in (200, 700):
            for layout in (None, "layer"):
                p = prompt(n)
                frames, first_at, frame_at, gathers = export_kv(src, p, layout)
                got, staged = import_kv(dst.engine, p, frames)
                log(migration_line(f"phase 3m under load, "
                                   f"{'streamed layer-major' if layout else 'blob'}",
                                   p, frames, got))
                log(export_timings(gathers, first_at, frame_at, staged))
                loaded[0].append({"prompt_ids": p, "max_tokens": 32})
                loaded[1].append(got)
    during = [finish_busy(b) for b in busy]
    for side, a, d in zip(("source", "destination"), alone, during):
        log(f"  the {side}'s 4 background requests (300 tokens each): without migration "
            f"{a}; during the migrations {d}")
    for what in clock.names:
        log(f"  {what} under load (4 requests decoding on each engine): wait behind the "
            f"stream's earlier work {clock.column(what, 1)} ms; on the card "
            f"{clock.column(what, 2)} ms")
    dst.shutdown()
    del dst
    release()

    # (b) page size 8: (a)'s layer-major streams, and token-major streams of
    # the same prompts (re-exported: the source's runs cached them)
    dst = new_server("phase 3m: destination engine, page size 8",
                     params_fn=lambda: (params, cfg), engine_config=dict(ENGINE, page_size=8))
    at8 = [[], []]
    dispatch.reset_launches()
    with CallClock(engine_mod, ("_scatter_pages",)) as clock:
        for (p, frames), want in zip(streamed, wants):
            for layout in ("layer", "token"):
                if layout == "token":
                    frames = export_kv(src, p, layout)[0]
                got, _staged = import_kv(dst.engine, p, frames)
                log(migration_line(f"phase 3m (b) page size 8, streamed {layout}-major", p,
                                   frames, got, want))
                at8[0].append({"prompt_ids": p, "max_tokens": 32})
                at8[1].append(got)
    launches_b = dispatch.launch_counts()
    require_no_eager_launches("phase 3m (b)")
    log(f"  _scatter_pages (b): wait {clock.column('_scatter_pages', 1)} ms; on the card "
        f"{clock.column('_scatter_pages', 2)} ms")
    dst.shutdown()
    del dst
    release()
    for label, (reqs, res) in (("(b)", at8), ("under load", loaded)):
        gaps = logprob_gaps(params, cfg, reqs, res)
        log(f"phase 3m {label} logprob |engine - forward| per import max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]} "
            f"(tol {LOGPROB_TOL})")
        for req, gap in zip(reqs, gaps):
            if not within_logprob_tol(gap):
                fail(f"phase 3m {label}: a {len(req['prompt_ids'])}-token import's logprobs "
                     f"differ from the forward by max {gap[0]:.4f}, mean {gap[1]:.4f} "
                     f"(tol {LOGPROB_TOL})")
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    log(f"launches on the migration path, (a) and (b) (exports on the source, imports decoding "
        f"on the destinations): {launches}")
    for name in ("rms_norm", "flash_attention", "paged_attention_chunk",
                 "paged_attention_decode"):
        if launches[name] <= 0:
            fail(f"phase 3m never launched kernel {name}")
    return launches


# ------------------------------------------------------------- phase 3w


def leaf_checksums(params) -> dict:
    """Per leaf, the sum of its bits viewed as int16 words, in int64: equal
    sums for a restored tree say its bits came back."""
    return {name: int(t.contiguous().view(torch.int16).sum(dtype=torch.int64))
            for name, t in named_leaves(params)}


def host_tree(tree):
    """A tree of card tensors as numpy arrays on the host."""
    return {k: host_tree(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}


class SwapClock:
    """Times update_params' swap while the block runs. On the card: a CUDA
    event before the copies into the live tensors and one after the f32
    head refresh, both enqueued under the replay lock, so no program runs
    between them; and, from one event synchronised on an idle card at the
    start (as CallClock does), how long after the host reached the copies
    the card began them. On the host: whether the stream still held work
    when the copies began, each leaf's copy call and the head refresh.
    `on_swap`, if given, is called inside the swap, under the lock, before
    the first copy."""

    def __init__(self, engine, on_swap=None):
        self.engine, self.on_swap, self.swaps = engine, on_swap, []

    def __enter__(self):
        torch.cuda.synchronize()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.ref.synchronize()
        self.t_ref = time.perf_counter()
        copy, refresh = self.engine._copy_into_live, self.engine._model.refresh_head

        def timed_copy(live, staged):
            if self.on_swap is not None:
                self.on_swap()
            at = time.perf_counter()
            swap = {"busy": not torch.cuda.current_stream().query(), "at": at,
                    "a": torch.cuda.Event(enable_timing=True), "leaf_ms": []}
            swap["a"].record()
            swap["first_ms"] = 1e3 * (time.perf_counter() - at)
            self.swaps.append(swap)
            for dst, src in zip(live, staged):
                t = time.perf_counter()
                copy([dst], [src])
                swap["leaf_ms"].append(1e3 * (time.perf_counter() - t))

        def timed_refresh():
            t = time.perf_counter()
            refresh()
            swap = self.swaps[-1]
            swap["refresh_ms"] = 1e3 * (time.perf_counter() - t)
            swap["b"] = torch.cuda.Event(enable_timing=True)
            swap["b"].record()

        self.engine._copy_into_live, self.engine._model.refresh_head = timed_copy, timed_refresh
        return self

    def __exit__(self, *exc):
        del self.engine._copy_into_live, self.engine._model.refresh_head
        return False

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s["a"].elapsed_time(s["b"]) for s in self.swaps]

    def report(self, label: str) -> None:
        torch.cuda.synchronize()
        for s in self.swaps:
            leaf = s["leaf_ms"]
            slow = max(range(len(leaf)), key=leaf.__getitem__)
            began = self.ref.elapsed_time(s["a"]) - 1e3 * (s["at"] - self.t_ref)
            log(f"{label}: the stream {'still held work' if s['busy'] else 'was idle'} when the "
                f"swap's copies began; the card began them {began:.2f} ms after the host "
                f"reached them; host time of the swap's first CUDA calls (a stream query and an "
                f"event record) {s['first_ms']:.2f} ms, of the {len(leaf)} leaf copy calls "
                f"{sum(leaf):.2f} ms "
                f"(the first {leaf[0]:.2f} ms, the slowest, leaf {slow}, {leaf[slow]:.2f} ms, "
                f"the others {sum(leaf) - leaf[slow]:.2f} ms in all), of the head refresh "
                f"{s['refresh_ms']:.2f} ms")


def _head_not_refreshed(engine):
    return swapped(engine._model, refresh_head=lambda: None)


def _last_w_out_not_copied(engine):
    copy, w_out = engine._copy_into_live, engine.params["layers"]["w_out"]

    def faulty(live, staged):
        pairs = [(d[:-1], s[:-1]) if d is w_out else (d, s) for d, s in zip(live, staged)]
        copy([d for d, _ in pairs], [s for _, s in pairs])

    return swapped(engine, _copy_into_live=faulty)


# Planted update faults, each of which phase 3w's exactness gate must
# catch, planted on phase 3's server: name -> maker(engine) of a context.
# A swap torn by a replay between two leaves cannot fail that gate, whose
# prompts run after the update returns; mid_swap_request has its own.
LIVE_FAULTS = {
    # the logits keep reading the old f32 head
    "head32_not_refreshed": _head_not_refreshed,
    # the last layer's FFN output projection keeps the old weights
    "last_layer_w_out_not_copied": _last_w_out_not_copied,
}


@contextlib.contextmanager
def mid_swap_request(engine, prompt, wait_s: float = 1.0):
    """While the block runs, update_params' copies stop after half the
    leaves, submit a one-token request of `prompt`, wait for it up to
    wait_s, then copy the other half. A sound swap holds the replay lock
    throughout, so the request's prefill waits and runs on the new
    weights; a swap that leaves the lock lets it run between the halves.
    Yields the request: its first token and logprob name the weights its
    prefill ran on."""
    from ray_tpu_torch.serve.engine import Request

    copy = engine._copy_into_live
    req = Request(request_id=f"mid-swap-{time.monotonic_ns()}", prompt=list(prompt),
                  max_tokens=1)

    def halves(live, staged):
        h = len(live) // 2
        copy(live[:h], staged[:h])
        engine.add_request(req)
        req.done.wait(wait_s)
        copy(live[h:], staged[h:])

    with swapped(engine, _copy_into_live=halves):
        yield req


def live_streams(engine, prompts, max_tokens: int, update=None):
    """Greedy requests decoding together on `engine`, each noting its
    tokens' times; with `update`, it is called once every request holds
    at least 8 tokens and the decode thread has enqueued its next span,
    so that it lands while that span runs. Fails unless each returns
    max_tokens tokens in [0, V) without error. -> (requests, what update returned, when it was called
    and when it returned, on the host's clock)."""
    from ray_tpu_torch.serve.engine import Request

    reqs = [Request(request_id=f"live-{i}-{time.monotonic_ns()}", prompt=p,
                    max_tokens=max_tokens, stream_q=TokenStamps())
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    out, called, returned = None, None, None
    if update is not None:
        deadline = time.monotonic() + 60
        while min(len(r.output) for r in reqs) < 8:
            if time.monotonic() > deadline:
                fail("the live-weight streams did not reach 8 tokens in 60 s")
            time.sleep(0.001)
        span = engine._span_enqueued  # then wait for the next span: update lands while it runs
        while engine._span_enqueued == span:
            if time.monotonic() > deadline:
                fail("the live-weight streams' engine enqueued no span in 60 s")
            time.sleep(0.0002)
        called = time.monotonic()
        out = update()
        returned = time.monotonic()
    V = engine.cfg.vocab_size
    for r in reqs:
        if not r.done.wait(180) or r.error:
            fail(f"a live-weight stream failed: {r.error}")
        if len(r.output) != max_tokens or not all(0 <= t < V for t in r.output):
            fail(f"a live-weight stream returned {len(r.output)} tokens, in range "
                 f"{all(0 <= t < V for t in r.output)}")
    return reqs, out, called, returned


def stream_figures(reqs, t0: float = 0.0, t1: float = math.inf) -> str:
    """TPOT p50 and max and the longest gap between two of a request's
    tokens, over the tokens each request emitted between t0 and t1."""
    seen = [[t for t in r.stream_q.at if t0 <= t <= t1] for r in reqs]
    seen = [at for at in seen if len(at) >= 2]
    if not seen:
        return "no two tokens of one request in the window"
    tpot = [1e3 * (at[-1] - at[0]) / (len(at) - 1) for at in seen]
    gap = max(1e3 * (b - a) for at in seen for a, b in zip(at, at[1:]))
    return (f"TPOT p50 {statistics.median(tpot):.2f} max {max(tpot):.2f} ms, longest gap "
            f"between tokens {gap:.2f} ms")


def exact_gate(label: str, prompts, got, want) -> bool:
    """Per prompt, the updated engine's tokens and logprobs against a fresh
    engine's on the same weights: True where every request is identical,
    logprobs bit for bit (phase 3m's gate (a))."""
    same = []
    for p, g, w in zip(prompts, got, want):
        tokens = sum(a == b for a, b in zip(g["token_ids"], w["token_ids"]))
        lp = max(abs(a - b) for a, b in zip(g["logprobs"], w["logprobs"]))
        same.append(g["token_ids"] == w["token_ids"] and g["logprobs"] == w["logprobs"])
        log(f"{label}, {len(p)}-token prompt: {tokens} of {len(w['token_ids'])} tokens equal "
            f"a fresh engine's, logprob |updated - fresh| max {lp:.3e}")
    return all(same)


def restore(server, tree, version: int, sums0: dict, label: str) -> None:
    """update_weights back to `tree` (seed 0); the per-leaf checksums must
    equal the ones taken before any update, and the f32 head copy the new
    head's, bit for bit."""
    from ray_tpu_torch.models.transformer import lm_head_weight

    engine = server.engine
    server.update_weights({"weights": tree, "version": version})
    if leaf_checksums(engine.params) != sums0:
        fail(f"{label}: the restored weights' checksums differ from the originals'")
    if not torch.equal(engine._model.head32, lm_head_weight(engine.params, engine.cfg).float()):
        fail(f"{label}: the restored f32 head copy differs from the head")


def readback_probe(card: str, spin_ms: float = 150.0) -> None:
    """What a thread's readback does to another thread's enqueue on the
    same stream: behind a kernel that spins for spin_ms, one thread reads a
    small tensor back, into pageable memory (`.to("cpu")`) or into pinned
    memory with an event wait (programs.read_back), or waits on the stream
    itself; meanwhile this thread times its enqueue of 16 device-to-device
    copies, as a live weight swap enqueues its copies while the decode
    thread reads a span back. Printed."""
    from ray_tpu_torch.serve.programs import read_back

    src = [torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16) for _ in range(16)]
    dst = [torch.empty_like(t) for t in src]
    out = torch.randn(8, 16, device="cuda")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    b.synchronize()
    cycles_ms = 100_000_000 / a.elapsed_time(b)
    readers = {"none": None, "pageable .to('cpu')": lambda: out.to("cpu", copy=True),
               "pinned, event wait (read_back)": lambda: read_back(out),
               "stream synchronize": lambda: torch.cuda.current_stream().synchronize()}
    rows = []
    for name, reader in readers.items():
        torch.cuda.synchronize()
        torch.cuda._sleep(int(cycles_ms * spin_ms))
        thread = threading.Thread(target=reader) if reader is not None else None
        if thread is not None:
            thread.start()
            time.sleep(0.02)
        t0 = time.perf_counter()
        for d, x in zip(dst, src):
            d.copy_(x)
        rows.append(f"{name} {1e3 * (time.perf_counter() - t0):.2f} ms")
        if thread is not None:
            thread.join()
        torch.cuda.synchronize()
    log(f"phase 3w readback probe ({card}): host time of 16 device-to-device copy calls "
        f"enqueued 20 ms into a {spin_ms:.0f} ms kernel while another thread waits for it: "
        f"{'; '.join(rows)}")


def live_path(server, card: str) -> dict:
    """Phase 3w: live weight updates on phase 3's llama3-8b server. (1)
    the seed-1 tree on the card; (2) four greedy streams of 96 tokens, the
    update landing mid-stream: every stream token-valid, the version
    stamps, stats and gauge; (3) three fresh prompts alone (bucketed, 200
    and 700 tokens) on the updated server and on a fresh engine over the
    seed-1 tree: tokens equal and logprobs bit-identical, phase 3's logprob
    gate under the seed-1 forward, every launch from a graph replay; (4)
    each planted update fault (LIVE_FAULTS) must fail (3)'s exactness
    gate; (5) the seed-0 weights restored, bit-exact by checksum. Returns
    the launch counts of (2) and (3)."""
    from ray_tpu_torch.core import metrics
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve import engine as engine_mod
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine, Request

    engine = server.engine
    cfg, params = engine.cfg, engine.params
    rng = torch.Generator().manual_seed(4)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    # (1) before the update
    readback_probe(card)
    sums0 = leaf_checksums(params)
    t0 = time.monotonic()
    tree1 = init_params(cfg, seed=1, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    built = time.monotonic() - t0
    leaves = named_leaves(tree1)
    n_params = sum(t.numel() for _, t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    per_layer = sum(t.numel() for name, t in leaves if name.startswith("layers/")) / cfg.n_layers
    head = tree1["embed"] if cfg.tie_embeddings else tree1["lm_head"]
    log(f"phase 3w: live weights, llama3-8b ({card}): the seed-1 tree built on the card in "
        f"{built:.1f}s, {n_params / 1e9:.4f} B parameters, {n_bytes / 1e9:.2f} GB "
        f"(embed {tree1['embed'].numel() / 1e6:.1f} M, head {head.numel() / 1e6:.1f} M, "
        f"{per_layer / 1e6:.1f} M a layer x {cfg.n_layers})")
    fresh = InferenceEngine(tree1, cfg, EngineConfig(**ENGINE))
    fresh.warmup()
    # the fresh engine answers (3)'s prompts first, so that the launch
    # counts below hold the updated server's programs alone
    prompts = [prompt(23), prompt(200), prompt(700)]
    want = [fresh.generate(p, max_tokens=32) for p in prompts]

    # (2) in flight: four streams alone; four with a 200-token prefill
    # submitted while a span runs; four with the update at that point and
    # the same prefill submitted inside the swap, under the lock
    probes = []

    def probe():
        probes.append(Request(request_id=f"probe-{time.monotonic_ns()}", prompt=prompt(200),
                              max_tokens=1))
        engine.add_request(probes[-1])

    def ttft(r) -> float:
        if not r.done.wait(60) or r.error:
            fail(f"phase 3w: a 200-token prefill failed: {r.error}")
        return 1e3 * (r.first_token_at - r.submitted_at)

    def in_flight_update(version: int, label: str) -> dict:
        """Four streams, the update to tree1 landing while a span runs, a
        200-token prefill submitted inside the swap; figures printed."""
        with SwapClock(engine, on_swap=probe) as clock:
            reqs, out, called, returned = live_streams(
                engine, [prompt(100) for _ in range(4)], 96,
                update=lambda: server.update_weights({"weights": tree1, "version": version}))
        stats, swapped_in = dict(engine.update_stats), probes[-1]
        log(f"{label} update_weights -> {out}: the swap on the card {_ms(clock.ms())} ms "
            f"(copies into the live tensors + the f32 head refresh, CUDA events); host: staging "
            f"{1e3 * stats['stage_s']:.2f} ms ({stats['staged_bytes']} bytes staged), wait for "
            f"the replay lock {1e3 * stats['wait_s']:.2f} ms, swap {1e3 * stats['swap_s']:.2f} "
            f"ms; call {1e3 * (returned - called):.2f} ms")
        clock.report(label)
        log(f"  4 streams of 96 tokens with the update {stream_figures(reqs)}; TTFT of the "
            f"200-token prefill submitted inside the swap {ttft(swapped_in):.2f} ms (its stamp "
            f"{swapped_in.weights_version})")
        if swapped_in.weights_version != version:
            fail(f"{label}: the prefill submitted inside the swap ran on version "
                 f"{swapped_in.weights_version}")
        return {"reqs": reqs, "out": out}

    probe()
    idle = ttft(probes[-1])
    alone = live_streams(engine, [prompt(100) for _ in range(4)], 96)[0]
    decoding = live_streams(engine, [prompt(100) for _ in range(4)], 96, update=probe)[0]
    beside = ttft(probes[-1])
    log(f"phase 3w (2) 4 streams of 96 tokens: alone {stream_figures(alone)}; with a 200-token "
        f"prefill {stream_figures(decoding)}; TTFT of a 200-token prefill on the idle server "
        f"{idle:.2f} ms, submitted beside the decoding streams while a span runs {beside:.2f} ms")
    dispatch.reset_launches()
    reqs = in_flight_update(1, "phase 3w (2)")["reqs"]
    gauge = metrics.registry.get("serve_weights_version").get(tags={"role": server.role})
    stamps = sorted({r.weights_version for r in reqs})
    log(f"  version stamps {stamps}, stats {server.stats()['weights_version']}, "
        f"serve_weights_version{{role={server.role}}} {gauge}")
    if not set(stamps) <= {0, 1} or server.stats()["weights_version"] != 1 or gauge != 1:
        fail(f"phase 3w (2): stamps {stamps}, stats {server.stats()['weights_version']}, "
             f"gauge {gauge}")

    # (3) after: the fresh prompts alone on the updated server
    got = [server({"prompt_ids": p, "max_tokens": 32}) for p in prompts]
    launches = dispatch.launch_counts()
    log(f"launches around phase 3w (2) and (3): {launches}")
    require_no_eager_launches("phase 3w (2) and (3)")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"phase 3w never launched kernel {name}")
    if not exact_gate("phase 3w (3)", prompts, got, want):
        fail("phase 3w (3): the updated server differs from a fresh engine on the new weights")
    gaps = logprob_gaps(tree1, cfg, [{"prompt_ids": p} for p in prompts], got)
    log(f"phase 3w (3) logprob |engine - forward under the seed-1 weights| per request max "
        f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]} "
        f"(tol {LOGPROB_TOL})")
    if not all(within_logprob_tol(g) for g in gaps):
        fail("phase 3w (3): the updated server fails phase 3's logprob gate")

    # (4) the planted update faults, each from the seed-0 weights
    tree0 = init_params(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    version = 2
    for name, fault in LIVE_FAULTS.items():
        restore(server, tree0, version, sums0, f"phase 3w before fault {name}")
        with fault(engine):
            server.update_weights({"weights": tree1, "version": version + 1})
        version += 2
        ps = [prompt(23), prompt(200), prompt(700)]
        got = [server({"prompt_ids": p, "max_tokens": 32}) for p in ps]
        want = [fresh.generate(p, max_tokens=32) for p in ps]
        if exact_gate(f"phase 3w planted fault {name}", ps, got, want):
            fail(f"phase 3w: the exactness gate passes planted update fault {name}")

    # (4b) a prefill enqueued in the middle of a swap must run wholly on
    # one generation: its first logprob equals the seed-0 or the seed-1
    # model's, bit for bit; a swap outside the replay lock must fail that
    p = prompt(15)  # under a page: never cached, one bucketed prefill
    first = {"seed 0": server({"prompt_ids": p, "max_tokens": 1}),
             "seed 1": fresh.generate(p, max_tokens=1)}
    for label, lock in (("sound swap", None), ("planted fault swap_outside_the_lock",
                                               contextlib.nullcontext())):
        restore(server, tree0, version, sums0, f"phase 3w before the {label}")
        with contextlib.ExitStack() as stack:
            if lock is not None:
                stack.enter_context(swapped(engine, _replay_lock=lock))
            req = stack.enter_context(mid_swap_request(engine, p))
            server.update_weights({"weights": tree1, "version": version + 1})
        version += 2
        if not req.done.wait(60) or req.error:
            fail(f"phase 3w (4b) {label}: the mid-swap request failed: {req.error}")
        ran_on = [name for name, r in first.items()
                  if (req.output[0], req.output_logprobs[0]) == (r["token_ids"][0],
                                                                 r["logprobs"][0])]
        log(f"phase 3w (4b) {label}: a prefill enqueued mid-swap gave first token "
            f"{req.output[0]} logprob {req.output_logprobs[0]:.6f}, stamp "
            f"{req.weights_version}; the seed-0 model's {first['seed 0']['token_ids'][0]} "
            f"{first['seed 0']['logprobs'][0]:.6f}, the seed-1 model's "
            f"{first['seed 1']['token_ids'][0]} {first['seed 1']['logprobs'][0]:.6f}: ran on "
            f"{ran_on or 'neither'}")
        if (lock is None) != (ran_on == ["seed 1"]):
            fail(f"phase 3w (4b): the mid-swap gate misjudges the {label} ({ran_on})")

    # (4c) the same in-flight update with the engine's readbacks put back
    # to pageable copies, as they were before programs.read_back: printed
    restore(server, tree0, version, sums0, "phase 3w before (4c)")
    with swapped(engine_mod, read_back=lambda *ts: tuple(t.to("cpu", copy=True) for t in ts)):
        in_flight_update(version + 1, "phase 3w (4c) pageable readbacks")
    version += 2

    # (5) the seed-0 weights back, bit for bit
    restore(server, tree0, version, sums0, "phase 3w (5)")
    log(f"phase 3w (5): seed-0 weights restored (version {version}): per-leaf checksums equal "
        f"the originals' and the f32 head copy the head's, bit for bit")
    fresh.stop()
    del fresh, tree0, tree1
    release()
    return launches


# ------------------------------------------------------------- phase 3r

# the runtime's process flags for the phases before 4i: thread mode, so their
# gates and figures stay comparable with the runs made before the port took
# the reference's defaults (worker and actor processes on; phase 4i)
RUNTIME_FLAGS = {"worker_processes": 0, "actor_processes": False}
# a put/get of a device tree must not copy it through the host: the process
# RSS may grow by less than this across phase 3r (b)'s put and get
RSS_GROWTH_MAX = 256 * 2**20


class ServerHost:
    """Phase 3r's GPU actor: an LLMServer over weights that arrive as a ref."""

    def __init__(self, params, cfg, engine_config):
        from ray_tpu_torch.serve import LLMServer

        t0 = time.monotonic()
        self.server = LLMServer._target(params_fn=lambda: (params, cfg),
                                        engine_config=engine_config)
        torch.cuda.synchronize()
        self.built_s = time.monotonic() - t0
        self.params = params

    def built(self) -> dict:
        st = self.server.engine.capture_stats
        return {"seconds": self.built_s, "capture_s": st["seconds"],
                "programs": st["programs"], "pool_gib": st.get("pool_bytes", 0) / 2**30,
                "params": self.server.engine.params}

    def generate(self, request):
        return self.server(request)

    def update_weights(self, request) -> dict:
        t0 = time.monotonic()
        out = self.server.update_weights(request)
        return dict(out, seconds=time.monotonic() - t0, **self.server.engine.update_stats)

    def weights_version(self) -> int:
        return self.server.weights_version()

    def hold(self, seconds: float) -> float:
        time.sleep(seconds)
        return seconds

    def shutdown(self) -> None:
        self.server.shutdown()


class Probe:
    """A GPU actor that holds nothing but its resources."""

    def ping(self) -> str:
        return "pong"


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def same_tensors(a, b) -> bool:
    """Every leaf of tree b is the very tensor of tree a (same storage)."""
    la, lb = named_leaves(a), named_leaves(b)
    return len(la) == len(lb) and all(
        na == nb and x.data_ptr() == y.data_ptr() and x.shape == y.shape
        for (na, x), (nb, y) in zip(la, lb))


def percentiles_ms(xs) -> str:
    xs = sorted(xs)
    p99 = xs[min(len(xs) - 1, int(math.ceil(0.99 * len(xs))) - 1)]
    return f"p50 {1e3 * statistics.median(xs):.4f} ms, p99 {1e3 * p99:.4f} ms"


def second_gpu_actor(rt, probe_cls) -> tuple:
    """Gate (a)'s first half, while a num_gpus=1 actor lives: a second
    num_gpus=1 actor must stay pending. -> (second, its ping ref, whether it
    was still pending after 1 s)."""
    second = probe_cls.remote()
    ping = second.ping.remote()
    ready, _ = rt.wait([ping], num_returns=1, timeout=1.0)
    return second, ping, not ready


def runtime_path(server, card: str, requests, plain_results, plain_figures: str) -> dict:
    """Phase 3r: the task/actor runtime on the card, over phase 3's tensors.
    (a) resources: cluster_resources counts the card as "GPU"; a second
    num_gpus=1 actor stays pending while the first lives and places after
    kill (planted: accounting that does not hold an actor's GPU); a
    placement group's {"GPU": 1} bundle takes an actor. (b) put/get of
    phase 3's parameter tree returns the same tensors, no host copy
    (planted: a seal_value that pickles device trees). (c) a num_gpus=1
    task runs K1 on a CUDA activation that arrives as a ref, against the
    plain version; round trips beside direct calls. (d) a GPU actor builds
    an LLMServer over the tree's ref and serves phase 3's burst through its
    handle under phase 3's logprob gate. (e) update_weights through the ref
    of a tree whose final norm has other signs moves the outputs onto the forward
    over that tree, and a second update restores them. (f) kill fails a
    pending call; shutdown leaves no thread behind. Returns the launch
    counts of (c)-(e), the yardstick forwards left out."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import ops
    from ray_tpu_torch.core import node_agent, object_store
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.sched import placement_group, remove_placement_group

    engine = server.engine
    cfg, params = engine.cfg, engine.params
    t_phase = time.monotonic()
    threads_before = set(threading.enumerate())
    rt.shutdown()
    rt.init(num_cpus=8, system_config=RUNTIME_FLAGS)
    resources = rt.cluster_resources()
    log(f"phase 3r: the runtime on the card ({card}), thread mode {RUNTIME_FLAGS}: "
        f"cluster_resources {resources}")
    if resources.get("GPU") != torch.cuda.device_count():
        fail(f"phase 3r (a): cluster_resources GPU {resources.get('GPU')}, the process sees "
             f"{torch.cuda.device_count()} CUDA devices")
    probe_cls = rt.remote(num_gpus=1)(Probe)

    # (a), planted first: the agent forgets that a created actor holds its GPU
    with swapped(node_agent.NodeAgent, has_actor=lambda self, actor_id: False):
        first = probe_cls.remote()
        rt.get(first.ping.remote(), timeout=60)
        second, _ping, held = second_gpu_actor(rt, probe_cls)
        rt.kill(first)
        rt.kill(second)
    log(f"phase 3r (a) planted fault gpu_not_held: a second num_gpus=1 actor "
        f"{'stayed pending' if held else 'placed at once'}")
    if held:
        fail("phase 3r (a): the resource gate passes planted fault gpu_not_held")

    # (b) the object plane: the parameter tree by reference
    leaves = named_leaves(params)
    nbytes = sum(t.nbytes for _, t in leaves)
    rss0 = rss_bytes()
    t0 = time.perf_counter()
    pref = rt.put(params)
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rt.get(pref, timeout=60)
    t_get = time.perf_counter() - t0
    rss1 = rss_bytes()
    same = same_tensors(params, got)
    log(f"phase 3r (b): put of phase 3's parameter tree ({len(leaves)} tensors, "
        f"{nbytes / 1e9:.2f} GB {cfg.dtype}) {1e6 * t_put:.1f} us, get {1e6 * t_get:.1f} us; "
        f"the same tensors back {same}; process RSS {rss0 / 2**30:.3f} -> "
        f"{rss1 / 2**30:.3f} GiB")
    if not same:
        fail("phase 3r (b): get(put(tree)) did not return the tree's own tensors")
    if rss1 - rss0 > RSS_GROWTH_MAX:
        fail(f"phase 3r (b): RSS grew {(rss1 - rss0) / 2**20:.1f} MiB across put/get")
    dev = params["embed"].device
    small = {"final_norm": params["final_norm"],
             "slab": torch.zeros(32 * 2**20, device=dev, dtype=params["embed"].dtype)}
    with swapped(object_store, _has_device_leaves=lambda value: False):
        t0 = time.perf_counter()
        copied = rt.get(rt.put(small), timeout=60)
        t_fault = time.perf_counter() - t0
    caught = not same_tensors(small, copied)
    log(f"phase 3r (b) planted fault seal_pickles_device_trees: a 64 MiB tree through "
        f"put/get in {1e3 * t_fault:.1f} ms, the same tensors back {not caught}")
    if not caught:
        fail("phase 3r (b): the object-plane gate passes planted fault "
             "seal_pickles_device_trees")
    del small, copied

    # (c) a GPU task on a CUDA activation that arrives as a ref
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, cfg.d_model, device=dev, generator=gen).to(params["final_norm"].dtype)
    w = params["final_norm"]
    eps = cfg.norm_eps

    def norm_sync(a, b):
        out = ops.rms_norm(a, b, eps)
        torch.cuda.synchronize()
        return out

    norm_task = rt.remote(num_gpus=1)(norm_sync)
    xref, wref = rt.put(x), rt.put(w)
    direct = []
    for _ in range(200):  # the yardstick, before the path's counts start
        t0 = time.perf_counter()
        norm_sync(x, w)
        direct.append(time.perf_counter() - t0)
    dispatch.reset_launches()
    first_out = rt.get(norm_task.remote(xref, wref), timeout=60)
    k1 = dispatch.launch_counts()["rms_norm"]
    err = check_close("phase 3r (c) task rms_norm", "rms_norm", x.dtype, first_out,
                      ops.rms_norm_reference(x, w, eps))
    rounds = []
    for _ in range(200):
        t0 = time.perf_counter()
        rt.get(norm_task.remote(xref, wref), timeout=60)
        rounds.append(time.perf_counter() - t0)
    k1_tasks = dispatch.launch_counts()["rms_norm"]
    log(f"phase 3r (c): a num_gpus=1 task ran K1 on a [8, {cfg.d_model}] {x.dtype} ref: "
        f"max |err| {err:.3e} (tol {TOL[('rms_norm', x.dtype)]}), K1 launches 0 -> {k1} -> "
        f"{k1_tasks} after 200 more; round trip (submit, run, get) {percentiles_ms(rounds)}; "
        f"direct call {percentiles_ms(direct)}")
    if k1 != 1 or k1_tasks != 201:
        fail(f"phase 3r (c): the tasks' K1 launch count read {k1}, then {k1_tasks} "
             f"(one a task)")

    # (d) the hosted server: a GPU actor over the tree's ref, phase 3's burst
    host_cls = rt.remote(num_gpus=1, max_concurrency=8)(ServerHost)
    t0 = time.monotonic()
    host = host_cls.remote(pref, cfg, ENGINE)
    built = rt.get(host.built.remote(), timeout=900)
    log(f"phase 3r (d): the GPU actor built an LLMServer in {built['seconds']:.1f}s (capture "
        f"{built['capture_s']:.1f}s for {built['programs']} programs, graph pools "
        f"{built['pool_gib']:.3f} GiB; {time.monotonic() - t0:.1f}s through the handle); its "
        f"engine runs over phase 3's tensors: {same_tensors(params, built['params'])}")
    if not same_tensors(params, built["params"]):
        fail("phase 3r (d): the hosted engine does not run over phase 3's tensors")
    del built
    refs = [host.generate.remote(r) for r in requests]
    t0 = time.monotonic()
    hosted = rt.get(refs, timeout=600)
    wall = time.monotonic() - t0
    # read before the yardstick forward below, which launches K1 and K2 itself
    launches = dispatch.launch_counts()
    figures = report_burst("phase 3r (d) hosted", requests, hosted, wall)
    log(f"phase 3r (d): through the actor: {figures}; phase 3 direct, the same prompts on "
        f"the same card: {plain_figures}")
    agree = [sum(a == b for a, b in zip(h["token_ids"], p["token_ids"])) / len(p["token_ids"])
             for req, h, p in zip(requests, hosted, plain_results)
             if req.get("temperature", 0.0) == 0.0]
    log(f"phase 3r (d): greedy token agreement with phase 3's outputs, per request "
        f"{[round(a, 3) for a in agree]} (not a gate: random weights give near-tied logits)")
    gaps = logprob_gaps(params, cfg, requests, hosted)
    log(f"phase 3r (d): logprob |engine - forward| per request max "
        f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]} "
        f"(tol {LOGPROB_TOL})")
    for i, gap in enumerate(gaps):
        if not within_logprob_tol(gap):
            fail(f"phase 3r (d) request {i}: logprobs differ from the forward by max "
                 f"{gap[0]:.4f}, mean {gap[1]:.4f} (tol {LOGPROB_TOL})")

    # (e) a live update through a ref: a tree whose final norm has the sign
    # of half its channels flipped (other logits of the same scale, so
    # phase 3's gate holds against its forward), then back
    short = {"prompt_ids": requests[0]["prompt_ids"][:12], "max_tokens": 32}
    restore = dict(params, final_norm=params["final_norm"].clone())
    flip = torch.rand(cfg.d_model, device=dev, generator=gen) < 0.5
    changed = dict(params, final_norm=torch.where(flip, -1, 1).to(w.dtype) * w)
    dispatch.reset_launches()
    before = rt.get(host.generate.remote(short), timeout=300)
    upd = rt.get(host.update_weights.remote({"ref": rt.put(changed), "version": 2}),
                 timeout=300)
    after = rt.get(host.generate.remote(short), timeout=300)
    version = rt.get(host.weights_version.remote(), timeout=60)
    written = torch.equal(params["final_norm"], changed["final_norm"])
    back = rt.get(host.update_weights.remote({"ref": rt.put(restore), "version": 3}),
                  timeout=300)
    restored = rt.get(host.generate.remote(short), timeout=300)
    launches = {name: n + dispatch.launch_counts()[name] for name, n in launches.items()}
    (gap_new,) = logprob_gaps(changed, cfg, [short], [after])
    (gap_old,) = logprob_gaps(restore, cfg, [short], [after])
    log(f"phase 3r (e): update_weights through the ref of a tree with half the final norm's "
        f"signs flipped: version "
        f"{upd['weights_version']} (reported {version}) in {1e3 * upd['seconds']:.2f} ms through "
        f"the handle (stage {1e3 * upd.get('stage_s', 0.0):.2f}, lock wait "
        f"{1e3 * upd.get('wait_s', 0.0):.2f}, swap {1e3 * upd.get('swap_s', 0.0):.2f} ms); "
        f"phase 3's final_norm now holds the ref's values {written}; a 12-token prompt's "
        f"logprobs against the forward over the new tree max {gap_new[0]:.4f} mean "
        f"{gap_new[1]:.4f}, over the old tree max {gap_old[0]:.4f} mean {gap_old[1]:.4f} "
        f"(tol {LOGPROB_TOL}); restored (version {back['weights_version']}, "
        f"{1e3 * back['seconds']:.2f} ms): tokens equal {restored['token_ids'] == before['token_ids']}, "
        f"max |logprob diff| "
        f"{max(abs(a - b) for a, b in zip(before['logprobs'], restored['logprobs'])):.3e}")
    if upd["weights_version"] != 2 or version != 2 or back["weights_version"] != 3:
        fail(f"phase 3r (e): the updates reported versions {upd['weights_version']}/{version}, "
             f"then {back['weights_version']}")
    if not written:
        fail("phase 3r (e): the update through the ref did not write its values")
    if not within_logprob_tol(gap_new) or within_logprob_tol(gap_old):
        fail("phase 3r (e): after the update the outputs do not follow the forward over the "
             "ref's tree alone")
    if not torch.equal(params["final_norm"], restore["final_norm"]) \
            or restored["token_ids"] != before["token_ids"]:
        fail("phase 3r (e): the second update did not restore phase 3's weights and tokens")
    del restore, changed
    log(f"launches on the runtime path ((c)-(e), the hosted server's warm-up included, the "
        f"yardstick forwards of (d) and (e) not): {launches}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"phase 3r never launched kernel {name}")

    # (a) sound: a second GPU actor waits while the hosted server lives
    second, second_ping, held = second_gpu_actor(rt, probe_cls)
    log(f"phase 3r (a): a second num_gpus=1 actor while the hosted server lives: "
        f"{'pending' if held else 'placed'}")
    if not held:
        fail("phase 3r (a): a second num_gpus=1 actor placed while the first held the card")

    # (f) teardown: stop the engine, park a call behind eight, kill
    rt.get(host.shutdown.remote(), timeout=120)
    holds = [host.hold.remote(2.0) for _ in range(8)]
    parked = host.weights_version.remote()
    time.sleep(0.3)
    rt.kill(host)
    try:
        rt.get(parked, timeout=60)
        fail("phase 3r (f): a call parked on a killed actor returned")
    except rt.RayActorError as e:
        log(f"phase 3r (f): kill failed the parked call with RayActorError ({e})")
    placed = rt.get(second_ping, timeout=60) == "pong"
    log(f"phase 3r (a): the second GPU actor placed after kill: {placed}")
    if not placed:
        fail("phase 3r (a): the second GPU actor did not place after kill")
    rt.kill(second)
    rt.get(holds, timeout=60)
    pg = placement_group([{"GPU": 1.0}])
    if not pg.ready(timeout=30):
        fail("phase 3r (a): a placement group of one {'GPU': 1} bundle did not place")
    in_pg = rt.remote(num_cpus=0, num_gpus=1, scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
        placement_group_id=pg.id, bundle_index=0))(Probe).remote()
    in_bundle = rt.get(in_pg.ping.remote(), timeout=60) == "pong"
    log(f"phase 3r (a): an actor placed into a {{'GPU': 1}} placement-group bundle: {in_bundle}")
    rt.kill(in_pg)
    remove_placement_group(pg)
    del pref, xref, wref, got
    rt.shutdown()
    deadline = time.monotonic() + 15
    while True:
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    log(f"phase 3r (f): threads started in phase 3r still alive after shutdown: {left or 'none'}")
    if left:
        fail(f"phase 3r (f): threads outlived shutdown(): {left}")
    release()
    log(f"phase 3r took {time.monotonic() - t_phase:.1f}s")
    return launches


# ------------------------------------------------------------- phase 3d


class IdTokenizer:
    """Phase 3d's tokenizer for the OpenAI front: each token id decodes to a
    character of its own, U+10000 + id, which encodes back to that id;
    other text encodes to its utf-8 bytes, as ByteTokenizer's does. So a
    returned text gives back its token ids exactly at llama3-8b's
    vocabulary, where ByteTokenizer drops every id past 255. Like
    ByteTokenizer it names no stop token."""

    eos_token_id = None

    def encode(self, text: str) -> list:
        ids = []
        for ch in text:
            code = ord(ch)
            ids.extend([code - 0x10000] if code >= 0x10000 else ch.encode("utf-8"))
        return ids

    def decode(self, ids) -> str:
        return "".join(chr(0x10000 + int(i)) for i in ids)


def _swaps_pairs(f):
    """DeploymentHandle.remote: each pair of calls trades responses."""
    held = []

    def remote(self, *args, **kwargs):
        response = f(self, *args, **kwargs)
        held.append(response)
        if len(held) == 2:
            a, b = held
            a._ref, b._ref = b._ref, a._ref
            held.clear()
        return response

    return remote


def _drops_last_chunk(f):
    """SSEStream.__next__, what the HTTP proxy sends: one chunk ahead, so
    the last chunk never goes out."""
    def next_chunk(self):
        if not hasattr(self, "_ahead"):
            self._ahead = f(self)
        chunk, self._ahead = self._ahead, f(self)
        return chunk

    return next_chunk


# Planted serve-runtime faults, each of which its gate must catch: name ->
# (module of ray_tpu_torch.serve, class, attribute, wrapper maker)
DEPLOY_FAULTS = {
    # the handle hands two requests each other's responses: the gate that
    # each response answers its own request (its request_id, and its
    # logprobs under the forward over its own prompt)
    "handle_swaps_responses": ("handle", "DeploymentHandle", "remote", _swaps_pairs),
    # the HTTP proxy's event stream loses its last chunk: the SSE gate
    "sse_last_chunk_dropped": ("openai_api", "SSEStream", "__next__", _drops_last_chunk),
}
# a deployment's replicas are built over the caller's card tensors: the
# process RSS may grow by less than this share of the tree's bytes, and the
# card's memory by less than it per replica (a copy would take the whole)
DEPLOY_COPY_SHARE_MAX = 0.25


def deploy_fault(name: str):
    module, cls, attr, make = DEPLOY_FAULTS[name]
    owner = getattr(__import__(f"ray_tpu_torch.serve.{module}", fromlist=[cls]), cls)
    return swapped(owner, **{attr: make(getattr(owner, attr))})


def wait_ready(deployment: str, n: int, t0: float, label: str = "phase 3d") -> list:
    """-> the deployment's n replica handles once each has finished its
    __init__ (its health_check answers), with the seconds after t0 at
    which each did."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import get_or_create_controller

    replicas, _ = rt.get(get_or_create_controller().get_replicas.remote(deployment),
                         timeout=60)
    if len(replicas) != n:
        fail(f"{label}: deployment {deployment} has {len(replicas)} replicas, not {n}")
    refs = [r.health_check.remote() for r in replicas]
    ready_s = [None] * n
    pending = list(range(n))
    while pending:
        done, _ = rt.wait([refs[i] for i in pending], num_returns=1, timeout=900)
        if not done:
            fail(f"{label}: a replica of {deployment} was not ready within 900 s")
        for i in [i for i in pending if refs[i] in done]:
            rt.get(refs[i], timeout=60)
            ready_s[i] = time.monotonic() - t0
            pending.remove(i)
    return list(zip(replicas, ready_s))


def tagged(requests, label: str) -> list:
    """The requests, each with a request_id of its own."""
    return [dict(r, request_id=f"3d-{label}-{i}") for i, r in enumerate(requests)]


def answered(requests, results) -> bool:
    """Every response carries its own request's request_id."""
    return all(res["request_id"] == req["request_id"] for req, res in zip(requests, results))


def handle_burst(handle, requests, label: str = "phase 3d") -> tuple:
    """All requests through the handle at once, each response awaited on a
    thread of its own -> (results, seconds from each call to its result,
    wall s)."""
    results, latency, errors = [None] * len(requests), [None] * len(requests), []

    def wait(i, response, t):
        try:
            results[i] = response.result(timeout=600)
            latency[i] = time.monotonic() - t
        except Exception as e:  # noqa: BLE001 — reported as this phase's failure
            errors.append(f"request {i}: {e!r}")

    t0 = time.monotonic()
    threads = []
    for i, req in enumerate(requests):
        t = time.monotonic()
        threads.append(threading.Thread(target=wait, args=(i, handle.remote(req), t)))
        threads[-1].start()
    for t in threads:
        t.join(660)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label} handle burst: {errors or 'a request did not finish'}")
    return results, latency, time.monotonic() - t0


def http_post(port: int, path: str, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=600)


def sse_request(port: int, path: str, body: dict) -> dict:
    """One streamed request: its chunks before [DONE], each one's arrival on
    the host clock, whether [DONE] came, when the request was sent and when
    the response's headers came back."""
    t0 = time.monotonic()
    chunks, stamps, done = [], [], False
    with http_post(port, path, dict(body, stream=True)) as r:
        t_head = time.monotonic()
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            chunks.append(json.loads(line[len("data: "):]))
            stamps.append(time.monotonic())
    return {"chunks": chunks, "stamps": stamps, "done": done, "t0": t0, "t_head": t_head}


def sse_result(stream: dict, tok: IdTokenizer) -> dict:
    """A streamed completion as an engine result: token ids of its content
    chunks' text, their logprobs and the terminal chunk's finish reason."""
    chunks = stream["chunks"]
    content = [c["choices"][0] for c in chunks if "finish_reason" not in c["choices"][0]]
    last = chunks[-1]["choices"][0] if chunks else {}
    return {"token_ids": tok.encode("".join(c["text"] for c in content)),
            "logprobs": [c["logprobs"]["token_logprobs"][0] for c in content],
            "finish_reason": last.get("finish_reason"), "content_chunks": len(content)}


def sse_whole(stream: dict, res: dict, max_tokens: int) -> bool:
    """The SSE gate's shape: max_tokens content chunks of one token each,
    then a terminal chunk with the finish reason, then [DONE]."""
    return (stream["done"] and res["content_chunks"] == max_tokens == len(res["token_ids"])
            and res["finish_reason"] == "length"
            and len(stream["chunks"]) == max_tokens + 1)


def sse_figures(label: str, streams: list, wall: float) -> str:
    """TTFT (request sent to first content chunk), time per output token
    after the first and tokens/s, on the client's clock; per request also
    when the headers came (the proxy, the handle and the replica's hop)."""
    ttfts, tpots, tokens = [], [], 0
    log(f"{label}: headers after {_ms([1e3 * (s['t_head'] - s['t0']) for s in streams])} ms, "
        f"first chunk after {_ms([1e3 * (s['stamps'][0] - s['t0']) for s in streams])} ms")
    for s in streams:
        n = len(s["stamps"]) - 1  # content chunks; the last is the terminal one
        ttfts.append(s["stamps"][0] - s["t0"])
        tpots.append((s["stamps"][n - 1] - s["stamps"][0]) / (n - 1))
        tokens += n
    ttfts, tpots = sorted(ttfts), sorted(tpots)
    figures = (f"TTFT p50 {statistics.median(ttfts):.4f} s max {ttfts[-1]:.4f} s, TPOT p50 "
               f"{1e3 * statistics.median(tpots):.2f} ms, {tokens / wall:.2f} tok/s over "
               f"{wall:.2f} s")
    log(f"{label} (client clock): {figures}")
    return figures


def sse_burst(port: int, requests) -> tuple:
    """Phase 3's burst as concurrent streamed completions with logprobs,
    the prompts as token-id lists -> (streams, wall s)."""
    streams, errors = [None] * len(requests), []

    def run(i):
        req = requests[i]
        body = {"prompt": req["prompt_ids"], "max_tokens": req["max_tokens"], "logprobs": 1,
                "temperature": req.get("temperature", 0.0), "top_p": req.get("top_p", 1.0)}
        try:
            streams[i] = sse_request(port, "/v1/completions", body)
        except Exception as e:  # noqa: BLE001 — reported as this phase's failure
            errors.append(f"request {i}: {e!r}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(660)
    if errors or any(t.is_alive() for t in threads):
        fail(f"phase 3d HTTP burst: {errors or 'a request did not finish'}")
    return streams, time.monotonic() - t0


def replica_line(label: str, replica, ready_s: float, stats: dict) -> None:
    st = stats["capture"]
    log(f"phase 3d: {label} replica {replica._actor_id.hex()[:8]} ready {ready_s:.1f}s after "
        f"serve.run; its capture {st['seconds']:.1f}s for {st['programs']} programs, graph "
        f"pools and static buffers {st.get('pool_bytes', 0) / 2**30:.3f} GiB")


def deploy_path(server, card: str, plain_figures: str) -> dict:
    """Phase 3d: the serve runtime on the card, over phase 3's tensors.
    serve.run(LLMServer.options(num_replicas=2).bind(...)) starts two
    replicas over the same parameter tensors (no host copy: RSS and card
    memory read around it); phase 3's burst of fresh prompts through the
    handle, then one greedy prompt whole and streamed through the handle;
    then build_openai_app on the same tensors over HTTP: the burst as
    concurrent SSE streams with logprobs, one completion whole and
    streamed, one chat completion and /v1/models. Gates: phase 3's logprob
    gate on every response, the streams token for token equal to the
    whole requests, the SSE streams whole, both replicas served, every
    launch from a graph replay; each planted DEPLOY_FAULTS entry must fail
    its gate; serve.shutdown() leaves no thread the phase started. Returns
    the launch counts of the handle and HTTP sections, the yardstick
    forwards left out, and the HTTP burst's figures."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve.openai_api import _chat_prompt

    cfg, params = server.engine.cfg, server.engine.params
    t_phase = time.monotonic()
    rng = torch.Generator().manual_seed(3)  # fresh prompts, seeded, host-side
    tok = IdTokenizer()
    nbytes = sum(t.nbytes for _, t in named_leaves(params))
    serve.shutdown()
    rt.shutdown()
    # what serve.run started on its own before the process flags took the
    # reference's defaults: thread mode, this host's CPUs and cards
    rt.init(system_config=RUNTIME_FLAGS)
    runtime_threads = set(threading.enumerate())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0, mem0 = rss_bytes(), torch.cuda.memory_allocated()

    def params_fn():
        return params, cfg

    t0 = time.monotonic()
    handle = serve.run(serve.LLMServer.options(num_replicas=2).bind(
        model_name="llama3-8b", params_fn=params_fn, engine_config=ENGINE), name="llm")
    replicas = wait_ready("llm", 2, t0)
    torch.cuda.synchronize()
    rss1, mem1 = rss_bytes(), torch.cuda.memory_allocated()
    for i, (replica, ready_s) in enumerate(replicas):
        replica_line(f"LLMServer llama3-8b {i}", replica, ready_s,
                     rt.get(replica.handle_request.remote("stats", ({},), {}), timeout=60))
    served0 = [rt.get(r.stats.remote(), timeout=60)["total"] for r, _ in replicas]
    log(f"phase 3d: two replicas over phase 3's parameter tree ({nbytes / 1e9:.2f} GB): process "
        f"RSS {rss0 / 2**30:.3f} -> {rss1 / 2**30:.3f} GiB, card memory "
        f"{mem0 / 2**30:.2f} -> {mem1 / 2**30:.2f} GiB")
    if rss1 - rss0 > DEPLOY_COPY_SHARE_MAX * nbytes:
        fail(f"phase 3d: RSS grew {(rss1 - rss0) / 2**30:.2f} GiB building the replicas")
    if mem1 - mem0 > 2 * DEPLOY_COPY_SHARE_MAX * nbytes:
        fail(f"phase 3d: card memory grew {(mem1 - mem0) / 2**30:.2f} GiB for two replicas")

    # the handle: phase 3's burst, then one greedy prompt whole and streamed
    dispatch.reset_launches()
    requests = tagged(burst_requests(cfg, rng), "handle")
    results, latency, wall = handle_burst(handle, requests)
    short = {"prompt_ids": torch.randint(1, cfg.vocab_size, (12,), generator=rng).tolist(),
             "max_tokens": 32}
    whole = handle.remote(short).result(timeout=300)
    t = time.monotonic()
    streamed, stamps = [], []
    for token in handle.options("stream").remote(short).result(timeout=300):
        streamed.append(int(token))
        stamps.append(time.monotonic())
    launches = dispatch.launch_counts()
    require_no_eager_launches("phase 3d handle")
    handle_figures = report_burst("phase 3d handle", requests, results, wall)
    hop = sorted(c - r["latency_s"] for c, r in zip(latency, results))
    log(f"phase 3d: through the handle: {handle_figures}; phase 3 direct, the same burst "
        f"shapes on the same card: {plain_figures}; the handle's hop (call to result, less "
        f"the engine's latency) p50 {1e3 * statistics.median(hop):.2f} ms max "
        f"{1e3 * hop[-1]:.2f} ms; a 12-token prompt streamed through the handle: first token "
        f"{stamps[0] - t:.4f} s, {len(streamed)} tokens in {stamps[-1] - t:.3f} s")
    served = [rt.get(r.stats.remote(), timeout=60)["total"] - n
              for (r, _), n in zip(replicas, served0)]
    with deploy_fault("handle_swaps_responses"):
        swapped_requests = tagged(burst_requests(cfg, rng), "swapped")
        swapped_results, _, _ = handle_burst(handle, swapped_requests)

    # the OpenAI front over HTTP, on the same tensors
    t1 = time.monotonic()
    serve.run(serve.build_openai_app(model_name="llama3-8b", params_fn=params_fn,
                                     engine_config=ENGINE, tokenizer=tok), name="v1")
    ((front, ready_s),) = wait_ready("openai", 1, t1)
    replica_line("OpenAIServer llama3-8b", front, ready_s,
                 rt.get(front.handle_request.remote("stats", ({},), {}), timeout=60))
    port = serve.http_port()
    # the proxy's health route, which also builds this process's HTTP client:
    # its first use, raced by five threads, cost the first burst ~250 ms
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/healthz", timeout=60) as r:
        health = json.loads(r.read())
    dispatch.reset_launches()
    http_requests = burst_requests(cfg, rng)
    streams, http_wall = sse_burst(port, http_requests)
    http_results = [sse_result(s, tok) for s in streams]
    prompt = torch.randint(1, cfg.vocab_size, (12,), generator=rng).tolist()
    body = {"prompt": prompt, "max_tokens": 32, "logprobs": 1}
    with http_post(port, "/v1/completions", body) as r:
        completion = json.loads(r.read())["result"]
    one = sse_request(port, "/v1/completions", body)
    messages = [{"role": "user", "content": "Name three prime numbers."}]
    with http_post(port, "/v1/chat/completions",
                   {"messages": messages, "max_tokens": 32, "logprobs": True}) as r:
        chat = json.loads(r.read())["result"]
    with http_post(port, "/v1/models", {}) as r:
        models = json.loads(r.read())["result"]
    launches = {name: n + dispatch.launch_counts()[name] for name, n in launches.items()}
    require_no_eager_launches("phase 3d HTTP")
    for i, res in enumerate(http_results):
        log(f"phase 3d HTTP request {i}: prompt {len(http_requests[i]['prompt_ids'])} tokens, "
            f"first tokens {res['token_ids'][:6]}")
    http_figures = sse_figures("phase 3d HTTP (SSE, logprobs)", streams, http_wall)
    with deploy_fault("sse_last_chunk_dropped"):
        dropped = sse_request(port, "/v1/completions", body)
    peak = torch.cuda.max_memory_allocated()

    # teardown: no thread of the serve runtime outlives serve.shutdown()
    t_down = time.monotonic()
    serve.shutdown()
    deadline = time.monotonic() + 15
    while True:
        left = [t.name for t in threading.enumerate()
                if t not in runtime_threads and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    log(f"phase 3d: serve.shutdown() took {time.monotonic() - t_down:.2f}s; threads the phase "
        f"started still alive after it: {left or 'none'}")
    if left:
        fail(f"phase 3d: threads outlived serve.shutdown(): {left}")
    rt.shutdown()
    release()
    log(f"phase 3d: peak card memory {peak / 2**30:.2f} GiB (phase 3's server and tensors "
        f"included); after shutdown {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log(f"launches on the deploy path (handle and HTTP sections, the replicas' warm-up and "
        f"the yardstick forwards not): {launches}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"phase 3d never launched kernel {name}")

    # the gates
    log(f"phase 3d: requests served per replica {served}")
    if not answered(requests, results):
        fail("phase 3d: a response through the handle answers another request")
    if min(served) < 1:
        fail(f"phase 3d: a replica served no request: {served}")
    gated = {
        "handle burst": (requests, results),
        "handle greedy prompt": ([short], [whole]),
        "HTTP burst": (http_requests, http_results),
        "HTTP completion": ([{"prompt_ids": prompt}],
                            [{"token_ids": tok.encode(completion["choices"][0]["text"]),
                              "logprobs": completion["choices"][0]["logprobs"]
                              ["token_logprobs"]}]),
        "HTTP chat completion": (
            [{"prompt_ids": tok.encode(_chat_prompt(messages))}],
            [{"token_ids": tok.encode(chat["choices"][0]["message"]["content"]),
              "logprobs": [c["logprob"] for c in chat["choices"][0]["logprobs"]["content"]]}]),
    }
    for label, (reqs, res) in gated.items():
        gaps = logprob_gaps(params, cfg, reqs, res)
        log(f"phase 3d {label}: logprob |engine - forward| per request max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]} "
            f"(tol {LOGPROB_TOL})")
        for i, gap in enumerate(gaps):
            if not within_logprob_tol(gap):
                fail(f"phase 3d {label} request {i}: logprobs differ from the forward by max "
                     f"{gap[0]:.4f}, mean {gap[1]:.4f} (tol {LOGPROB_TOL})")
    for i, (req, res, stream) in enumerate(zip(http_requests, http_results, streams)):
        if not sse_whole(stream, res, req["max_tokens"]):
            fail(f"phase 3d HTTP request {i}: the stream is not whole: {res['content_chunks']} "
                 f"content chunks, finish_reason {res['finish_reason']}, [DONE] "
                 f"{stream['done']}")
    one_res = sse_result(one, tok)
    text = completion["choices"][0]["text"]
    same_text = tok.decode(one_res["token_ids"]) == text
    log(f"phase 3d: the SSE stream of the greedy completion is whole "
        f"{sse_whole(one, one_res, 32)} and reassembles into its non-streamed text {same_text}; "
        f"the handle's stream equals its whole request {streamed == whole['token_ids']}; "
        f"/v1/models lists {[m['id'] for m in models['data']]}, /-/healthz {health}")
    if not (sse_whole(one, one_res, 32) and same_text):
        fail("phase 3d: the SSE stream does not reassemble into the non-streamed completion")
    if streamed != whole["token_ids"]:
        fail("phase 3d: the handle's stream differs from the whole request's tokens")
    if [m["id"] for m in models["data"]] != ["llama3-8b"] or health != {"status": "ok"}:
        fail(f"phase 3d: /v1/models lists {models['data']}")
    if completion["choices"][0]["finish_reason"] != "length" \
            or len(tok.encode(text)) != 32:
        fail(f"phase 3d: the completion's finish_reason "
             f"{completion['choices'][0]['finish_reason']}, {len(tok.encode(text))} tokens")
    # the negative controls
    gaps = logprob_gaps(params, cfg, swapped_requests, swapped_results)
    caught_swap = (not answered(swapped_requests, swapped_results)
                   or any(not within_logprob_tol(g) for g in gaps))
    log(f"phase 3d planted fault handle_swaps_responses: responses answer their own requests "
        f"{answered(swapped_requests, swapped_results)}; logprob |engine - forward| per "
        f"request max {[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]}")
    dropped_res = sse_result(dropped, tok)
    caught_drop = not (sse_whole(dropped, dropped_res, 32)
                       and tok.decode(dropped_res["token_ids"]) == text)
    log(f"phase 3d planted fault sse_last_chunk_dropped: {len(dropped['chunks'])} chunks, "
        f"finish_reason {dropped_res['finish_reason']}, [DONE] {dropped['done']}")
    for name, hit in (("handle_swaps_responses", caught_swap),
                      ("sse_last_chunk_dropped", caught_drop)):
        if not hit:
            fail(f"phase 3d: its gate passes planted fault {name}")
    log(f"phase 3d: through HTTP: {http_figures}; through the handle: {handle_figures}; "
        f"phase 3 direct: {plain_figures} ({card})")
    log(f"phase 3d took {time.monotonic() - t_phase:.1f}s")
    return launches, http_figures


# ------------------------------------------------------------- phase 3g

# the transports phase 3g (a) runs each greedy prompt under
DISAGG_TRANSPORTS = ("stream", "channel", "object")
# how long a planted fault's importer may wait for a frame before it fails
# its request (DisaggConfig.kv_stream_idle_s), and the slack on top of it
DISAGG_FAULT_IDLE_S = 3.0
DISAGG_FAULT_SLACK_S = 5.0


def _crosses_requests(f):
    """DistChannel.put_many, what _KvSender flushes: frames wait until a
    second request's frames arrive, then the two requests' frames go out
    in one batch with each request's first frame carrying the other's KV;
    later batches pass."""
    held, lock, crossed = [], threading.Lock(), []

    def put_many(self, values, timeout=None):
        with lock:
            if crossed:
                batch = list(values)
            else:
                held.extend(values)
                rids = list(dict.fromkeys(rid for rid, _ in held))
                if len(rids) < 2:
                    return
                batch = list(held)
                held.clear()
                crossed.append(True)
                i = next(k for k, (rid, _) in enumerate(batch) if rid == rids[0])
                j = next(k for k, (rid, _) in enumerate(batch) if rid == rids[1])
                (ra, fa), (rb, fb) = batch[i], batch[j]
                batch[i], batch[j] = (ra, fb), (rb, fa)
        return f(self, batch, timeout)

    return put_many


def _drops_last_frame(f):
    """DistChannel.put_many: every request's last frame is lost."""
    def put_many(self, values, timeout=None):
        kept = [(rid, fr) for rid, fr in values if not fr.get("last")]
        return f(self, kept, timeout) if kept else None

    return put_many


# Planted disaggregation faults, on the KV sender's channel: name ->
# wrapper maker of DistChannel.put_many
DISAGG_FAULTS = {
    # two requests coalesced in one flush trade their first frames: the
    # exactness gate (or the import's own checks) must catch it
    "sender_crosses_requests": _crosses_requests,
    # a request's last frame never arrives: its import must fail with
    # KvMigrationError within kv_stream_idle_s, and the next request run
    "sender_drops_last_frame": _drops_last_frame,
}


def disagg_fault(name: str):
    from ray_tpu_torch.core import channels

    return swapped(channels.DistChannel,
                   put_many=DISAGG_FAULTS[name](channels.DistChannel.put_many))


def greedy(requests) -> list:
    return [r for r in requests if not r.get("temperature")]


def disagg_lines(label: str, requests, results, prefills: dict) -> None:
    """Per request: TTFT, the prefill leg's time, migration seconds and
    bytes, TPOT after the first token."""
    for req, res in zip(requests, results):
        pre = prefills.get(res["request_id"], {})
        n = len(res["token_ids"])
        tpot = (res["latency_s"] - res["ttft_s"]) / max(1, n - 1)
        log(f"{label}, {len(req['prompt_ids'])}-token prompt: TTFT {res['ttft_s']:.4f} s, "
            f"prefill_s {pre.get('prefill_s', float('nan')):.4f} s, migration "
            f"{1e3 * res['migration_s']:.2f} ms / {res['migration_bytes'] / 2**20:.2f} MiB "
            f"({res['kv_transport']}), TPOT {1e3 * tpot:.2f} ms")


def disagg_burst(co, requests, label: str, sync: bool = True) -> tuple:
    """All requests through the coordinator at once -> (results, wall s).
    sync=False leaves out the closing device-wide synchronize, which
    fails while another thread captures a graph (a replica building)."""
    results, errors = [None] * len(requests), []

    def run(i):
        r = requests[i]
        try:
            results[i] = co.generate(r["prompt_ids"], max_tokens=r["max_tokens"],
                                     temperature=r.get("temperature", 0.0),
                                     top_p=r.get("top_p", 1.0), timeout_s=300)
        except Exception as e:  # noqa: BLE001 — reported as this phase's failure
            errors.append(f"request {i}: {e!r}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(360)
    if sync:
        torch.cuda.synchronize()
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: {errors or 'a request did not finish'}")
    return results, time.monotonic() - t0


def disagg_path(server, card: str, plain_figures: str, deploy_figures=None) -> dict:
    """Phase 3g: disaggregated prefill/decode serving on the card, over
    phase 3's tensors. A prefill-role and a decode-role LLMServer (each
    captures every program, decode spans on the prefill replica included)
    behind a DisaggCoordinator of EngineWorkers. (a) each greedy prompt of
    a fresh burst, alone, first on the decode engine itself, then through
    the coordinator under each of DISAGG_TRANSPORTS (prefix routing off):
    tokens and logprobs bit for bit the decode engine's own (exact_gate);
    then four requests decode on the decode engine, alone and while two
    700-token prompts migrate into it. (b) a fresh burst, the sampled
    request included, at once through the stream transport: phase 3's
    logprob gate. (c) (a)'s 700-token stream prompt again through a
    coordinator with prefix routing on: it runs on the decode replica with
    no prefill hop (zero migration bytes, kv_migrations unchanged), exact
    against (a). (e) each planted DISAGG_FAULTS entry must fail its gate.
    (d) build_openai_app(disagg=...) (deploy_disagg through the serve
    runtime: llm-prefill and llm-decode replicas over the same tensors)
    behind serve.http_port(): a coordinator over the deployments and the
    SSE route each give (a)'s stream prompts, sent one at a time, (a)'s
    tokens; a burst as concurrent SSE streams comes back whole, and one as
    concurrent whole completions passes phase 3's logprob gate; after
    serve.shutdown() no thread the phase started is alive and
    card memory is back within SERVE_RETIRED_MEMORY_TOL. Launches are
    counted only while the coordinators serve (a)-(c) and (d): the decode
    engine's own runs (the wants of (a) and (e), the busy requests of the
    decode-gap measurement), the builds, the planted runs and the
    yardstick forwards are left out. Every SERVE_KERNELS entry must have
    run there, every launch from a graph replay. Returns those counts."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve.disagg import DisaggCoordinator, EngineWorker, KvMigrationError

    cfg, params = server.engine.cfg, server.engine.params
    t_phase = time.monotonic()
    rng = torch.Generator().manual_seed(5)  # fresh prompts, seeded, host-side
    tok = IdTokenizer()

    def params_fn():
        return params, cfg

    class Worker(EngineWorker):
        """An EngineWorker that keeps each prefill leg's result."""

        prefills: dict = {}

        def prefill_request(self, request):
            res = super().prefill_request(request)
            self.prefills[res["request_id"]] = res
            return res

    serve.shutdown()
    rt.shutdown()
    rt.init(system_config=RUNTIME_FLAGS)  # the object transport's store, in thread mode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_start = torch.cuda.memory_allocated()
    pre = new_server("phase 3g: prefill-role LLMServer llama3-8b", params_fn=params_fn,
                     engine_config=ENGINE, role="prefill")
    dec = new_server("phase 3g: decode-role LLMServer llama3-8b", params_fn=params_fn,
                     engine_config=ENGINE, role="decode")
    pw, dw = Worker(pre.engine, "prefill"), Worker(dec.engine, "decode")

    counted = dict.fromkeys(dispatch.launch_counts(), 0)

    def count(label: str) -> None:
        """Add the launches since the last reset to `counted`: those of
        the disaggregated path alone, each from a graph replay."""
        require_no_eager_launches(label)
        for name, n in dispatch.launch_counts().items():
            counted[name] += n

    # (a) exact, alone, per transport: the decode engine's own runs first,
    # outside the counted window
    prompts_by = {t: greedy(burst_requests(cfg, rng)) for t in DISAGG_TRANSPORTS}
    wants = {t: [dec(dict(r)) for r in reqs] for t, reqs in prompts_by.items()}
    dispatch.reset_launches()
    for transport in DISAGG_TRANSPORTS:
        co = DisaggCoordinator([pw], [dw], {"kv_transfer": transport, "small_blob_bytes": 0,
                                            "prefix_routing": False})
        reqs, want = prompts_by[transport], wants[transport]
        got = [co.generate(r["prompt_ids"], max_tokens=r["max_tokens"], timeout_s=300)
               for r in reqs]
        co.close()
        disagg_lines(f"phase 3g (a) {transport}", reqs, got, Worker.prefills)
        if not exact_gate(f"phase 3g (a) {transport}", [r["prompt_ids"] for r in reqs],
                          got, want):
            fail(f"phase 3g (a): the {transport} transport's tokens or logprobs differ from "
                 f"the decode engine's own run")
        if any(g["kv_transport"] != transport for g in got):
            fail(f"phase 3g (a): a request rode {[g['kv_transport'] for g in got]}, not "
                 f"{transport}")
    count("phase 3g (a)")
    long_req = max(prompts_by["stream"], key=lambda r: len(r["prompt_ids"]))

    # decode gaps on the decode engine, alone and while imports stage: the
    # busy requests run on the decode engine itself, so nothing here counts
    co = DisaggCoordinator([pw], [dw], {"prefix_routing": False})
    filler = torch.randint(1, cfg.vocab_size, (800,), generator=rng).tolist()
    busy = keep_busy(dec.engine, filler, n=4, max_tokens=120)
    alone = finish_busy(busy)
    busy = keep_busy(dec.engine, filler[400:], n=4, max_tokens=120)
    moved = [torch.randint(1, cfg.vocab_size, (700,), generator=rng).tolist()
             for _ in range(2)]
    for p in moved:
        co.generate(p, max_tokens=32, timeout_s=300)
    during = finish_busy(busy)
    co.close()
    log(f"phase 3g: four requests decoding on the decode engine, alone: {alone}; while two "
        f"700-token prompts migrated into it (stream): {during} ({card})")

    # (b) under load: a fresh burst at once, the sampled request included
    dispatch.reset_launches()
    co = DisaggCoordinator([pw], [dw], {"prefix_routing": False})
    requests = burst_requests(cfg, rng)
    results, wall = disagg_burst(co, requests, "phase 3g (b)")
    co.close()
    disagg_lines("phase 3g (b) stream", requests, results, Worker.prefills)
    burst_figures = report_burst("phase 3g (b) disagg", requests, results, wall)

    # (c) the prefix route: (a)'s 700-token stream prompt, warm on the decode engine
    co = DisaggCoordinator([pw], [dw], {"prefix_gossip_s": 0.0})
    before = co.stats()["kv_migrations"]
    routed = co.generate(long_req["prompt_ids"], max_tokens=32, timeout_s=300)
    after = co.stats()["kv_migrations"]
    co.close()
    count("phase 3g (b)-(c)")
    want_long = wants["stream"][prompts_by["stream"].index(long_req)]
    log(f"phase 3g (c): the {len(long_req['prompt_ids'])}-token prompt routed by prefix: "
        f"transport {routed['kv_transport']}, {routed.get('prefix_warm_tokens')} warm tokens, "
        f"migration bytes {routed['migration_bytes']}, kv_migrations {before} -> {after}, "
        f"TTFT {routed['ttft_s']:.4f} s")
    if (routed["kv_transport"] != "skipped" or routed["migration_bytes"] != 0
            or after != before):
        fail(f"phase 3g (c): the warm prompt migrated: {routed['kv_transport']}, "
             f"{routed['migration_bytes']} bytes, kv_migrations {before} -> {after}")
    if not exact_gate("phase 3g (c) prefix route", [long_req["prompt_ids"]], [routed],
                      [want_long]):
        fail("phase 3g (c): the routed prompt differs from (a)'s")

    # (e) the planted faults, each on fresh prompts against the decode
    # engine's own run of them
    free0 = dec.engine.stats()["free_pages"]
    cross = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist() for n in (100, 200)]
    cross_want = [dec({"prompt_ids": p, "max_tokens": 32}) for p in cross]
    co = DisaggCoordinator([pw], [dw], {"prefix_routing": False,
                                        "kv_stream_idle_s": DISAGG_FAULT_IDLE_S})
    with disagg_fault("sender_crosses_requests"):
        out, errs = [None, None], []

        def run(i):
            try:
                out[i] = co.generate(cross[i], max_tokens=32, timeout_s=120)
            except Exception as e:  # noqa: BLE001 — what the gate reads
                errs.append(repr(e))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    caught_cross = bool(errs) or not all(
        o is not None and o["token_ids"] == w["token_ids"] and o["logprobs"] == w["logprobs"]
        for o, w in zip(out, cross_want))
    log(f"phase 3g planted fault sender_crosses_requests: errors {errs or 'none'}; tokens "
        f"equal the decode engine's {[o is not None and o['token_ids'] == w['token_ids'] for o, w in zip(out, cross_want)]}")
    lost = torch.randint(1, cfg.vocab_size, (200,), generator=rng).tolist()
    t = time.monotonic()
    with disagg_fault("sender_drops_last_frame"):
        try:
            co.generate(lost, max_tokens=32, timeout_s=120)
            dropped_err = None
        except KvMigrationError as e:
            dropped_err = str(e)
    dropped_s = time.monotonic() - t
    after_fault = torch.randint(1, cfg.vocab_size, (200,), generator=rng).tolist()
    after_want = dec({"prompt_ids": after_fault, "max_tokens": 32})
    after_got = co.generate(after_fault, max_tokens=32, timeout_s=300)
    co.close()
    deadline = time.monotonic() + 15
    while dec.engine.stats()["free_pages"] != free0 and time.monotonic() < deadline:
        time.sleep(0.05)
    free1 = dec.engine.stats()["free_pages"]
    log(f"phase 3g planted fault sender_drops_last_frame: KvMigrationError after "
        f"{dropped_s:.2f} s (idle {DISAGG_FAULT_IDLE_S} s): {dropped_err}; the next request "
        f"exact {after_got['token_ids'] == after_want['token_ids']}; decode pages free "
        f"{free0} -> {free1}")
    caught_drop = (dropped_err is not None
                   and dropped_s < DISAGG_FAULT_IDLE_S + DISAGG_FAULT_SLACK_S)
    for name, hit in (("sender_crosses_requests", caught_cross),
                      ("sender_drops_last_frame", caught_drop)):
        if not hit:
            fail(f"phase 3g: its gate passes planted fault {name}")
    if not exact_gate("phase 3g after the dropped frame", [after_fault], [after_got],
                      [after_want]) or free1 != free0:
        fail(f"phase 3g: the run did not go on after the dropped frame (pages {free0} -> "
             f"{free1})")
    pre.shutdown()
    dec.shutdown()
    Worker.prefills.clear()
    del co, pre, dec, pw, dw  # a coordinator holds its workers, and they the engines
    release()
    log(f"phase 3g: card memory after the roles' engines stopped "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({mem_start / 2**30:.2f} GiB before "
        f"they were built)")

    # (d) the entry points users call: build_openai_app(disagg=...) over HTTP
    rt.init(system_config=RUNTIME_FLAGS)
    runtime_threads = set(threading.enumerate())
    global MEMORY_SPLIT_HEAD_BYTES
    MEMORY_SPLIT_HEAD_BYTES = cfg.vocab_size * cfg.d_model * 4
    split0 = memory_split("phase 3g (d) before the replicas")
    mem0 = split0["allocated"]
    # allocation sites of what the retirement leaves (Python stacks of the
    # blocks allocated from here on)
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=200000)
    t0 = time.monotonic()
    app = serve.build_openai_app(disagg={"prefill_replicas": 1, "decode_replicas": 1},
                                 model_name="llama3-8b", params_fn=params_fn,
                                 engine_config=ENGINE, tokenizer=tok)
    serve.run(app, name="v1")
    for dep in ("llm-prefill", "llm-decode", "openai"):
        ((replica, ready_s),) = wait_ready(dep, 1, t0, "phase 3g")
        stats = rt.get(replica.handle_request.remote("stats", ({},), {}), timeout=60)
        if "capture" in stats:
            log(f"phase 3g: {dep} replica ready {ready_s:.1f}s after build_openai_app; role "
                f"{stats['role']}, capture {stats['capture']['seconds']:.1f}s for "
                f"{stats['capture']['programs']} programs")
    port = serve.http_port()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/healthz", timeout=60) as r:
        json.loads(r.read())
    dispatch.reset_launches()
    co = DisaggCoordinator.from_deployments("llm-prefill", "llm-decode", {})
    reqs, want = prompts_by["stream"], wants["stream"]
    via_co = [co.generate(r["prompt_ids"], max_tokens=r["max_tokens"], timeout_s=300)
              for r in reqs]
    one_by_one = []
    for r in reqs:  # alone, as (a) ran them
        one_by_one.append(sse_result(sse_request(port, "/v1/completions", {
            "prompt": r["prompt_ids"], "max_tokens": r["max_tokens"], "logprobs": 1}), tok))
    # the burst as concurrent SSE streams (a stream through the front's
    # coordinator carries its logprobs only in the summary at its end, so
    # its chunks' logprobs are null, as the reference's), then as
    # concurrent whole completions, whose logprobs the gate reads
    http_requests = burst_requests(cfg, rng)
    streams, http_wall = sse_burst(port, http_requests)
    http_results = [sse_result(s, tok) for s in streams]
    whole_requests = burst_requests(cfg, rng)
    whole_results = [None] * len(whole_requests)

    def complete(i):
        r = whole_requests[i]
        with http_post(port, "/v1/completions", {
                "prompt": r["prompt_ids"], "max_tokens": r["max_tokens"], "logprobs": 1,
                "temperature": r.get("temperature", 0.0),
                "top_p": r.get("top_p", 1.0)}) as resp:
            c = json.loads(resp.read())["result"]["choices"][0]
        whole_results[i] = {"token_ids": tok.encode(c["text"]),
                            "logprobs": c["logprobs"]["token_logprobs"]}

    threads = [threading.Thread(target=complete, args=(i,)) for i in range(len(whole_requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(660)
    if any(r is None for r in whole_results):
        fail("phase 3g (d): a whole completion did not come back")
    co.close()
    del co
    with http_post(port, "/v1/stats", {}) as r:
        co_stats = json.loads(r.read())["result"]
    count("phase 3g (d)")
    http_figures = sse_figures("phase 3g (d) HTTP (SSE, logprobs)", streams, http_wall)
    peak = torch.cuda.max_memory_allocated()
    t_down = time.monotonic()
    serve.shutdown()
    deadline = time.monotonic() + 15
    while True:
        left = [t.name for t in threading.enumerate()
                if t not in runtime_threads and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    rt.shutdown()
    release()
    kept = torch.cuda.memory_allocated() - mem0
    left_snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    memory_split("phase 3g (d) after the replicas retired", split0)
    log(f"phase 3g (d): allocation sites of the blocks allocated since the replicas' build and "
        f"still allocated: {sites_of_new_blocks(left_snapshot)} ({card})")
    del left_snapshot
    log(f"phase 3g (d): serve.shutdown() took {time.monotonic() - t_down:.2f}s; threads the "
        f"phase started still alive after it: {left or 'none'}; card memory before the "
        f"replicas {mem0 / 2**30:.2f} GiB, left after retirement {kept / 2**30:+.3f} GiB "
        f"(tol {SERVE_RETIRED_MEMORY_TOL / 2**30:.2f} GiB); peak over the phase "
        f"{peak / 2**30:.2f} GiB (phase 3's server and tensors included, "
        f"{mem_start / 2**30:.2f} GiB at the phase's start) ({card})")
    log(f"phase 3g (d): coordinator stats over HTTP {co_stats}")
    if left:
        fail(f"phase 3g: threads outlived serve.shutdown(): {left}")
    if kept > SERVE_RETIRED_MEMORY_TOL:
        fail(f"phase 3g: {kept / 2**30:.3f} GiB stayed allocated after the replicas retired")
    if not exact_gate("phase 3g (d) coordinator over the deployments",
                      [r["prompt_ids"] for r in reqs], via_co, want):
        fail("phase 3g (d): the deployments' tokens differ from (a)'s")
    for i, (res, w) in enumerate(zip(one_by_one, want)):
        if res["token_ids"] != w["token_ids"] or res["finish_reason"] != "length":
            fail(f"phase 3g (d) HTTP request {i}: tokens differ from (a)'s")
    log(f"phase 3g (d): {len(one_by_one)} greedy SSE completions one at a time give (a)'s "
        f"tokens")
    for i, (req, res, stream) in enumerate(zip(http_requests, http_results, streams)):
        if not sse_whole(stream, res, req["max_tokens"]):
            fail(f"phase 3g (d) HTTP request {i}: the stream is not whole")
    if co_stats.get("kv_migrations", 0) < len(one_by_one) + 2 * len(http_requests):
        fail(f"phase 3g (d): the front's coordinator counted {co_stats.get('kv_migrations')} "
             f"migrations")

    # the gates that run the yardstick forward
    for label, (reqs_, res_) in {"(b) burst": (requests, results),
                                 "(d) HTTP burst": (whole_requests, whole_results)}.items():
        gaps = logprob_gaps(params, cfg, reqs_, res_)
        log(f"phase 3g {label}: logprob |engine - forward| per request max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]} "
            f"(tol {LOGPROB_TOL})")
        for i, gap in enumerate(gaps):
            if not within_logprob_tol(gap):
                fail(f"phase 3g {label} request {i}: logprobs differ from the forward by max "
                     f"{gap[0]:.4f}, mean {gap[1]:.4f} (tol {LOGPROB_TOL})")
    log(f"launches on the disagg path (the coordinators' requests of (a)-(c) and (d); the "
        f"decode engine's own runs, builds, planted runs and yardstick forwards not): "
        f"{counted}")
    for name in SERVE_KERNELS:
        if counted[name] <= 0:
            fail(f"phase 3g never launched kernel {name}")
    log(f"phase 3g: disaggregated burst {burst_figures}; through HTTP {http_figures}; phase 3 "
        f"direct {plain_figures}; phase 3d through HTTP {deploy_figures or 'not run'} ({card})")
    log(f"phase 3g took {time.monotonic() - t_phase:.1f}s")
    return counted, burst_figures


def disagg_only(card: str) -> None:
    """`--disagg`: phase 3's server and plain burst, then phase 3g on its
    tensors (no other phase, no result line)."""
    server = new_server("phase 3: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    requests = burst_requests(server.engine.cfg, torch.Generator().manual_seed(1))
    results, wall, errors = run_requests(server, requests)
    if errors:
        fail(f"phase 3 burst: {errors}")
    disagg_path(server, card, report_burst("plain", requests, results, wall))
    server.shutdown()


# ------------------------------------------------------------- phase 3f

# the fleet's policy in phase 3f: one or two replicas a role, a decision every
# half second, no cooldown, a role steps down after three quiet evaluations;
# the default target_queue_depth (a role is pressured past two waiting
# requests a replica): the four streams of (b) (their continuations after a
# remediation) run as prefill legs, one at a time, that the prefill replica
# runs long before another could be built, which the fleet does not read as
# a backlog (ROADMAP C15), and the burst's alert scales the role
FLEET_CONFIG = {"min_replicas": 1, "max_replicas": 2, "eval_period_s": 0.5, "cooldown_s": 0.0,
                "idle_periods": 3}
# the health plane in phase 3f: queue_depth fires once more than 4 requests wait
# for a role on two passes 0.25 s apart (the burst holds up to 16 on the prefill
# role, whose leg serves one prompt at a time); four streams stay under it
FLEET_SYSTEM_CONFIG = {"health_queue_depth_max": 4, "health_eval_period_s": 0.25}
FLEET_BURST = 16  # concurrent greedy requests, 23/100/200/700-token prompts
FLEET_FOLLOW = 8  # requests sent at once when the new replica is ready (700/200, 8 out)
FLEET_FOLLOW_TOKENS = 8
FLEET_STREAMS = 4
FLEET_STREAM_TOKENS = 96
FLEET_STREAM_HEAD = 1  # tokens every stream has before the remediation (its first:
# the decode replica takes the four imports one span apart, so the first stream
# is far into its 96 tokens when the last begins)
FLEET_STREAM_PROMPT = 100  # the streams' prompts, one length: they decode side by side
# the longest a replica build, a scale step or a request may take in phase 3f
FLEET_WAIT_S = 180.0
FLEET_DEPLOYMENTS = {"prefill": "fleet-prefill", "decode": "fleet-decode"}


def _records_target_only(f):
    """FleetController._set_target: the new target is recorded (and its
    action logged), but the serve controller is never asked for it."""
    def _set_target(self, role, target, kind, **detail):
        saved, self._deployments = self._deployments, None
        try:
            return f(self, role, target, kind, **detail)
        finally:
            self._deployments = saved

    return _set_target


def _reports_one_unsynced(f):
    """FleetController.sync_weights: the last worker of the decode role is
    reported synced at the requested version without being called."""
    def sync_weights(self, *args, **kwargs):
        skipped = self.co.workers("decode")[-1]
        skipped.update_weights = lambda request: {"weights_version": request.get("version")}
        try:
            return f(self, *args, **kwargs)
        finally:
            del skipped.update_weights

    return sync_weights


def _restarts_before_drain(f):
    """FleetController.remediate: the replica is restarted while it is
    still in the pick set, then drained, with the coordinator's live resume
    off (its streams die with it)."""
    def remediate(self, role, key, reason="alert"):
        w = next((w for w in self.co.workers(role) if w.key == key), None)
        if w is None:
            return False
        self.co.cfg.live_resume = False
        self._restart_replica(self._deployment(role), w)
        self.co.remove_worker(role, key)
        return True

    return remediate


# Planted fleet faults: name -> (FleetController attribute, wrapper maker);
# each must fail its gate
FLEET_FAULTS = {
    # (a)'s gate "a new replica joins and serves" must fail
    "target_recorded_not_actuated": ("_set_target", _records_target_only),
    # (c)'s gate "every replica reports the synced version" must fail
    "sync_reports_unsynced_replica": ("sync_weights", _reports_one_unsynced),
    # (b)'s gate "every stream finishes token-identical" must fail
    "restart_before_drain_without_resume": ("remediate", _restarts_before_drain),
}


def fleet_fault(name: str):
    from ray_tpu_torch.serve.fleet import FleetController

    attr, maker = FLEET_FAULTS[name]
    return swapped(FleetController, **{attr: maker(getattr(FleetController, attr))})


class ThreadSampler:
    """`--build-profile`: while any replica builds, read every thread's CPU
    time every SAMPLE_S seconds (user and system ticks in
    /proc/self/task/<tid>/stat, which a thread that has ended no longer
    has) and charge what it used since the
    last read to its name and to its innermost Python frame then
    (sys._current_frames); `report` prints the CPU seconds by thread name
    and by frame, beside the window's wall seconds."""

    SAMPLE_S = 0.02

    def __init__(self):
        from collections import Counter

        self.lock = threading.Lock()
        self.active = 0
        self.wall = 0.0
        self.cpu, self.frames = Counter(), Counter()
        self.counts = Counter()
        self.thread = None

    def enter(self):
        with self.lock:
            self.active += 1
            if self.thread is None:
                self.thread = threading.Thread(target=self._run, name="build-sampler",
                                               daemon=True)
                self.thread.start()

    def exit(self):
        with self.lock:
            self.active -= 1

    def _run(self):
        me = threading.get_ident()
        tick = os.sysconf("SC_CLK_TCK")
        last = {}
        t_last = time.monotonic()
        while True:
            with self.lock:
                if self.active <= 0:
                    self.thread = None
                    return
            threads = {t.ident: (t.name.split("-")[0], t.native_id)
                       for t in threading.enumerate()}
            frames = sys._current_frames()
            now = time.monotonic()
            self.wall += now - t_last
            t_last = now
            for tid, (name, native) in threads.items():
                if tid == me or native is None:
                    continue
                try:
                    with open(f"/proc/self/task/{native}/stat") as f:
                        fields = f.read().rsplit(")", 1)[1].split()
                    used = (int(fields[11]) + int(fields[12])) / tick
                except (OSError, ValueError, IndexError):  # ended since
                    continue
                delta = used - last.get(tid, used)
                last[tid] = used
                self.cpu[name] += delta
                frame = frames.get(tid)
                if frame is None or delta <= 0:
                    continue
                where = frame.f_code.co_filename
                where = os.path.relpath(where, HERE) if where.startswith(HERE) \
                    else os.path.basename(where)
                self.frames[f"{name} {where}:{frame.f_lineno} {frame.f_code.co_name}"] += delta
            names = [n for n, _ in threads.values()]
            for name in set(names):
                self.counts[name] = max(self.counts[name], names.count(name))
            time.sleep(self.SAMPLE_S)

    def report(self, label: str) -> None:
        threads = ", ".join(f"{k} {v:.2f} s (up to {self.counts[k]} threads)"
                            for k, v in self.cpu.most_common() if v > 0.05)
        frames = "; ".join(f"{k} {v:.2f} s" for k, v in self.frames.most_common(16))
        log(f"{label}: {self.wall:.1f} s of wall time while replicas built; CPU time by thread "
            f"name {threads}; by the innermost frame at each read {frames}")


BUILD_SAMPLER = None  # a ThreadSampler under --build-profile


class BuildLaunches:
    """Kernel launches made while a replica builds (LLMServer's __init__ on
    its actor's lane: the engine's warm runs and eager passes before each
    capture), so that a counted window can leave them out; and each build's
    seconds."""

    def __init__(self):
        from ray_tpu_torch.serve.llm import LLMServer

        self.cls = LLMServer._target
        self.lock = threading.Lock()
        self.tallies, self.seconds = [], []
        self.mark = {}

    def __enter__(self):
        from ray_tpu_torch.ops import dispatch

        orig = self.saved = self.cls.__init__
        me = self

        def __init__(inner, *args, **kwargs):
            t0 = time.monotonic()
            if BUILD_SAMPLER is not None:
                BUILD_SAMPLER.enter()
            try:
                with dispatch.tallying_launches() as tally:
                    with me.lock:
                        me.tallies.append(tally)
                    orig(inner, *args, **kwargs)
            finally:
                if BUILD_SAMPLER is not None:
                    BUILD_SAMPLER.exit()
            with me.lock:
                me.seconds.append(time.monotonic() - t0)

        self.cls.__init__ = __init__
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.saved

    def total(self) -> dict:
        out = {}
        with self.lock:
            tallies = list(self.tallies)
        for tally in tallies:
            while True:
                try:
                    items = list(tally.items())
                    break
                except RuntimeError:  # a build's first launch of a kernel added a key
                    continue
            for name, n in items:
                out[name] = out.get(name, 0) + n
        return out

    def reset(self) -> None:
        """Where a counted window begins (with dispatch.reset_launches)."""
        self.mark = self.total()

    def since(self) -> dict:
        now = self.total()
        return {k: n - self.mark.get(k, 0) for k, n in now.items()}


def fleet_requests(cfg, rng, n: int = FLEET_BURST, max_tokens: int = 32,
                   lengths=(23, 100, 200, 700)) -> list:
    """n greedy requests, prompts of the given lengths in turn."""
    return [{"prompt_ids": torch.randint(1, cfg.vocab_size, (lengths[i % len(lengths)],),
                                         generator=rng).tolist(),
             "max_tokens": max_tokens} for i in range(n)]


def replica_stats(w) -> dict:
    return w._call("stats", {}, 60.0)


def wait_new_replica(co, role: str, before: set, fleet, label: str) -> tuple:
    """-> (worker, seconds) once a replica of `role` that `before` did not
    hold is in the coordinator's pick set and has finished its __init__;
    (None, seconds) when none comes: within FLEET_WAIT_S, or at once when
    the serve controller's target for the role's deployment stays below
    the fleet's for 3 s (no replica is being built)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import get_or_create_controller

    ctrl = get_or_create_controller()
    name = FLEET_DEPLOYMENTS[role]
    t0 = time.monotonic()
    short_since = None
    while time.monotonic() - t0 < FLEET_WAIT_S:
        co._sync(force=True)
        new = [w for w in co.workers(role) if w.key not in before]
        if new:
            rt.get(new[0]._replica.health_check.remote(), timeout=FLEET_WAIT_S)
            return new[0], time.monotonic() - t0
        st = rt.get(ctrl.status.remote(), timeout=60).get(name, {})
        if st.get("target_replicas", 0) < fleet.status()["targets"][role]:
            short_since = short_since or time.monotonic()
            if time.monotonic() - short_since > 3.0:
                log(f"{label}: the serve controller's target for {name} stays at "
                    f"{st.get('target_replicas')}, the fleet's is "
                    f"{fleet.status()['targets'][role]}")
                return None, time.monotonic() - t0
        else:
            short_since = None
        time.sleep(0.1)
    return None, time.monotonic() - t0


def open_streams(co, prompts, max_tokens: int):
    """Each prompt as a coordinator stream opened and drained on its own
    thread, every token's arrival stamped -> (streams, threads, out);
    streams[i] is set once its stream opens, out[i] ends up as {"tokens",
    "at", "error", "finish_reason"}."""
    out = [{"tokens": [], "at": [], "error": None, "finish_reason": None} for _ in prompts]
    streams = [None] * len(prompts)

    def drain(i):  # opened here, so that the streams start side by side
        try:
            streams[i] = co.open_stream(prompts[i], max_tokens=max_tokens,
                                        timeout_s=FLEET_WAIT_S)
            for tok in streams[i].tokens():
                out[i]["tokens"].append(tok)
                out[i]["at"].append(time.monotonic())
            out[i]["finish_reason"] = streams[i].finish_reason
        except Exception as e:  # noqa: BLE001 — what the gate reads
            out[i]["error"] = repr(e)

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    return streams, threads, out


def streams_at(out, n: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while any(len(o["tokens"]) < n and o["error"] is None for o in out):
        if time.monotonic() > deadline:
            fail(f"phase 3f: a stream did not reach {n} tokens in {timeout} s")
        time.sleep(0.005)


def resume_point(stream) -> int:
    """Tokens a stream had committed when it resumed on a peer (its summary
    carries None for their logprobs, which died with the replica); 0 for a
    stream that never resumed."""
    lps = stream.logprobs or []
    return next((i for i, lp in enumerate(lps) if lp is not None), len(lps))


def forward_f32_plain(params, cfg, seq: list) -> torch.Tensor:
    """The log-softmax of the token after `seq` under a plain f32 forward:
    the bf16 weights cast to f32 one matrix at a time, rms_norm_reference
    and mha_reference in place of K1 and K2, f32 activations throughout. A
    higher-precision witness for the engine's bf16 runs; llama-shaped
    models (RMSNorm, RoPE, SwiGLU, dense)."""
    import torch.nn.functional as F

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops.attention import mha_reference
    from ray_tpu_torch.ops.norm import rms_norm_reference
    from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

    if (cfg.norm, cfg.positional, cfg.activation, cfg.is_moe) != ("rmsnorm", "rope", "swiglu",
                                                                  False):
        fail(f"forward_f32_plain: {cfg.name} is not llama-shaped")

    def mm(x, w):
        d = w.shape[0]
        return (x.reshape(-1, d) @ w.reshape(d, -1).float()).reshape(*x.shape[:-1],
                                                                    *w.shape[1:])

    with torch.no_grad():
        dev = params["embed"].device
        x = params["embed"][torch.tensor([seq], device=dev)].float()
        cos, sin = rope_frequencies(cfg.hdim, cfg.max_seq_len, cfg.rope_theta, device=dev)
        for lp in transformer.layer_views(params["layers"]):
            h = rms_norm_reference(x, lp["ln1"], cfg.norm_eps)
            q = apply_rope(mm(h, lp["wq"]), cos, sin)
            k = apply_rope(mm(h, lp["wk"]), cos, sin)
            o = mha_reference(q, k, mm(h, lp["wv"]), causal=True)
            x = x + mm(o.reshape(*o.shape[:2], -1), lp["wo"].reshape(-1, lp["wo"].shape[-1]))
            h = rms_norm_reference(x, lp["ln2"], cfg.norm_eps)
            x = x + mm(F.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_in"]), lp["w_out"])
        h = rms_norm_reference(x[0, -1], params["final_norm"], cfg.norm_eps)
        logits = h @ transformer.lm_head_weight(params, cfg).float()
        if cfg.logits_softcap:
            logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
        return torch.log_softmax(logits, dim=-1)


def resume_gate(label: str, requests, out, streams, resumed_at, wants_by_prompt,
                witness=None) -> bool:
    """Per stream: no error; its tokens up to the resume point equal the
    engine's own uninterrupted run of its prompt, and from there its tokens
    and logprobs equal, bit for bit, the engine's own run of the
    continuation (the prompt and the committed tokens as one prompt: what
    the peer was asked). The peer recomputes the committed tokens' KV in a
    prefill, whose bf16 GEMMs round otherwise than the decode steps that
    first made it, so a resumed stream may leave the uninterrupted run
    where two tokens nearly tie. With `witness` (prefix -> the next token's
    f32 log-softmax, forward_f32_plain), at the first token where a resumed
    stream leaves the uninterrupted run, the two runs' tokens must lie
    within LOGPROB_TOL["max"] of each other under the witness: a tie that
    bf16 rounding can break, not a resume that lost its place. Printed
    there: the engine's logprob of each run's token, the witness's
    logprobs of both and its top two."""
    ok = True
    for i, (r, o, s, k) in enumerate(zip(requests, out, streams, resumed_at)):
        whole = wants_by_prompt(r)
        if o["error"] is not None:
            log(f"{label} stream {i}: failed after {len(o['tokens'])} tokens: {o['error']}")
            ok = False
            continue
        head = o["tokens"][:k] == whole["token_ids"][:k]
        if k:
            cont = wants_by_prompt({"prompt_ids": r["prompt_ids"] + o["tokens"][:k],
                                    "max_tokens": len(whole["token_ids"]) - k})
            tail = (o["tokens"][k:] == cont["token_ids"]
                    and list(s.logprobs[k:]) == list(cont["logprobs"]))
        else:
            tail = o["tokens"] == whole["token_ids"] and list(s.logprobs) == whole["logprobs"]
        same = sum(a == b for a, b in zip(o["tokens"], whole["token_ids"]))
        first = next((j for j, (a, b) in enumerate(zip(o["tokens"], whole["token_ids"]))
                      if a != b), None)
        tie, why = True, ""
        if first is not None and witness is not None:
            a, b = whole["token_ids"][first], o["tokens"][first]
            lp = witness(r["prompt_ids"] + whole["token_ids"][:first])
            top = torch.topk(lp, 2)
            gap = (lp[a] - lp[b]).item()
            tie = abs(gap) <= LOGPROB_TOL["max"]
            why = (f"; at {first} the uninterrupted run took {a} (engine logprob "
                   f"{whole['logprobs'][first]}), the resumed one {b} (engine logprob "
                   f"{s.logprobs[first]}); the f32 witness: logprob {a} "
                   f"{lp[a].item():.4f}, {b} {lp[b].item():.4f}, gap {gap:+.4f} (tol "
                   f"{LOGPROB_TOL['max']}), top two {top.indices.tolist()} gap "
                   f"{(top.values[0] - top.values[1]).item():.4f}")
        log(f"{label} stream {i}: resumed after {k} tokens; error {o['error']}; the tokens "
            f"before it the uninterrupted run's {head}; after it the continuation's own run "
            f"(tokens and logprobs) {tail}; {same} of {len(whole['token_ids'])} tokens equal the "
            f"uninterrupted run (first difference at {first}){why}")
        ok = ok and o["error"] is None and head and tail and tie
    return ok


def remediations() -> dict:
    from ray_tpu_torch.core.metrics import registry

    rem = registry.get("serve_fleet_remediations")
    return {s: rem.get(tags={"stage": s}) for s in ("quarantine", "drain", "restart", "rejoin")}


def memory_split(label: str, base: dict | None = None) -> dict:
    """The card memory allocated now (after a collection and emptying the
    cache), split by kind: blocks in CUDA-graph pools (the allocator's
    private pools), blocks of exactly MEMORY_SPLIT_HEAD_BYTES (f32 head
    copies), blocks of exactly the cuBLAS workspace size (a workspace per
    cuBLAS handle and stream; read by size, not cleared, since a captured
    graph may hold one), the rest; and the cached blocks (reserved, not
    allocated). With `base` (an earlier split), prints the difference."""
    ws = cublas_workspace_sizes()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    alloc = torch.cuda.memory_allocated()
    graph = head = cublas = 0
    for seg in torch.cuda.memory_snapshot():
        active = [b["size"] for b in seg["blocks"] if b["state"] == "active_allocated"]
        if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
            graph += sum(active)
            continue
        head += sum(n for n in active if n == MEMORY_SPLIT_HEAD_BYTES)
        cublas += sum(n for n in active if n in ws)
    out = {"allocated": alloc, "graph_pools": graph, "head_copies": head,
           "cublas_workspaces": cublas, "other": alloc - graph - head - cublas,
           "cached": torch.cuda.memory_reserved() - alloc}
    if base is not None:
        diff = {k: out[k] - base[k] for k in out}
        log(f"{label}: card memory against before, GiB: "
            + ", ".join(f"{k} {v / 2**30:+.3f}" for k, v in diff.items())
            + f" (cuBLAS workspaces of {sorted(n / 2**20 for n in ws)} MiB)")
    return out


_WORKSPACE_SIZES = None


def cublas_workspace_sizes() -> set:
    """The sizes of the blocks a cuBLAS matmul allocates besides its output
    on a stream it has not run on: its workspaces (one set per cuBLAS
    handle and stream). Probed once; the probe's own workspaces stay."""
    global _WORKSPACE_SIZES
    if _WORKSPACE_SIZES is None:
        from collections import Counter

        def blocks():
            return Counter(b["size"] for seg in torch.cuda.memory_snapshot()
                           for b in seg["blocks"] if b["state"] == "active_allocated")

        a = torch.ones(64, 64, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        before = blocks()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            out = a @ a
        torch.cuda.synchronize()
        new = blocks() - before
        new[max(512, out.untyped_storage().nbytes())] -= 1
        _WORKSPACE_SIZES = {n for n, k in new.items() if k > 0}
        log(f"cuBLAS workspaces on a new stream: blocks of "
            f"{sorted(n / 2**20 for n in _WORKSPACE_SIZES)} MiB")
        del out, a
    return _WORKSPACE_SIZES


# bytes of one f32 head copy (set by the phase that knows the model)
MEMORY_SPLIT_HEAD_BYTES = 0


def sites_of_new_blocks(snapshot, top: int = 8) -> str:
    """Allocation sites (the innermost frame in ray_tpu_torch, else the
    innermost Python frame) of the blocks still allocated that carry a
    recorded stack, largest total first."""
    sites = {}
    for seg in snapshot["segments"]:
        for b in seg["blocks"]:
            if b["state"] != "active_allocated" or not b.get("frames"):
                continue
            frames = b["frames"]
            frame = next((f for f in frames if "ray_tpu_torch" in f.get("filename", "")),
                         frames[0])
            where = frame["filename"]
            where = (os.path.relpath(where, HERE) if where.startswith(HERE)
                     else os.path.basename(where))
            key = f"{where}:{frame['line']} {frame['name']}"
            n, size = sites.get(key, (0, 0))
            sites[key] = (n + 1, size + b["size"])
    ranked = sorted(sites.items(), key=lambda kv: -kv[1][1])[:top]
    return "; ".join(f"{k}: {n} blocks {s / 2**20:.1f} MiB" for k, (n, s) in ranked) or "none"


def fleet_cycle(co, fleet, plane, builds, count, wants_by_prompt, cfg, rng, label: str,
                card: str) -> dict:
    """(a): a burst of FLEET_BURST greedy requests through the coordinator
    trips queue_depth; the fleet raises that role's target, the serve
    controller builds the replica and the coordinator's _sync adds it
    (the fleet holds the target while it builds: FleetController._settled);
    once it is ready, FLEET_FOLLOW requests at once, of which it must serve
    one. Every request bit for bit the engine's own run of its prompt.
    Returns the burst's figures, the role and the new worker."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import dispatch

    before = {r: {w.key for w in co.workers(r)} for r in ("prefill", "decode")}
    requests = fleet_requests(cfg, rng)
    follow = fleet_requests(cfg, rng, n=FLEET_FOLLOW, max_tokens=FLEET_FOLLOW_TOKENS,
                            lengths=(700, 200))
    n_hist = len(plane.history())
    t_burst = time.time()
    dispatch.reset_launches()
    builds.reset()
    results, wall = disagg_burst(co, requests, f"phase 3f {label} burst", sync=False)
    fired = [a for a in plane.history()[n_hist:]
             if a["rule"] == "queue_depth" and a["state"] == "firing"]
    status = rt.status(as_dict=True)
    ups = [a for a in fleet.actions if a["kind"] == "scale-up" and a["at"] >= t_burst]
    if not fired or not ups:
        fail(f"phase 3f {label}: the burst fired {len(fired)} queue_depth alerts and the fleet "
             f"took {len(ups)} scale-up actions")
    role = ups[0]["role"]
    log(f"phase 3f {label}: queue_depth fired for {[a['labels'] for a in fired]} (value "
        f"{fired[0]['value']}, threshold {fired[0]['threshold']}); status() alerts "
        f"{[(a['rule'], a['labels']) for a in status['alerts']]}; the fleet: {ups[0]}")
    if ups[0]["to"] != 2:
        fail(f"phase 3f {label}: the fleet raised {role} to {ups[0]['to']}, not 2")
    new, waited = wait_new_replica(co, role, before[role], fleet, f"phase 3f {label}")
    if new is None:
        fail(f"phase 3f {label}: no new {role} replica joined the coordinator in {waited:.1f} s")
    t_ready = time.time()
    st = replica_stats(new)
    follow_results, follow_wall = disagg_burst(co, follow, f"phase 3f {label} follow-up",
                                               sync=False)
    t_served = time.time()
    served = co.health.snapshot().get(str(new.key), {}).get("ok", 0)
    count(f"phase 3f {label}")
    log(f"phase 3f {label}: alert at +{fired[0]['since'] - t_burst:.2f} s of the burst, target "
        f"{role} 1 -> 2 at +{ups[0]['at'] - t_burst:.2f} s, the new replica in the pick set and "
        f"ready at +{t_ready - t_burst:.2f} s, {served} of the follow-up's {len(follow)} requests "
        f"served on it by +{t_served - t_burst:.2f} s ({follow_wall:.2f} s); its build "
        f"{builds.seconds[-1]:.1f} s, capture {st['capture']['seconds']:.1f} s for "
        f"{st['capture']['programs']} programs ({card})")
    if served <= 0:
        fail(f"phase 3f {label}: the new {role} replica served no request")
    figures = report_burst(f"phase 3f {label} burst", requests, results, wall)
    got = results + follow_results
    reqs = requests + follow
    if not exact_gate(f"phase 3f {label}", [r["prompt_ids"] for r in reqs], got,
                      [wants_by_prompt(r) for r in reqs]):
        fail(f"phase 3f {label}: a request's tokens or logprobs differ from the engine's own "
             f"run of its prompt")
    return {"figures": figures, "role": role, "new": new}


def scale_down(co, fleet, label: str, seen_replicas: dict, n_actions: int) -> None:
    """(e): no traffic; every role steps down one replica per idle window
    to min_replicas (every step down since fleet.actions[n_actions]: the
    fleet may step a role down between (a)'s traffic and here), then holds
    for three evaluations, and every replica in `seen_replicas` (actor id
    -> handle) that left the deployments is dead."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import get_or_create_controller

    ctrl = get_or_create_controller()
    lo = FLEET_CONFIG["min_replicas"]
    t0 = time.monotonic()
    while any(v > lo for v in fleet.status()["targets"].values()):
        if time.monotonic() - t0 > FLEET_WAIT_S:
            fail(f"phase 3f {label}: targets {fleet.status()['targets']} after {FLEET_WAIT_S} s "
                 f"without traffic")
        time.sleep(0.05)
    downs = [a for a in fleet.actions[n_actions:] if a["kind"] == "scale-down"]
    window = FLEET_CONFIG["idle_periods"] * FLEET_CONFIG["eval_period_s"]
    for role in ("prefill", "decode"):
        steps = [a for a in downs if a["role"] == role]
        if any(a["from"] - a["to"] != 1 for a in steps):
            fail(f"phase 3f {label}: {role} stepped down by more than one: {steps}")
        gaps = [b["at"] - a["at"] for a, b in zip(steps, steps[1:])]
        if any(g < window - 0.1 for g in gaps):
            fail(f"phase 3f {label}: {role} stepped down twice within one idle window: {gaps}")
    held = []
    for _ in range(3):
        time.sleep(FLEET_CONFIG["eval_period_s"])
        held.append(dict(fleet.status()["targets"]))
    if any(h != {"prefill": lo, "decode": lo} for h in held):
        fail(f"phase 3f {label}: the targets did not hold at {lo}: {held}")
    rt_ = rt.api._auto_init()
    while True:  # the retired replicas stopped and killed by the controller
        live = {r: rt.get(ctrl.get_replicas.remote(name), timeout=60)[0]
                for r, name in FLEET_DEPLOYMENTS.items()}
        gone = [h for h in seen_replicas.values()
                if all(h._actor_id != x._actor_id for xs in live.values() for x in xs)]
        dead = [rt_.control_plane.get_actor(h._actor_id).state.name == "DEAD" for h in gone]
        if all(len(xs) == lo for xs in live.values()) and all(dead):
            break
        if time.monotonic() - t0 > FLEET_WAIT_S:
            fail(f"phase 3f {label}: the controller holds "
                 f"{ {r: len(xs) for r, xs in live.items()} } replicas, retired ones dead "
                 f"{dead}")
        time.sleep(0.1)
    co._sync(force=True)
    steps_of_cycle = [a for a in fleet.actions[n_actions:] if "from" in a]
    log(f"phase 3f {label}: scaled down in {time.monotonic() - t0:.2f} s: "
        f"{[(a['role'], a['from'], a['to'], round(a['at'] - downs[0]['at'], 2)) for a in downs]}; "
        f"all actions of the cycle "
        f"{[(a['kind'], a['role'], a['from'], a['to']) for a in steps_of_cycle]}; "
        f"targets then {held}; pick sets "
        f"{ {r: len(co.workers(r)) for r in ('prefill', 'decode')} }")


def fleet_path(server, card: str, disagg_figures: str) -> dict:
    """Phase 3f: the health plane and the serve fleet over phase 3's
    tensors. The process's HealthPlane (stock rules, FLEET_SYSTEM_CONFIG),
    deploy_disagg with one prefill and one decode replica, and a
    FleetController(FLEET_CONFIG) that scales them through the serve
    controller. (a) a burst of FLEET_BURST greedy requests trips
    queue_depth (fleet_cycle); the fleet raises the role's target to 2,
    the controller builds the replica, the coordinator picks it up, and it
    serves one of FLEET_FOLLOW requests sent once it is ready; every
    request bit for bit the engine's own run of its prompt (phase 3's
    server, before any window). (e) with no traffic each role steps down
    one replica per idle window and holds (scale_down); the fleet does so
    as soon as the new replica is ready and idle, while (b) runs, so (e)
    is read after (b). (b) four greedy streams of FLEET_STREAM_TOKENS decode on the decode
    replica when an alert naming it is injected: quarantine, drain, restart
    and rejoin each count once, every stream not finished on the replica
    resumes on the replacement (serve_fleet_resumes counts them), each
    equal to the engine's own run up to its resume and,
    bit for bit, to the engine's own run of its continuation after it,
    and where it leaves the uninterrupted run the two tokens nearly tie
    under a plain f32 forward (resume_gate with forward_f32_plain); the
    longest gap between tokens is printed. (c) sync_weights
    of phase 3's tree as version 1: every replica reports it, and a fresh
    prompt gives its tokens. (d) distribute_adapter: residency equals the
    decode replicas, and an adapter-named request reaches a resident
    replica. Then (a) and (e) again: the card memory left after the second
    retirement must stay within SERVE_RETIRED_MEMORY_TOL of the first's. Each
    FLEET_FAULTS entry must fail its gate. status() shows the alerts; no
    thread the phase started outlives serve.shutdown() and the plane's
    stop, and the card memory after them is within
    SERVE_RETIRED_MEMORY_TOL of the phase's start (C14; the allocation
    sites of what is left are printed). Launches are counted only while the coordinator serves (a)-(d)
    (replica builds left out): K1, K2, K5 and K6 must have run, every
    launch from a graph replay. Returns those counts."""
    global MEMORY_SPLIT_HEAD_BYTES
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import health
    from ray_tpu_torch.core.metrics import registry
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.disagg import deploy_disagg
    from ray_tpu_torch.serve.fleet import FleetController

    cfg, params = server.engine.cfg, server.engine.params
    MEMORY_SPLIT_HEAD_BYTES = cfg.vocab_size * cfg.d_model * 4
    t_phase = time.monotonic()
    rng = torch.Generator().manual_seed(9)  # fresh prompts, seeded, host-side

    def params_fn():
        return params, cfg

    want_cache = {}

    def wants_by_prompt(r):
        return want_cache[tuple(r["prompt_ids"]), r["max_tokens"]]

    def want(requests):
        """The engine's own runs of the requests (phase 3's server, all at
        once: its prefill runs one prompt at a time and its decode spans
        at the full batch, so a run does not depend on its neighbours)."""
        res, _wall, errs = run_requests(server, [dict(r) for r in requests])
        if errs:
            fail(f"phase 3f wants: {errs}")
        for r, g in zip(requests, res):
            want_cache[tuple(r["prompt_ids"]), r["max_tokens"]] = g

    # every prompt of the phase and the engine's own run of it, up front
    # (outside every counted window)
    draw = torch.Generator().manual_seed(9)
    burst_prompts = [fleet_requests(cfg, draw)
                     + fleet_requests(cfg, draw, n=FLEET_FOLLOW,
                                      max_tokens=FLEET_FOLLOW_TOKENS, lengths=(700, 200))
                     for _ in range(2)]
    stream_reqs = fleet_requests(cfg, draw, n=FLEET_STREAMS, max_tokens=FLEET_STREAM_TOKENS,
                                 lengths=(FLEET_STREAM_PROMPT,))
    sync_req, adapter_req = fleet_requests(cfg, draw, n=2)
    planted_streams = fleet_requests(cfg, draw, n=FLEET_STREAMS,
                                     max_tokens=FLEET_STREAM_TOKENS,
                                     lengths=(FLEET_STREAM_PROMPT,))
    for reqs in burst_prompts + [stream_reqs, [sync_req, adapter_req], planted_streams]:
        want(reqs)
    rng = torch.Generator().manual_seed(9)  # fleet_cycle draws the bursts above again

    serve.shutdown()
    rt.shutdown()
    rt.init(system_config={**FLEET_SYSTEM_CONFIG, **RUNTIME_FLAGS})
    runtime_threads = set(threading.enumerate())
    plane = health.get_health_plane(create=True)  # stock rules, started
    log(f"phase 3f: the health plane's rules {[(r.name, r.expr) for r in plane.rules]}, "
        f"every {plane.period_s} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = memory_split("phase 3f start")
    # allocation sites of whatever the phase leaves on the card (the stacks
    # of the blocks allocated from here on)
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=200000)
    counted = dict.fromkeys(dispatch.launch_counts(), 0)
    seen = {}

    with BuildLaunches() as builds:
        def count(label: str) -> None:
            """Add the launches since the last reset, less the replica
            builds', to `counted`: each must come from a graph replay."""
            built = builds.since()
            eager = {k: n - built.get(k, 0) for k, n in dispatch.eager_launch_counts().items()
                     if n - built.get(k, 0)}
            log(f"{label}: eager launches of the port's kernels, replica builds left out: "
                f"{eager or 'none'}")
            if eager:
                fail(f"{label}: kernels launched outside graph replays: {eager}")
            for name, n in dispatch.launch_counts().items():
                counted[name] += n - built.get(name, 0)

        def note_replicas():
            ctrl = get_or_create_controller()
            for name in FLEET_DEPLOYMENTS.values():
                for h in rt.get(ctrl.get_replicas.remote(name), timeout=60)[0]:
                    seen[h._actor_id] = h

        t0 = time.monotonic()
        co = deploy_disagg("llama3-8b", {"prefill_replicas": 1, "decode_replicas": 1,
                                         "prefix_routing": False, "adapter_gossip_s": 0.0},
                           name="fleet", engine_config=ENGINE, params_fn=params_fn,
                           device=params["embed"].device.type)
        for role, name in FLEET_DEPLOYMENTS.items():
            wait_ready(name, 1, t0, "phase 3f")
        note_replicas()
        log(f"phase 3f: deploy_disagg built one prefill and one decode replica in "
            f"{time.monotonic() - t0:.1f} s (builds {[round(s, 1) for s in builds.seconds]} s); "
            f"card memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB ({card})")

        # the planted faults whose gates need no fleet of their own first
        caught = {}

        def private():
            """A plane of its own for a planted fleet: its alerts reach no
            other subscriber."""
            return health.HealthPlane(rules=[], metrics_fn=lambda: [], digests_fn=lambda: [])

        with fleet_fault("target_recorded_not_actuated"):
            own = private()
            pf = FleetController(co, dict(FLEET_CONFIG), deployments=FLEET_DEPLOYMENTS, plane=own)
            own.inject("queue_depth", {"role": "prefill"}, value=99.0)
            pf.evaluate_once()
            before = {w.key for w in co.workers("prefill")}
            new, waited = wait_new_replica(co, "prefill", before, pf, "phase 3f planted fault "
                                           "target_recorded_not_actuated")
            caught["target_recorded_not_actuated"] = new is None
            log(f"phase 3f planted fault target_recorded_not_actuated: fleet target "
                f"{pf.status()['targets']}, new replica {new is not None} after {waited:.1f} s")
            if new is not None:
                fail("phase 3f: its gate passes planted fault target_recorded_not_actuated")

        fleet = FleetController(co, dict(FLEET_CONFIG), deployments=FLEET_DEPLOYMENTS,
                                plane=plane)
        fleet.start()
        cycle1_at = len(fleet.actions)
        rem0 = remediations()
        resumes0 = registry.get("serve_fleet_resumes").get()

        # (a), cycle 1; the fleet steps the role down as soon as the
        # traffic stops, while (b) runs (the coordinator syncs at the
        # step-down, and a continuation that meets a retired replica opens
        # again: ROADMAP C13); (e) is read after (b)
        cyc1 = fleet_cycle(co, fleet, plane, builds, count, wants_by_prompt, cfg, rng,
                           "(a) cycle 1", card)
        note_replicas()
        peak_after_a = torch.cuda.max_memory_allocated()

        # (b) remediation with live resume, on the decode replica
        co._sync(force=True)
        victim = co.workers("decode")[0]
        dispatch.reset_launches()
        builds.reset()
        t_b = time.time()
        streams, threads, out = open_streams(co, [r["prompt_ids"] for r in stream_reqs],
                                             FLEET_STREAM_TOKENS)
        streams_at(out, FLEET_STREAM_HEAD)
        t_inject = time.monotonic()
        live = sum(len(o["tokens"]) < FLEET_STREAM_TOKENS for o in out)
        plane.inject("replica_fault", {"replica": str(victim.key)}, value=1.0,
                     expr="injected: a replica named by an alert")
        t_remediated = time.monotonic()
        for t in threads:
            t.join(FLEET_WAIT_S)
        t_rejoin = time.monotonic()
        while remediations()["rejoin"] - rem0["rejoin"] < 1:
            if time.monotonic() - t_rejoin > FLEET_WAIT_S:
                break
            time.sleep(0.05)
        count("phase 3f (b)")
        note_replicas()
        stages = {s: n - rem0[s] for s, n in remediations().items()}
        resumed = registry.get("serve_fleet_resumes").get() - resumes0
        gaps = [max((b - a for a, b in zip(o["at"], o["at"][1:])), default=0.0) for o in out]
        after = [sum(1 for at in o["at"] if at > t_inject) for o in out]
        log(f"phase 3f (b): {FLEET_STREAMS} streams of {FLEET_STREAM_TOKENS} tokens on decode "
            f"replica {victim.key}, {live} still decoding when the alert was injected (each "
            f"with {FLEET_STREAM_HEAD}+ tokens); the remediation took "
            f"{t_remediated - t_inject:.2f} s; remediation stages {stages}; resumes {resumed}; "
            f"tokens after the alert {after}; the longest gap between tokens per stream "
            f"{[round(g, 3) for g in gaps]} s (the resume blip: the replacement's build and the "
            f"continuation's prefill); errors {[o['error'] for o in out]} ({card})")
        resumed_at = [resume_point(s) for s in streams]
        conts = [{"prompt_ids": r["prompt_ids"] + o["tokens"][:k],
                  "max_tokens": FLEET_STREAM_TOKENS - k}
                 for r, o, k in zip(stream_reqs, out, resumed_at) if k]
        want(conts)  # the engine's own runs of the continuations, after the count
        if not resume_gate("phase 3f (b)", stream_reqs, out, streams, resumed_at,
                           wants_by_prompt, witness=lambda seq: forward_f32_plain(params, cfg,
                                                                                  seq)):
            fail("phase 3f (b): a stream is not the engine's own run up to its resume and "
                 "of its continuation after it, or leaves the uninterrupted run where the f32 "
                 "witness sees no tie")
        if stages != {"quarantine": 1, "drain": 1, "restart": 1, "rejoin": 1}:
            fail(f"phase 3f (b): remediation stages {stages}")
        # a stream whose last tokens the replica had already made (a decode
        # span's worth) finishes on them; every other one resumes
        if not resumed or resumed != sum(k > 0 for k in resumed_at):
            fail(f"phase 3f (b): {resumed} resumes, streams resumed after {resumed_at} tokens "
                 f"({live} decoding at the alert)")
        if any(w.key == victim.key for w in co.workers("decode")):
            fail("phase 3f (b): the remediated replica is back in the pick set")
        # C15: the resumed streams' prefill legs run on the one prefill
        # replica, one at a time, and drain long before a replica could be
        # built; at the default target_queue_depth they must not build one
        prefill_ups = [a for a in fleet.actions
                       if a["kind"] == "scale-up" and a["role"] == "prefill" and a["at"] >= t_b]
        log(f"phase 3f (b): prefill scale-up actions during the remediation and its resumes: "
            f"{prefill_ups} (target_queue_depth {fleet.cfg.target_queue_depth}); "
            f"{backlog_measure(co)}")
        if prefill_ups:
            fail(f"phase 3f (b): the fleet scaled the prefill role up during the resumes: "
                 f"{prefill_ups}")
        scale_down(co, fleet, "(e) cycle 1", seen, cycle1_at)
        mem1 = memory_split("phase 3f after cycle 1's retirement", mem0)

        # (c) sync_weights of phase 3's tree as version 1, over the replicas
        # the deployments hold now (the fleet may have stepped a role down
        # since the coordinator last synced: a request would sync it too)
        co._sync(force=True)
        dispatch.reset_launches()
        builds.reset()
        t0 = time.monotonic()
        synced = fleet.sync_weights(weights=params, version=1)
        sync_s = time.monotonic() - t0
        workers = co.workers("prefill") + co.workers("decode")
        versions = {str(w.key): replica_stats(w)["weights_version"] for w in workers}
        got_sync = co.generate(sync_req["prompt_ids"], max_tokens=sync_req["max_tokens"],
                               timeout_s=FLEET_WAIT_S)
        log(f"phase 3f (c): sync_weights over {len(workers)} replicas in {sync_s:.2f} s: "
            f"{synced['synced']}, failed {synced['failed']}; stats() weights_version {versions}")
        if synced["failed"] or set(versions.values()) != {1}:
            fail(f"phase 3f (c): replicas report weights_version {versions}")
        if not exact_gate("phase 3f (c) after the sync", [sync_req["prompt_ids"]], [got_sync],
                          [wants_by_prompt(sync_req)]):
            fail("phase 3f (c): the prompt's tokens changed across the sync")

        # (d) distribute_adapter, then a request naming it
        co._sync(force=True)
        out_d = fleet.distribute_adapter("fleet-lora", weights={"rank": 8, "seed": 0})
        residency = registry.get("serve_fleet_adapter_residency").get(
            tags={"adapter": "fleet-lora"})
        decode = co.workers("decode")
        hits0 = {str(w.key): replica_stats(w)["adapter_requests"].get("fleet-lora", 0)
                 for w in decode}
        got_ad = co.generate(adapter_req["prompt_ids"], max_tokens=adapter_req["max_tokens"],
                             adapter_id="fleet-lora", timeout_s=FLEET_WAIT_S)
        hits = {str(w.key): replica_stats(w)["adapter_requests"].get("fleet-lora", 0)
                - hits0[str(w.key)] for w in decode}
        resident = {k for k, v in co.adapter_residency().items() if "fleet-lora" in v}
        count("phase 3f (c)-(d)")
        log(f"phase 3f (d): distribute_adapter loaded {out_d['loaded']}, failed "
            f"{out_d['failed']}; serve_fleet_adapter_residency {residency} over {len(decode)} "
            f"decode replicas; the adapter's request reached {hits} (resident: {sorted(resident)})")
        if out_d["failed"] or residency != len(decode):
            fail(f"phase 3f (d): residency {residency} for {len(decode)} decode replicas")
        if sum(hits.values()) != 1 or not all(k in resident for k, v in hits.items() if v):
            fail(f"phase 3f (d): the adapter's request went to {hits}, resident {resident}")
        if not exact_gate("phase 3f (d) adapter request", [adapter_req["prompt_ids"]], [got_ad],
                          [wants_by_prompt(adapter_req)]):
            fail("phase 3f (d): the adapter-named request's tokens differ")

        # (a) and (e) again
        cycle2_at = len(fleet.actions)
        cyc2 = fleet_cycle(co, fleet, plane, builds, count, wants_by_prompt, cfg, rng,
                           "(a) cycle 2", card)
        note_replicas()
        scale_down(co, fleet, "(e) cycle 2", seen, cycle2_at)
        mem2 = memory_split("phase 3f after cycle 2's retirement", mem1)
        fleet.stop()
        grew = mem2["allocated"] - mem1["allocated"]
        log(f"phase 3f (e): card memory after cycle 1's retirement "
            f"{mem1['allocated'] / 2**30:.3f} GiB, after cycle 2's {mem2['allocated'] / 2**30:.3f} "
            f"GiB ({grew / 2**30:+.3f} GiB, tol {SERVE_RETIRED_MEMORY_TOL / 2**30:.2f}; between "
            f"them (b)'s replica was replaced and cycle 2's built and retired); "
            f"{mem0['allocated'] / 2**30:.3f} GiB at the phase's start ({card})")
        if abs(grew) > SERVE_RETIRED_MEMORY_TOL:
            fail(f"phase 3f (e): {grew / 2**30:+.3f} GiB between the two cycles' retirements")

        # the planted faults that need the fleet's replicas
        with fleet_fault("sync_reports_unsynced_replica"):
            pf = FleetController(co, dict(FLEET_CONFIG), deployments=FLEET_DEPLOYMENTS,
                                 plane=private())
            res = pf.sync_weights(weights=params, version=2)
            versions = {str(w.key): replica_stats(w)["weights_version"]
                        for w in co.workers("prefill") + co.workers("decode")}
            caught["sync_reports_unsynced_replica"] = (
                bool(res["failed"]) or set(versions.values()) != {2})
            log(f"phase 3f planted fault sync_reports_unsynced_replica: reported "
                f"{res['synced']}; stats() weights_version {versions}")
        with fleet_fault("restart_before_drain_without_resume"):
            own = private()
            pf = FleetController(co, dict(FLEET_CONFIG), deployments=FLEET_DEPLOYMENTS, plane=own)
            victim = co.workers("decode")[0]
            _s, threads, pout = open_streams(co, [r["prompt_ids"] for r in planted_streams],
                                             FLEET_STREAM_TOKENS)
            streams_at(pout, FLEET_STREAM_HEAD)
            own.inject("replica_fault", {"replica": str(victim.key)}, value=1.0)
            for t in threads:
                t.join(FLEET_WAIT_S)
            caught["restart_before_drain_without_resume"] = not resume_gate(
                "phase 3f planted fault restart_before_drain_without_resume", planted_streams,
                pout, _s, [resume_point(x) for x in _s], wants_by_prompt)
            log(f"phase 3f planted fault restart_before_drain_without_resume: streams' errors "
                f"{[o['error'] for o in pout]}, tokens {[len(o['tokens']) for o in pout]}")
        co.cfg.live_resume = True
        # the replacement's build ends before serve.shutdown(): a replica
        # killed in its __init__ goes on building after the runtime stops
        wait_ready(FLEET_DEPLOYMENTS["decode"], 1, time.monotonic(), "phase 3f")
        for name, hit in caught.items():
            if not hit:
                fail(f"phase 3f: its gate passes planted fault {name}")

        payload = rt.status(as_dict=True)
        hist = plane.history()
        rules = sorted({(a["rule"], a["state"]) for a in hist})
        log(f"phase 3f: status() nodes {len(payload['nodes'])}, alerts now "
            f"{[a['rule'] for a in payload['alerts']]}; the plane's history {rules}")
        for rule, state in (("queue_depth", "firing"), ("queue_depth", "resolved"),
                            ("replica_fault", "firing")):
            if (rule, state) not in rules:
                fail(f"phase 3f: the plane's history lacks {rule} {state}")
        peak = torch.cuda.max_memory_allocated()
        cyc1_figures = cyc1["figures"]
        co.close()
        del co, fleet, pf, own, victim, workers, decode, cyc1, cyc2, streams, _s
        t_down = time.monotonic()
        serve.shutdown()
        health.shutdown_health_plane()
        deadline = time.monotonic() + 15
        while True:
            left = [t.name for t in threading.enumerate()
                    if t not in runtime_threads and t.is_alive()]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        rt.shutdown()
    release()
    kept = torch.cuda.memory_allocated() - mem0["allocated"]
    left_snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    log(f"phase 3f: serve.shutdown() and the plane's stop took {time.monotonic() - t_down:.2f} s; "
        f"threads the phase started still alive after them: {left or 'none'}; peak card memory "
        f"{peak / 2**30:.2f} GiB (after (a) {peak_after_a / 2**30:.2f}; phase 3's server and "
        f"tensors included, {mem0['allocated'] / 2**30:.2f} GiB at the phase's start); left after "
        f"the phase {kept / 2**30:+.3f} GiB (tol {SERVE_RETIRED_MEMORY_TOL / 2**30:.2f} GiB), "
        f"allocated at: {sites_of_new_blocks(left_snapshot)} ({card})")
    del left_snapshot
    if left:
        fail(f"phase 3f: threads outlived serve.shutdown() and the plane's stop: {left}")
    if kept > SERVE_RETIRED_MEMORY_TOL:
        fail(f"phase 3f: {kept / 2**30:.3f} GiB stayed allocated after every replica retired")
    log(f"launches on the fleet path (the coordinator's requests of (a)-(d) in both cycles; "
        f"builds, the engine's own runs and planted runs not): {counted}")
    for name in SERVE_KERNELS:
        if counted[name] <= 0:
            fail(f"phase 3f never launched kernel {name}")
    log(f"phase 3f: cycle 1 burst {cyc1_figures}; phase 3g (b) {disagg_figures} ({card})")
    if BUILD_SAMPLER is not None:
        BUILD_SAMPLER.report("phase 3f --build-profile")
    log(f"phase 3f took {time.monotonic() - t_phase:.1f}s")
    return counted


def warm_runs_ab(server, card: str) -> None:
    """`--build-profile`: LLMServers over `server`'s tensors built directly
    (no runtime) with programs.WARM_RUNS 2, 1, 2, 1 in turns, each under
    its own ThreadSampler; each serves four greedy requests that must equal
    `server`'s runs of them, tokens and logprobs bit for bit."""
    from ray_tpu_torch.serve import LLMServer, programs

    cfg = server.engine.cfg
    reqs = fleet_requests(cfg, torch.Generator().manual_seed(5), n=4)
    want, _wall, errs = run_requests(server, [dict(r) for r in reqs])
    if errs:
        fail(f"warm-run A/B: {errs}")
    saved = programs.WARM_RUNS
    try:
        for warm in (2, 1, 2, 1):
            programs.WARM_RUNS = warm
            sampler = ThreadSampler()
            sampler.enter()
            t0 = time.monotonic()
            try:
                other = LLMServer._target(model_name="llama3-8b", engine_config=ENGINE,
                                          params_fn=lambda: (server.engine.params, cfg))
                torch.cuda.synchronize()
            finally:
                sampler.exit()
            built = time.monotonic() - t0
            got, _wall, errs = run_requests(other, [dict(r) for r in reqs])
            same = not errs and all(
                g["token_ids"] == w["token_ids"] and g["logprobs"] == w["logprobs"]
                for g, w in zip(got, want))
            log(f"warm-run A/B: WARM_RUNS {warm}: built directly in {built:.1f} s (capture "
                f"{other.engine.capture_stats['seconds']:.1f} s); four requests bit for bit "
                f"the first server's {same} ({card})")
            time.sleep(2 * ThreadSampler.SAMPLE_S)
            sampler.report(f"warm-run A/B: WARM_RUNS {warm}")
            other.shutdown()
            del other
            release()
            if not same:
                fail(f"warm-run A/B: WARM_RUNS {warm} changed the served tokens: {errs}")
    finally:
        programs.WARM_RUNS = saved


def fleet_only(card: str) -> None:
    """`--fleet`: phase 3's server and plain burst, then phase 3f on its
    tensors (no other phase, no result line). With --build-profile, phase
    3's build is sampled too, and warm_runs_ab runs before 3f."""
    sampler = ThreadSampler() if BUILD_SAMPLER is not None else None
    if sampler is not None:
        sampler.enter()
    server = new_server("phase 3: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    if sampler is not None:
        sampler.exit()
        time.sleep(2 * ThreadSampler.SAMPLE_S)
        sampler.report("phase 3's direct build --build-profile")
        warm_runs_ab(server, card)
    requests = burst_requests(server.engine.cfg, torch.Generator().manual_seed(1))
    results, wall, errors = run_requests(server, requests)
    if errors:
        fail(f"phase 3 burst: {errors}")
    fleet_path(server, card, "not run")
    server.shutdown()


# ------------------------------------------------------------- phase 3s

# The speculation gate. Speculative commits carry no logprobs, and on the
# card greedy tokens are not stable across batch shapes (the S-row verify
# GEMMs and the 1-row decode GEMMs round bf16 differently, and random
# weights give nearly flat logits), so neither phase 3's gate nor token
# equality with the plain run can be used. In their place, per greedy
# request: the port's own `forward` over prompt + output gives each output
# row's log-softmax, and the token's regret is (largest logprob of the row)
# - (logprob of the committed token): 0 where forward agrees that the token
# is the argmax, the size of the near-tie where bf16 rounding flipped it,
# and several nats where the engine committed a token the model does not
# favour. A burst is sound when every greedy request stays under both
# limits, and a fault is caught when any request of its burst exceeds one.
# On the H100 the 14 greedy requests of the three sound runs read at most
# mean 0.017 and max 0.20; the weakest planted fault (the verify mask one
# key short) read mean 1.81 and max 5.58 on its clearest request, and above
# the mean limit on 3 of its 5 (PERF.md). The limits sit near the geometric
# middles, 0.18 and 1.06.
SPEC_REGRET_TOL = {"max": 1.0, "mean": 0.15}
# committed tokens per slot per decode iteration in draft mode, k = 4: the
# plain path's is at most 1; self-speculation read 2.58 at an acceptance
# of 0.90 on the H100 (PERF.md). The floor leaves room for more bf16
# disagreement between the 1-row draft step and the S-row verify.
SPEC_TOKENS_PER_STEP_MIN = 1.5


def _mask_one_key_short(f):
    """K7 attends row s over keys 0..p+s-1: every row misses its own key."""
    def verify(q, kp, vp, tables, positions):
        return f(q, kp, vp, tables, (positions - 1).clamp(min=0))
    return verify


def _span_kv_one_late(f):
    """The span's KV lands one position late (rope and queries stay)."""
    def indices(self, positions, S, tables, n_draft):
        rope_pos, _page, _slot = f(self, positions, S, tables, n_draft)
        _rope, page_idx, slot_idx = f(self, positions + 1, S, tables, n_draft)
        return rope_pos, page_idx, slot_idx
    return indices


def _accept_every_draft(f):
    """Accept/commit sees logits that put all mass on each draft."""
    def accept(logits, tokens, n_draft, *rest):
        forced = logits.clone()
        forced[:, :-1].scatter_(2, tokens[:, 1:].long()[:, :, None], 1e4)
        return f(forced, tokens, n_draft, *rest)
    return accept


# Speculation faults the regret gate must catch:
# name -> (module or class holding the attribute, attribute, wrapper maker,
# whether it needs the server with the distinct two-layer draft)
def spec_faults():
    from ray_tpu_torch.serve import programs, spec_decode

    return {
        "verify_mask_one_key_short": (programs, "paged_attention_verify",
                                      _mask_one_key_short, False),
        "span_kv_one_position_late": (programs.PagedModel, "_span_indices",
                                      _span_kv_one_late, False),
        "accept_every_draft": (spec_decode, "_accept_commit", _accept_every_draft, True),
    }


def spec_regrets(params, cfg, requests, results) -> list:
    """Per greedy request, (max, mean, share of tokens that are not forward's
    argmax) of the regret of its output tokens under the port's forward."""
    from ray_tpu_torch.models import transformer

    out = []
    for req, res in zip(requests, results):
        if req.get("temperature", 0.0) > 0:
            continue
        seq = req["prompt_ids"] + res["token_ids"]
        T = len(req["prompt_ids"])
        toks = torch.tensor([seq[:-1]], device="cuda")
        picked = torch.tensor(res["token_ids"], device="cuda")[:, None]
        with torch.no_grad():
            logits, _ = transformer.forward(params, toks, cfg)
        lp = torch.log_softmax(logits[0, T - 1:], dim=-1)
        regret = lp.max(dim=-1).values - lp.gather(1, picked)[:, 0]
        if not torch.isfinite(regret).all():
            fail("speculation gate: non-finite logprobs")
        out.append((regret.max().item(), regret.mean().item(),
                    (regret > 0).float().mean().item()))
    return out


def within_regret_tol(r) -> bool:
    return r[0] <= SPEC_REGRET_TOL["max"] and r[1] <= SPEC_REGRET_TOL["mean"]


def fmt_regrets(regrets) -> str:
    return (f"max {[round(r[0], 4) for r in regrets]} mean {[round(r[1], 4) for r in regrets]} "
            f"not-argmax share {[round(r[2], 3) for r in regrets]}")


def spec_counters(engine) -> dict:
    """The engine's running speculation totals, to take differences of."""
    spec = engine._spec
    return {"proposed": spec.proposed_total, "accepted": spec.accepted_total,
            "committed": engine._tps_committed, "steps": engine._tps_steps,
            **{f"s:{k}": v for k, v in spec.phase_seconds.items()}}


def spec_report(label: str, engine, since: dict) -> float:
    """Acceptance, tokens per decode step and the round's host wall split
    since the counters `since`; returns the tokens per decode step."""
    now = spec_counters(engine)
    d = {k: v - since.get(k, 0) for k, v in now.items()}
    rounds = max(1, int(d.pop("s:rounds", 0)))
    split = " ".join(f"{k[2:]} {1e3 * v / rounds:.2f}" for k, v in sorted(d.items())
                     if k.startswith("s:"))
    per_step = d["committed"] / max(1, d["steps"])
    log(f"{label}: proposed {d['proposed']} accepted {d['accepted']} acceptance "
        f"{d['accepted'] / max(1, d['proposed']):.4f}, tokens per decode step "
        f"{per_step:.4f}; {rounds} verify rounds, host wall per round, ms: {split}")
    return per_step


# nats: a replayed decode span's logprobs against its eager body's on the
# same inputs. The same kernels run in the same order, so they should
# agree exactly; the limit only leaves room for a library that picks
# another algorithm under capture (a bf16 rounding difference in one GEMM
# moves a logprob by ~1e-3). The prefill and chunk programs' f32 logits
# are held to the same number.
GRAPH_LOGPROB_TOL = 5e-3


def _batch_inputs(engine, seed: int):
    """Host arrays at the burst's batch shape: tokens, positions spread over
    20..900, and page tables as the allocator would give them: each slot
    its own pages of the pool, drawn at random, as far as a span of up to
    32 rows past its position reaches; the rest of the row the trash page."""
    import numpy as np

    ecfg = engine.ecfg
    B, pps, ps = ecfg.max_batch_size, ecfg.pages_per_seq, ecfg.page_size
    rs = np.random.RandomState(seed)
    positions = np.linspace(20, 900, B).astype(np.int32)
    free = list(rs.permutation(np.arange(1, ecfg.max_pages)))
    tables = np.zeros((B, pps), np.int32)
    for b, p in enumerate(positions):
        n = min(pps, (int(p) + 32) // ps + 1)
        tables[b, :n], free = free[:n], free[n:]
    return rs.randint(1, engine.cfg.vocab_size, (B,)).astype(np.int32), positions, tables


def prefill_graph_checks(engine) -> None:
    """The prefill thread's and the chunk programs of an idle speculative
    engine against their eager bodies: the bucketed prefill at every
    bucket (tier 1), the engine's chunk at start 0 and at start 512 and, in
    draft mode, the draft's chunk. A replay, then the body on the program's static inputs:
    the pages the program writes must be bit-identical after both (each
    rewrites them with the same values; the chunk attends over a prefix
    neither changes) and the f32 logits within GRAPH_LOGPROB_TOL. A
    profiler sees K2 and K6 by name inside replays."""
    import numpy as np

    from ray_tpu_torch.ops import attention, paged_attention as paged

    ecfg, spec, model = engine.ecfg, engine._spec, engine._model
    pps, ps, C = ecfg.pages_per_seq, ecfg.page_size, ecfg.prefill_chunk
    rs = np.random.RandomState(6)
    table = rs.permutation(np.arange(1, ecfg.max_pages))[:pps].astype(np.int32)

    def written(pools, ids):
        return [p[:, :, torch.as_tensor(ids, device=p.device).long()].clone() for p in pools]

    def against_eager(label, key, replay, pools, ids):
        got = replay()
        kv = written(pools, ids)
        program = engine._program(key)
        want = [t.float().cpu().numpy() for t in program.fn(*program.inputs)]
        same = all(torch.equal(a, b) for a, b in zip(kv, written(pools, ids)))
        gap = float(np.abs(got - want[0].reshape(got.shape)).max()) if got is not None else 0.0
        log(f"graph {label}: pages {len(ids)} bit-identical to the eager body's {same}, "
            f"logits max |replay - eager| {gap:.3e} (tol {GRAPH_LOGPROB_TOL})")
        if not (same and gap <= GRAPH_LOGPROB_TOL):
            fail(f"the {label} graph disagrees with its eager body")

    for bucket in ecfg.prefill_buckets:
        T = bucket - 3
        n = min(pps, -(-(T + 32) // ps))
        tables = np.zeros((1, pps), np.int32)
        tables[0, :n] = table[:n]
        toks = rs.randint(1, engine.cfg.vocab_size, (1, bucket)).astype(np.int32)
        lens = np.array([T], np.int32)
        against_eager(f"prefill bucket {bucket} (tier 1, true length {T}, {n} pages)",
                      ("prefill", bucket, 1), lambda: engine._prefill(toks, lens, tables)[0],
                      (model.k_pages, model.v_pages), table[:n])
    for start in (0, 512):
        toks = rs.randint(1, engine.cfg.vocab_size, (C,)).astype(np.int32)
        ids = table[start // ps:(start + C) // ps]
        against_eager(f"chunk C={C} start {start}", ("chunk", C),
                      lambda: engine._chunk_step(toks, start, table, C - 1)[0],
                      (model.k_pages, model.v_pages), ids)
    draft = spec.proposer
    if engine.ecfg.speculation.mode == "ngram":  # no draft model, no draft chunk
        draft = None
    elif getattr(draft, "model", None) is None:
        fail("a draft-mode engine has no draft model: the draft chunk is not checked")
    dtable = None if draft is None else draft._tables[2]  # slot 2's draft pages
    dtoks = torch.as_tensor(rs.randint(1, engine.cfg.vocab_size, (C,)).astype(np.int32))
    if draft is not None:
        draft_chunk = engine._program(("draft_chunk", C))

        def draft_replay():
            draft_chunk(dtoks, torch.zeros((1,), dtype=torch.int32), dtable)  # no outputs

        against_eager(f"draft chunk C={C} start 0", ("draft_chunk", C), draft_replay,
                      (draft.model.k_pages, draft.model.v_pages), dtable[:C // ps].cpu().numpy())

    bucket = ecfg.prefill_buckets[0]
    toks = rs.randint(1, engine.cfg.vocab_size, (1, bucket)).astype(np.int32)
    names = launched_kernels(lambda: engine._prefill(toks, np.array([bucket], np.int32),
                                                     np.zeros((1, pps), np.int32)))
    require_kernels("a prefill replay", names,
                    (attention.kernel_symbol("flash_attention", torch.bfloat16, 128),
                     "rms_norm_fwd_"))
    names = launched_kernels(lambda: engine._chunk_step(np.zeros((C,), np.int32), 512, table,
                                                        C - 1))
    require_kernels("a chunk replay", names,
                    (paged.kernel_symbol("paged_attention_chunk", torch.bfloat16, 128),))


def graph_checks(engine) -> None:
    """The captured programs of an idle speculative engine (threads
    stopped) against their eager bodies (llama3-8b in draft mode, phase
    3s; moe-1b in ngram mode, phase 5, which has no propose and no draft
    chunk): a replay, then the body on the program's static inputs (which
    still hold the replay's inputs; greedy bodies rewrite the same KV with
    the same values before any query reads it). Gates: the decode span's
    tokens identical and its logprobs within GRAPH_LOGPROB_TOL, the
    verify's commits and (draft mode) the propose's drafts identical; the
    prefill and chunk programs as prefill_graph_checks says; two sampled replays of the same inputs differ (the engine's
    generator is registered with the graphs); every program's launches per
    replay equal its eager body's; a profiler sees K1, K2, K5, K6 and K7 by
    name inside replays."""
    import numpy as np

    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.ops import paged_attention as paged

    ecfg, spec = engine.ecfg, engine._spec
    B, k, n = ecfg.max_batch_size, spec.k, ecfg.decode_span
    tokens, positions, tables = _batch_inputs(engine, 3)
    zeros_f, ones_f = np.zeros((B,), np.float32), np.ones((B,), np.float32)
    zeros_i = np.zeros((B,), np.int32)

    seq, logps = engine._decode_span(n, tokens, positions, tables, zeros_f, ones_f, zeros_i,
                                     False)
    program = engine._program(("decode", n, False, False))
    want_seq, want_logps = (t.cpu().numpy() for t in program.fn(*program.inputs))
    gap = float(np.abs(logps - want_logps).max())
    log(f"graph decode span n={n}: tokens equal to the eager body's "
        f"{int((seq == want_seq).sum())}/{seq.size}, logprob max |replay - eager| {gap:.3e} "
        f"(tol {GRAPH_LOGPROB_TOL})")
    if not np.array_equal(seq, want_seq) or not gap <= GRAPH_LOGPROB_TOL:
        fail("the decode span graph disagrees with its eager body")

    mode = engine.ecfg.speculation.mode
    if mode != "ngram" and getattr(spec.proposer, "model", None) is None:
        fail(f"a {mode}-mode engine has no draft model: its propose is not checked")
    if mode != "ngram":  # draft mode: the propose
        drafts = spec.proposer._dispatch(engine, tokens, tokens, positions).clone()
        program = engine._program(("propose",))
        want = program.fn(*program.inputs)[0]
        log(f"graph propose: drafts equal to the eager body's {int((drafts == want).sum())}/"
            f"{drafts.numel()}")
        if not torch.equal(drafts, want):
            fail("the propose graph disagrees with its eager body")

    # row 0 is the span's first fed token, the first draft its greedy
    # successor, the rest random
    rs = np.random.RandomState(4)
    toks_bs = torch.as_tensor(rs.randint(1, engine.cfg.vocab_size, (B, k + 1)).astype(np.int32))
    toks_bs[:, 0] = torch.as_tensor(tokens)
    toks_bs[:, 1] = torch.as_tensor(want_seq[0])
    verify_in = [toks_bs] + [torch.as_tensor(a) for a in (
        positions, tables, np.full((B,), k, np.int32), zeros_f, ones_f, zeros_i)]
    committed, n_comm = (t.clone() for t in spec._verify(*verify_in, advanced=False,
                                                        sample=False))
    program = engine._program(("verify", k + 1, False, False))
    want_c, want_n = program.fn(*program.inputs)
    log(f"graph verify S={k + 1}: commits equal to the eager body's "
        f"{int((committed == want_c).sum())}/{committed.numel()}, counts "
        f"{n_comm.tolist()} vs {want_n.tolist()}")
    if not (torch.equal(committed, want_c) and torch.equal(n_comm, want_n)):
        fail("the verify graph disagrees with its eager body")

    # sampled replays draw fresh numbers
    for top_p, advanced in ((1.0, False), (0.9, True)):
        draws = [engine._decode_span(n, tokens, positions, tables, ones_f,
                                     np.full((B,), top_p, np.float32), zeros_i, advanced)[0]
                 for _ in range(2)]
        same = int((draws[0] == draws[1]).sum())
        log(f"graph decode span n={n} sampled (top_p {top_p}): two replays on the same "
            f"inputs agree on {same}/{draws[0].size} tokens")
        if same == draws[0].size:
            fail("two sampled decode-span replays drew the same tokens")
    verify_in[4] = torch.as_tensor(ones_f)
    rounds = [spec._verify(*verify_in, advanced=False, sample=True)[0].clone() for _ in range(2)]
    log(f"graph verify S={k + 1} sampled: two replays agree on "
        f"{int((rounds[0] == rounds[1]).sum())}/{rounds[0].numel()} committed entries")
    if torch.equal(rounds[0], rounds[1]):
        fail("two sampled verify replays committed the same tokens")

    # launches per replay equal the eager body's, program by program
    for key, program in sorted(engine._programs.items(), key=str):
        dispatch.reset_launches()
        program.fn(*program.inputs)
        eager = {name: c for name, c in dispatch.launch_counts().items() if c}
        dispatch.reset_launches()
        program(*program.inputs)
        torch.cuda.synchronize()
        replayed = {name: c for name, c in dispatch.launch_counts().items() if c}
        if not (replayed == eager == program.launches):
            fail(f"program {key}: launches per replay {replayed} (recorded "
                 f"{program.launches}), eager body {eager}")
    log(f"graph launches: every one of {len(engine._programs)} programs counts per replay "
        f"what its eager body launches (decode span n={n}: "
        f"{engine._program(('decode', n, False, False)).launches})")

    # the profiler sees the kernels inside replays
    names = launched_kernels(lambda: engine._decode_span(
        n, tokens, positions, tables, zeros_f, ones_f, zeros_i, False))
    require_kernels("a decode span replay", names,
                    ("rms_norm_fwd_vec_kernel", "paged_decode_split_kernel",
                     "paged_combine_kernel"))
    names = launched_kernels(lambda: spec._verify(*verify_in, advanced=False, sample=False))
    require_kernels("a verify replay", names,
                    (paged.kernel_symbol("paged_attention_verify", torch.bfloat16, 128),))
    prefill_graph_checks(engine)


def round_vs_step(engine) -> float:
    """A decode step, a decode span of decode_span steps, the verify at
    every width S = 2..k+1 and the draft propose, each replayed (one graph
    launch) and run as its eager body, on an idle draft-mode engine at the
    burst's batch shape: the host's enqueue (until the call returns), host
    wall with a synchronise after each call and device time (first to last
    kernel, by CUDA events), median of 5. Fits the span picker's cost
    model, t(S) = c (ALPHA + S) with the decode step as S = 1, to the
    replays' device times by least squares, and returns the fitted ALPHA."""
    import numpy as np

    ecfg, spec = engine.ecfg, engine._spec
    B, k, n = ecfg.max_batch_size, spec.k, ecfg.decode_span
    engine._capture_programs(spans=[1])  # threads stopped: a capture is allowed
    tokens, positions, tables = _batch_inputs(engine, 0)
    rs = np.random.RandomState(1)
    zeros_f, ones_f = np.zeros((B,), np.float32), np.ones((B,), np.float32)
    zeros_i = np.zeros((B,), np.int32)
    host = [torch.as_tensor(a) for a in (tokens, positions, tables, zeros_f, ones_f, zeros_i)]
    calls = {"decode step": (("decode", 1, False, False), host),
             f"decode span n={n}": (("decode", n, False, False), host)}
    for S in range(2, k + 2):
        toks_bs = torch.as_tensor(rs.randint(1, engine.cfg.vocab_size, (B, S)).astype(np.int32))
        calls[f"verify round S={S}"] = (("verify", S, False, False), [
            toks_bs, host[1], host[2], torch.full((B,), S - 1, dtype=torch.int32), host[3],
            host[4], host[5]])
    calls[f"propose k={k} (catch-up + {k} draft steps)"] = (("propose",),
                                                           [host[0], host[0], host[1]])

    def timed(call):
        call()
        torch.cuda.synchronize()
        enqueues, walls, devs = [], [], []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            call()
            b.record()
            enqueues.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            devs.append(a.elapsed_time(b))
        return [statistics.median(x) for x in (enqueues, walls, devs)]

    replay_dev = {}
    for name, (key, args) in calls.items():
        program = engine._program(key)
        enq_g, wall_g, dev_g = timed(lambda: program(*args))
        enq_e, wall_e, dev_e = timed(lambda: program.fn(*program.inputs))
        replay_dev[key] = dev_g
        log(f"  {name}: graph replay enqueue {enq_g:.3f} ms, host wall {wall_g:.3f} ms, device "
            f"{dev_g:.3f} ms; eager body enqueue {enq_e:.3f} ms, host wall {wall_e:.3f} ms, "
            f"device {dev_e:.3f} ms (median of 5, B={B}, positions 20..900)")
    xs = [1.0] + [float(S) for S in range(2, k + 2)]
    ys = [replay_dev[("decode", 1, False, False)]] + [
        replay_dev[("verify", S, False, False)] for S in range(2, k + 2)]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    intercept = my - slope * mx
    alpha = intercept / slope if slope > 0 else float("inf")
    log(f"  span cost fit, device ms = {intercept:.4f} + {slope:.4f} S over S = 1 (decode "
        f"step) .. {k + 1}: ALPHA = {alpha:.2f} (the picker's _SPAN_ALPHA is "
        f"{type(spec)._SPAN_ALPHA})")
    return alpha


def planted_prompt(server, draw, n: int) -> list:
    """A prompt of n tokens in which the n-gram proposer has something to
    find: draw(n) with one token somewhere in its middle replaced by the
    first token the server generates for it, where that edit leaves the
    first token as it was. Found by serving: with random weights a token
    in the middle of 100+ often does not move the argmax (the token at
    position 0 moves everything), but a prompt whose two best tokens lie
    close is moved by any edit, and then another prompt is drawn. When it
    holds too, the four tokens after the planted one become the next four
    the server generates, so that the drafts are right."""
    def generated(p, count):
        return server({"prompt_ids": p, "max_tokens": count})["token_ids"]

    places = sorted(range(n // 5, 4 * n // 5, max(1, n // 12)), key=lambda i: abs(i - n // 2))
    for _ in range(8):
        prompt = draw(n)
        tok = generated(prompt, 1)[0]
        for at in places:
            planted_one = prompt[:at] + [tok] + prompt[at + 1:]
            if generated(planted_one, 1)[0] != tok:
                continue
            block = generated(planted_one, 5)
            planted_five = prompt[:at] + block + prompt[at + 5:]
            return planted_five if generated(planted_five, 1)[0] == block[0] else planted_one
    fail(f"planted_prompt: no edit of 8 prompts of {n} tokens kept the first output token")


def spec_main_path(card: str, profile: bool, served: dict) -> dict:
    """The speculation path on phase 3's parameters; returns the launch
    counts of its two sound runs (draft, then ngram), summed, and the span
    cost fit of round_vs_step."""
    from ray_tpu_torch.ops import dispatch

    params, cfg = served["params"], served["cfg"]
    base_requests, base_results = served["requests"], served["results"]
    L = cfg.n_layers
    rng = torch.Generator().manual_seed(2)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    def fresh_burst():
        return [{"prompt_ids": prompt(n), "max_tokens": 32} for n in (23, 100, 200, 700, 50)]

    def server_for(spec, label="", **kwargs):
        return new_server(f"phase 3s: LLMServer llama3-8b speculation {spec}{label}",
                          params_fn=lambda: (params, cfg),
                          engine_config=dict(ENGINE, speculation=spec), **kwargs)

    def burst(server, label, requests):
        results, wall, errors = run_requests(server, requests)
        if errors:
            server.shutdown()
            fail(f"{label}: {errors}")
        return results, wall

    def faulted_burst(name, spec, **kwargs):
        """A fresh burst on a server built inside the fault's block: the
        fault is captured into the graphs it must spoil."""
        holder, attr, make, _distinct = faults[name]
        reqs = fresh_burst()
        with planted(holder, (attr, make)):
            server = server_for(spec, f", planted fault {name}", **kwargs)
            res, _wall = burst(server, f"planted fault {name}", reqs)
            server.shutdown()
        del server
        release()
        faulted.append((name, reqs, res))

    faults = spec_faults()
    gated = []   # (label, requests, results) the gate must pass
    faulted = []  # (name, requests, results) the gate must fail
    total = {name: 0 for name in dispatch.KERNELS}

    # (1) draft mode, self-speculation: phase 3's prompts, all greedy
    draft = {"mode": "draft", "num_speculative_tokens": 4}
    server = server_for(draft)
    requests = [{"prompt_ids": r["prompt_ids"], "max_tokens": 32} for r in base_requests]
    since = spec_counters(server.engine)
    dispatch.reset_launches()
    with PrefillClock(server.engine) as clock:
        results, wall = burst(server, "draft", requests)
    launches = dispatch.launch_counts()
    log(f"launches on the speculation path, draft mode: {launches}")
    require_no_eager_launches("speculation path, draft mode")
    clock.report("draft")
    for name in SPEC_KERNELS:
        if launches[name] <= 0:
            fail(f"speculation path (draft) never launched kernel {name}")
    if launches["paged_attention_verify"] % L:
        fail(f"K7 ran {launches['paged_attention_verify']} times, not a multiple of {L} layers")
    for name in total:
        total[name] += launches[name]
    report_burst("draft", requests, results, wall)
    per_step = spec_report("draft", server.engine, since)
    if not per_step > SPEC_TOKENS_PER_STEP_MIN:
        fail(f"draft mode committed {per_step:.3f} tokens per decode step, "
             f"floor {SPEC_TOKENS_PER_STEP_MIN}")
    same = [sum(a == b for a, b in zip(r["token_ids"], p["token_ids"]))
            for r, p in zip(results[:4], base_results[:4])]
    log(f"draft: tokens equal to the plain run's, per greedy request of 32: {same} "
        f"(bf16 rounds differently across batch shapes: reported, not gated)")
    gated.append(("draft", requests, results))
    if profile:
        def profiled():
            reqs = fresh_burst()
            _res, wall = burst(server, "profiled draft", reqs)
            return wall

        before = dispatch.launch_counts()["paged_attention_verify"]
        seen = profile_report(profiled)
        rounds = (dispatch.launch_counts()["paged_attention_verify"] - before) // L
        log(f"profiled draft burst: {rounds} verify rounds, {seen['kernels'] / max(1, rounds):.0f} "
            f"kernels run per round and {sum(seen['api'].values()) / max(1, rounds):.1f} host "
            f"launch calls per round ({seen['api']}; its propose, and the burst's prefills, "
            f"included)")
        require_kernels("profiled draft burst (K1, K5 and K7 inside graph replays)",
                        seen["names"], ("rms_norm_fwd_", "paged_decode_split_kernel",
                                        "paged_verify_wgmma_kernel"))
    server.shutdown()
    log(f"the captured programs against their eager bodies ({card}):")
    graph_checks(server.engine)
    log(f"replays and eager bodies: a decode step, a verify round and a propose ({card}):")
    alpha = round_vs_step(server.engine)
    del server
    release()
    for name, (_holder, _attr, _make, distinct) in faults.items():
        if not distinct:
            faulted_burst(name, draft)

    # (2) ngram mode. A model with random weights emits tokens that are
    # nowhere in a random prompt, so the suffix lookup would never draft.
    # Three prompts are therefore planted (planted_prompt): their own first
    # output token sits in the middle of the prompt, so the first round
    # drafts what follows it there. Beside them a short pattern repeated, a
    # random prompt (no draft anywhere: the plain span), and one sampled
    # request (while it is in the batch, rounds run the top-k/top-p verify).
    server = server_for({"mode": "ngram", "num_speculative_tokens": 4})
    requests = [{"prompt_ids": planted_prompt(server, prompt, n), "max_tokens": 32}
                for n in (100, 150, 200)]
    requests += [
        {"prompt_ids": prompt(8) * 12, "max_tokens": 32},
        {"prompt_ids": prompt(60), "max_tokens": 32},
        {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9},
    ]
    since = spec_counters(server.engine)  # the planting served requests too
    dispatch.reset_launches()
    results, wall = burst(server, "ngram", requests)
    launches = dispatch.launch_counts()
    log(f"launches on the speculation path, ngram mode: {launches}")
    require_no_eager_launches("speculation path, ngram mode")
    report_burst("ngram", requests, results, wall)
    spec_report("ngram", server.engine, since)
    for name in ("paged_attention_verify", "paged_attention_decode"):
        if launches[name] <= 0:
            fail(f"speculation path (ngram) never launched kernel {name}")
    for name in total:
        total[name] += launches[name]
    gated.append(("ngram", requests, results))
    server.shutdown()
    del server
    release()

    # (3) a distinct draft (the same widths, two layers, its own random
    # weights): nearly every draft is rejected, so the sound run commits the
    # verify forward's own tokens, and the planted fault commits the draft's.
    # The fault's server takes the same draft weights (draft_params_fn).
    distinct = {"mode": "draft", "num_speculative_tokens": 4,
                "draft_model": "llama3-8b", "draft_model_overrides": {"n_layers": 2}}
    server = server_for(distinct)
    draft_params = server.engine._spec.proposer.model.params
    requests = fresh_burst()
    since = spec_counters(server.engine)
    results, wall = burst(server, "distinct draft", requests)
    report_burst("distinct draft", requests, results, wall)
    spec_report("distinct draft", server.engine, since)
    gated.append(("distinct draft", requests, results))
    server.shutdown()
    del server
    release()
    for name, (_holder, _attr, _make, is_distinct) in faults.items():
        if is_distinct:
            faulted_burst(name, distinct, draft_params_fn=lambda: draft_params)
    del draft_params
    release()

    # the gate: passes every sound run, fails every planted fault
    sound = [(label, spec_regrets(params, cfg, reqs, res)) for label, reqs, res in gated]
    for label, regrets in sound:
        log(f"speculation gate, {label} (limit {SPEC_REGRET_TOL}): {fmt_regrets(regrets)}")
    caught = {}
    for name, reqs, res in faulted:
        regrets = spec_regrets(params, cfg, reqs, res)
        caught[name] = any(not within_regret_tol(r) for r in regrets)
        log(f"speculation gate, planted fault {name}: {fmt_regrets(regrets)}")
    for label, regrets in sound:
        for i, r in enumerate(regrets):
            if not within_regret_tol(r):
                fail(f"{label} greedy request {i}: regret max {r[0]:.4f} mean {r[1]:.4f} "
                     f"under the forward (limit {SPEC_REGRET_TOL})")
    for name, hit in caught.items():
        if not hit:
            fail(f"the speculation gate {SPEC_REGRET_TOL} passes planted fault {name}")
    return {"launches": total, "span_alpha_fit": alpha}


# -------------------------------------------------------------- phase 5

# The MoE serving gate. A server at the registered capacity factor (1.25)
# drops tokens wherever an expert's slots run out, and how many depends on
# the shape a program routes at: the engine routes a prefill at its bucket,
# decode one token per sequence, a chunk at its C rows, while `forward`
# over prompt + output routes the whole sequence at once. The two drop
# different tokens, so a sound engine could fail phase 3's gate. The gate
# therefore runs on a second moe-1b server over the same weights whose
# config sets capacity_factor = num_experts / num_selected_experts: then an
# expert's capacity is at least T, no token drops in any program or in
# `forward`, and the engine is held against `forward` under that config
# (the drop semantics themselves are held against the reference engine on
# the CPU, tests/test_torch_moe.py). Each planted MoE fault (MOE_FAULTS) is
# served by a no-drop server built inside its block and must fail it. On
# the H100 the sound burst read per request means 0.011-0.062 and maxima
# up to 0.452 (the sampled request), and the weakest fault (softmax over
# all experts) means 0.38-1.17 and maxima 1.04-2.46 (PERF.md §6);
# phase 3's limits would leave the sound maximum 10 % under its limit.
# The limits sit near the geometric middles of the sound run's worst and
# the weakest fault's worst request: sqrt(0.062 * 1.17) and
# sqrt(0.452 * 2.46).
MOE_LOGPROB_TOL = {"max": 1.0, "mean": 0.25}


def _softmax_over_all(f):
    """Gate weights from a softmax over all E router logits, not over the
    k selected ones."""
    def gating(logits, k):
        _w, ids = f(logits, k)
        return torch.softmax(logits, dim=-1).gather(-1, ids), ids
    return gating


def _second_weight_to_first(f):
    """The second choice's weight is given to the first: the first choice
    weighs w1 + w2, the second 0."""
    def gating(logits, k):
        w, ids = f(logits, k)
        return torch.cat([w[..., :1] + w[..., 1:2], torch.zeros_like(w[..., 1:])], dim=-1), ids
    return gating


def _next_slot(f):
    """The combine reads each assignment's output one capacity slot on:
    another token's output of the same expert."""
    def combine(y, slot_of, coef, k):
        return f(y, (slot_of + 1) % y.shape[1], coef, k)
    return combine


# planted on ray_tpu_torch.models.transformer: name -> (attribute, maker)
MOE_FAULTS = {
    "softmax_over_all_experts": ("top_k_gating", _softmax_over_all),
    "second_weight_to_first": ("top_k_gating", _second_weight_to_first),
    "combine_reads_next_slot": ("_moe_combine", _next_slot),
}


def within_moe_tol(gap) -> bool:
    return gap[0] <= MOE_LOGPROB_TOL["max"] and gap[1] <= MOE_LOGPROB_TOL["mean"]


def decode_step_figures(engine, card: str) -> None:
    """A decode span replayed on the idle engine at the burst's batch shape
    (median of 5, device time by CUDA events, per step), beside the step's
    byte bound: every weight the step reads once (the layers' and the final
    norm's in bf16, the engine's f32 head) over 3.35 TB/s."""
    import numpy as np

    B, n = engine.ecfg.max_batch_size, engine.ecfg.decode_span
    tokens, positions, tables = _batch_inputs(engine, 0)
    host = [torch.as_tensor(a) for a in (tokens, positions, tables, np.zeros((B,), np.float32),
                                         np.ones((B,), np.float32), np.zeros((B,), np.int32))]
    program = engine._program(("decode", n, False, False))
    program(*host)
    torch.cuda.synchronize()
    devs = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        program(*host)
        b.record()
        b.synchronize()
        devs.append(a.elapsed_time(b) / n)
    params, model = engine.params, engine._model
    weights = sum(t.numel() * t.element_size() for _, t in named_leaves(params["layers"]))
    weights += params["final_norm"].numel() * params["final_norm"].element_size()
    weights += model.head32.numel() * model.head32.element_size()
    bound = weights / HBM_BYTES_S * 1e3
    log(f"moe-1b decode step (span of {n} replayed, B={B}, positions 20..900): "
        f"{statistics.median(devs):.4f} ms a step on the card (median of 5); byte bound "
        f"{bound:.4f} ms ({weights / 1e9:.3f} GB of weights read once: the layers' and the "
        f"norm's bf16 and the f32 head, over 3.35 TB/s); {card}")


def moe_live_update(server, card: str) -> dict:
    """Phase 5's live update from a host tree: the seed-1 moe-1b weights as
    numpy float32, staged onto the card on a side stream and cast to bf16
    while two streams decode; then two fresh prompts on the updated server
    and on a fresh engine over the same weights must agree exactly, and the
    seed-0 weights come back bit for bit. Returns the launch counts of the
    update and the gate."""
    from ray_tpu_torch.models import init_params, params_from_numpy
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    engine = server.engine
    cfg, label = engine.cfg, "phase 5: moe-1b live update"
    rng = torch.Generator().manual_seed(12)  # its own: phase 5's other prompts stay as they were

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    sums0 = leaf_checksums(engine.params)
    host = host_tree(init_params(cfg, seed=1, device="cuda", dtype="float32"))
    release()
    nbytes = sum(a.nbytes for _, a in named_leaves(host))
    fresh = InferenceEngine(params_from_numpy(host, device="cuda", dtype=cfg.dtype), cfg,
                            EngineConfig(**ENGINE))
    fresh.warmup()
    # the fresh engine answers first: the launch counts hold the server's alone
    ps = [prompt(200), prompt(700)]
    want = [fresh.generate(p, max_tokens=32) for p in ps]
    alone = live_streams(engine, [prompt(100), prompt(100)], 600)[0]
    dispatch.reset_launches()
    reqs, out, called, returned = live_streams(
        engine, [prompt(100), prompt(100)], 600,
        update=lambda: server.update_weights({"weights": host, "version": 1}))
    stats = dict(engine.update_stats)
    staged_until = called + stats["stage_s"]
    log(f"{label} ({card}) -> {out}: {nbytes / 1e9:.2f} GB of numpy float32 "
        f"({stats['staged_bytes'] / 1e9:.2f} GB through pinned memory) staged to the card on a "
        f"side stream and cast to {cfg.dtype} in {1e3 * stats['stage_s']:.2f} ms "
        f"({stats['staged_bytes'] / stats['stage_s'] / 1e9:.2f} GB/s), wait for the replay lock "
        f"{1e3 * stats['wait_s']:.2f} ms, swap {1e3 * stats['swap_s']:.2f} ms (host)")
    log(f"  2 streams of 600 tokens: without an update {stream_figures(alone)}; while the "
        f"staging ran {stream_figures(reqs, called, staged_until)}; whole streams with the "
        f"update {stream_figures(reqs)}")
    got = [server({"prompt_ids": p, "max_tokens": 32}) for p in ps]
    launches = dispatch.launch_counts()
    log(f"launches around {label}: {launches}")
    require_no_eager_launches(label)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"{label} never launched kernel {name}")
    if not exact_gate(label, ps, got, want):
        fail(f"{label}: the updated server differs from a fresh engine on the new weights")
    fresh.stop()
    del fresh, host
    release()
    restore(server, init_params(cfg, seed=0, device="cuda", dtype=cfg.dtype), 2, sums0, label)
    log(f"{label}: seed-0 weights restored (version 2), checksums and the f32 head copy "
        f"bit-exact")
    release()
    return launches


def moe_serve_path(card: str, profile: bool) -> dict:
    """Phase 5: LLMServer serving moe-1b at full width and depth, plain, then
    the no-drop logprob gate with its planted faults, then an ngram burst;
    the graph checks on the idle ngram engine. Returns the launch counts of
    the plain and the ngram bursts, summed."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import dispatch

    server = new_server("phase 5: LLMServer moe-1b", model_name="moe-1b", engine_config=ENGINE,
                        seed=0)
    cfg, params = server.engine.cfg, server.engine.params
    E, k = cfg.num_experts, cfg.num_selected_experts

    def capacity(T):
        return min(max((-int(-cfg.capacity_factor * T * k // E) + 3) // 4 * 4, 4), T * k)

    log(f"phase 5: moe-1b d_model {cfg.d_model}, layers {cfg.n_layers}, heads {cfg.n_heads}/"
        f"{cfg.kv_heads}, d_ff {cfg.d_ff}, {E} experts top {k}, capacity factor "
        f"{cfg.capacity_factor} (slots an expert: decode {capacity(1)}, verify S=5 "
        f"{capacity(5)}, bucket 64 {capacity(64)}, chunk {server.engine.ecfg.prefill_chunk} "
        f"{capacity(server.engine.ecfg.prefill_chunk)}), vocab {cfg.vocab_size}; "
        f"{sum(t.numel() for _, t in named_leaves(params)) / 1e9:.4f} B params")
    rng = torch.Generator().manual_seed(5)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

    def burst():
        return [{"prompt_ids": prompt(n), "max_tokens": 32} for n in (23, 100, 200, 700)] + [
            {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9}]

    def serve(srv, label, reqs):
        res, wall, errors = run_requests(srv, reqs)
        if errors:
            srv.shutdown()
            fail(f"{label}: {errors}")
        return res, wall

    requests = burst()
    dispatch.reset_launches()
    with PrefillClock(server.engine) as clock:
        results, wall = serve(server, "moe-1b plain", requests)
    launches = dispatch.launch_counts()
    log(f"launches on the moe-1b serving path: {launches}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"moe-1b serving path never launched kernel {name}")
    require_no_eager_launches("moe-1b serving path")
    report_burst("moe-1b plain", requests, results, wall)
    clock.report("moe-1b plain")
    if profile:
        def profiled():
            return serve(server, "profiled moe-1b", requests)[1]

        profile_report(profiled)
    # one streamed KV migration of a fresh 700-token prompt into a second
    # engine at page size 16, held to phase 3m's gate (a)
    label = "phase 5: moe-1b KV migration"
    dst = new_server(f"{label}: destination engine, page size {server.engine.ecfg.page_size}",
                     params_fn=lambda: (params, cfg), engine_config=ENGINE)
    migrate = round_trip(server, dst.engine, prompt(700), "layer", label)[2]
    dst.shutdown()
    del dst
    release()
    log(f"launches on the moe-1b migration (export and import): {migrate}")
    for name in ("rms_norm", "paged_attention_chunk", "paged_attention_decode"):
        if migrate[name] <= 0:
            fail(f"{label} never launched kernel {name}")
    live = moe_live_update(server, card)
    server.shutdown()
    decode_step_figures(server.engine, card)
    del server
    release()

    # the gate: no-drop servers over the same weights, sound and faulted
    nodrop = dataclasses.replace(cfg, capacity_factor=E / k)

    def nodrop_server(label):
        return new_server(label, params_fn=lambda: (params, nodrop), engine_config=ENGINE)

    gated = nodrop_server(f"phase 5: moe-1b, capacity factor {E / k} (no drops)")
    sound_reqs = burst()
    sound_res, _wall = serve(gated, "moe-1b no-drop", sound_reqs)
    gated.shutdown()
    del gated
    release()
    faulted = []
    for name, fault in MOE_FAULTS.items():
        reqs = burst()
        with planted(transformer, fault):
            fs = nodrop_server(f"planted MoE fault {name}")
            res, _wall = serve(fs, f"planted MoE fault {name}", reqs)
            fs.shutdown()
        del fs
        release()
        faulted.append((name, reqs, res))
    sound = logprob_gaps(params, nodrop, sound_reqs, sound_res, yardstick=True,
                         tol=MOE_LOGPROB_TOL)
    caught = {}
    for name, reqs, res in faulted:
        gaps = logprob_gaps(params, nodrop, reqs, res)
        caught[name] = any(not within_moe_tol(g) for g in gaps)
        log(f"planted MoE fault {name}: logprob |engine - forward| per request max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]}")
    log(f"moe-1b no-drop gate (limit {MOE_LOGPROB_TOL}): sound per request max "
        f"{[round(g[0], 4) for g in sound]} mean {[round(g[1], 4) for g in sound]}")
    for i, gap in enumerate(sound):
        if not within_moe_tol(gap):
            fail(f"moe-1b request {i}: logprobs differ from the forward by max {gap[0]:.4f}, "
                 f"mean {gap[1]:.4f} (tol {MOE_LOGPROB_TOL})")
    for name, hit in caught.items():
        if not hit:
            fail(f"the moe-1b logprob gate {MOE_LOGPROB_TOL} passes planted fault {name}")

    # ngram speculation (K7), at the registered capacity factor
    server = new_server("phase 5: LLMServer moe-1b speculation ngram", model_name="moe-1b",
                        seed=0, engine_config=dict(ENGINE, speculation={
                            "mode": "ngram", "num_speculative_tokens": 4}))
    requests = [{"prompt_ids": planted_prompt(server, prompt, n), "max_tokens": 32}
                for n in (100, 150, 200)]
    requests += [{"prompt_ids": prompt(8) * 12, "max_tokens": 32},
                 {"prompt_ids": prompt(60), "max_tokens": 32},
                 {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9}]
    since = spec_counters(server.engine)
    dispatch.reset_launches()
    results, wall = serve(server, "moe-1b ngram", requests)
    ngram = dispatch.launch_counts()
    log(f"launches on the moe-1b speculation path, ngram mode: {ngram}")
    require_no_eager_launches("moe-1b speculation path, ngram mode")
    for name in ("paged_attention_verify", "paged_attention_decode"):
        if ngram[name] <= 0:
            fail(f"moe-1b ngram path never launched kernel {name}")
    report_burst("moe-1b ngram", requests, results, wall)
    spec_report("moe-1b ngram", server.engine, since)
    server.shutdown()
    log(f"the moe-1b captured programs against their eager bodies ({card}):")
    graph_checks(server.engine)
    del server
    release()
    return {"launches": {name: launches[name] + ngram[name] for name in launches},
            "migrate": migrate, "live": live}


# -------------------------------------------------------------- phase 4

# The gradient gate: per parameter leaf, the relative L2 gap
# |g_kernel - g_plain| / |g_plain| of one step's gradients, kernel path
# against plain path, must stay under GRAD_TOL (the largest over leaves is
# compared), and each planted backward fault must exceed it somewhere.
# Both paths compute in bf16 and round at different places. On the H100
# the sound run read 0.0038 and the weakest fault (K4 dropping the last q
# tile) 0.059 (PERF.md); the limit sits near their geometric middle, about
# 4x from each.
GRAD_TOL = 0.015
# |loss_kernel - loss_plain| in nats: the two forwards (K1/K2 against the
# plain versions, bf16 activations) may differ by rounding only
LOSS_GAP_TOL = 0.01


def _keys_one_ahead(f):
    """K3 reads its keys one position ahead: query row t sees keys 1..t+1
    in place of 0..t (the last position reads zeros)."""
    def shifted(t):
        return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)

    def dq(q, k, v, do, lse, delta, causal=True, scale=None):
        return f(q, shifted(k), shifted(v), do, lse, delta, causal, scale)
    return dq


def _drop_last_q_tile(f):
    """K4 loses the last 64-row q tile: those queries add nothing to dk/dv."""
    def dkv(q, k, v, do, lse, delta, causal=True, scale=None):
        return f(q[:, :-64], k, v, do[:, :-64], lse[:, :, :-64].contiguous(),
                 delta[:, :, :-64].contiguous(), causal, scale)
    return dkv


def _first_head_of_group(f):
    """K4 sums dk/dv over the first q head of each GQA group only."""
    def dkv(q, k, v, do, lse, delta, causal=True, scale=None):
        g = q.shape[2] // k.shape[2]
        return f(q[:, :, ::g], k, v, do[:, :, ::g], lse[:, ::g].contiguous(),
                 delta[:, ::g].contiguous(), causal, scale)
    return dkv


def _inv_of_neighbour_row(f):
    """K1's backward takes each row's inv from the row before it (the first
    row from the last): dx = inv' (g w - x inv' mean(g w x inv')); dw is the
    kernel's."""
    def bwd(x, w, g, eps):
        _dx, dw = f(x, w, g, eps)
        xf, gw = x.float(), g.float() * w.float()
        inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        inv = inv.reshape(-1, 1).roll(1, 0).reshape(inv.shape)
        xhat = xf * inv
        return (inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))).to(x.dtype), dw
    return bwd


def _dw_of_one_row_block(f):
    """K1's dw sums the rows of one CTA only, as if the merge read the first
    partial row alone: here every 16th row (the kernel's CTAs each walk a
    far smaller share); dx is the kernel's."""
    def bwd(x, w, g, eps):
        dx, _dw = f(x, w, g, eps)
        D = x.shape[-1]
        _dx, dw = f(x.reshape(-1, D)[::16].contiguous(), w, g.reshape(-1, D)[::16].contiguous(),
                    eps)
        return dx, dw
    return bwd


# Backward faults the gradient gate must catch, each planted by wrapping a
# kernel wrapper that an autograd Function's backward calls:
# name -> (module in ray_tpu_torch.ops, attribute, wrapper maker)
BWD_FAULTS = {
    "dq_keys_one_ahead": ("attention", "flash_attention_bwd_dq", _keys_one_ahead),
    "dkv_drops_last_q_tile": ("attention", "flash_attention_bwd_dkv", _drop_last_q_tile),
    "dkv_first_head_of_group": ("attention", "flash_attention_bwd_dkv", _first_head_of_group),
    "norm_dx_inv_of_neighbour_row": ("norm", "rms_norm_bwd", _inv_of_neighbour_row),
    "norm_dw_of_one_row_block": ("norm", "rms_norm_bwd", _dw_of_one_row_block),
}


def named_leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def loss_and_grads(params, batch, cfg):
    """One step's loss and gradients, without an update."""
    from ray_tpu_torch.models import loss_fn

    loss, _ = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in named_leaves(params)])
    return float(loss.detach()), grads


def plain_path():
    """The transformer's attention and norms as their plain versions under
    autograd (the module imports them by name, so they are swapped there)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import attention, norm

    return swapped(transformer, flash_attention=attention.mha_reference,
                   rms_norm=norm.rms_norm_reference)


def grad_gaps(names, grads, ref) -> dict:
    return {n: float(torch.linalg.vector_norm(g.float() - r.float())
                     / torch.linalg.vector_norm(r.float()))
            for n, g, r in zip(names, grads, ref)}


def gradient_gate(label: str, params, batch, cfg, plain, faults, each_pass=None,
                  grads_fn=loss_and_grads) -> None:
    """One step's loss and gradients on the kernel path against the `plain`
    path's (a context): the losses within LOSS_GAP_TOL and, per leaf, the
    relative L2 gap within GRAD_TOL; each planted fault (name -> (module,
    attribute, wrapper maker), planted on the kernel path) must exceed
    GRAD_TOL somewhere. `each_pass`: a context every pass runs in;
    `grads_fn(params, batch, cfg)` -> (loss, grads in named_leaves order):
    the LM loss's by default."""
    each_pass = each_pass or contextlib.nullcontext
    names = [n for n, _ in named_leaves(params)]
    with each_pass():
        loss_k, g_kernel = grads_fn(params, batch, cfg)
    with each_pass(), plain():
        loss_p, g_plain = grads_fn(params, batch, cfg)
    sound = grad_gaps(names, g_kernel, g_plain)
    del g_kernel
    faulted = {}
    for name, (module, attr, make) in faults.items():
        with each_pass(), planted(module, (attr, make)):
            _loss, g = grads_fn(params, batch, cfg)
        faulted[name] = grad_gaps(names, g, g_plain)
        del g
    del g_plain
    gc.collect()
    torch.cuda.empty_cache()

    def fmt(gaps):
        return " ".join(f"{n} {x:.5f}" for n, x in gaps.items())

    log(f"{label} (relative L2 per leaf, limit {GRAD_TOL}): loss kernel {loss_k:.6f} "
        f"plain {loss_p:.6f} (|gap| {abs(loss_k - loss_p):.3e}, limit {LOSS_GAP_TOL})")
    log(f"  sound: max {max(sound.values()):.5f}: {fmt(sound)}")
    for name, gaps in faulted.items():
        log(f"  planted {name}: max {max(gaps.values()):.5f}: {fmt(gaps)}")
    if not abs(loss_k - loss_p) <= LOSS_GAP_TOL:
        fail(f"{label}: kernel and plain losses differ by {abs(loss_k - loss_p):.3e}")
    worst = max(sound, key=sound.get)
    if not sound[worst] <= GRAD_TOL:
        fail(f"{label}: kernel gradients differ from the plain path: {worst} "
             f"{sound[worst]:.5f}")
    for name, gaps in faulted.items():
        if not max(gaps.values()) > GRAD_TOL:
            fail(f"{label} ({GRAD_TOL}) passes planted fault {name}")


def train_launches(cfg, steps: int) -> dict:
    """The exact launches of `steps` training steps: K3 and K4 once per layer
    per step, K2 with lse twice (forward and remat recompute), K1's forward
    4 x layers + 1 times and its backward 2 x layers + 1."""
    L = cfg.n_layers
    return {"flash_attention_bwd_dq": L * steps, "flash_attention_bwd_dkv": L * steps,
            "flash_attention": 2 * L * steps, "flash_attention_lse": 2 * L * steps,
            "rms_norm": (4 * L + 1) * steps, "rms_norm_bwd": (2 * L + 1) * steps,
            "paged_attention_decode": 0, "paged_attention_chunk": 0,
            "paged_attention_verify": 0}


def train_steps(label: str, cfg, state, step, batch, steps: int) -> dict:
    """`steps` calls of a train step on one batch. Launch counts are reset
    just before and read just after, and must equal train_launches; the
    first step (learning rate 0) must leave every parameter bit-identical;
    every loss must be finite and the last below the first. Peak memory is
    read over steps 1 onward. Returns {"launches", "losses", "times" (s,
    each step's wall up to its loss on the host), "peak" (bytes)}."""
    from ray_tpu_torch.ops import dispatch

    leaves = named_leaves(state["params"])
    before = [t.detach().clone() for _, t in leaves]
    losses, times = [], []
    dispatch.reset_launches()
    for i in range(steps):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
        log(f"{label} step {i}: loss {losses[-1]:.6f} ce {float(m['ce_loss']):.6f} "
            f"aux {float(m['aux_loss']):.4e} z {float(m['z_loss']):.4e} acc "
            f"{float(m['accuracy']):.5f} grad_norm {float(m['grad_norm']):.5f} "
            f"{times[-1]:.3f}s")
        if i == 0:  # learning rate 0: nothing may move
            moved = [n for (n, t), b in zip(leaves, before) if not torch.equal(t.detach(), b)]
            del before
            if moved:
                fail(f"{label}: the first step (learning rate 0) changed {moved}")
            torch.cuda.reset_peak_memory_stats()
    launches = dispatch.launch_counts()
    log(f"launches on the {label} path ({steps} steps): {launches}")
    for name, n in train_launches(cfg, steps).items():
        if launches[name] != n:
            fail(f"{label} launched {name} {launches[name]} times, expected {n}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    return {"launches": launches, "losses": losses, "times": times,
            "peak": torch.cuda.max_memory_allocated()}


def train_main_path(card: str, profile: bool) -> dict:
    from ray_tpu_torch import ops, train
    from ray_tpu_torch.models import get_config

    cfg = get_config("llama-2b")
    L, B, T = cfg.n_layers, 4, 2048
    opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100)
    t0 = time.monotonic()
    state = train.init_train_state(cfg, opt, seed=0)
    leaves = named_leaves(state["params"])
    n_params = sum(t.numel() for _, t in leaves)
    del leaves
    batch = train.synthetic_batch(cfg, B, T, seed=0)
    step = train.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    log(f"phase 4: train llama-2b (d_model {cfg.d_model}, layers {L}, heads {cfg.n_heads}/"
        f"{cfg.kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.4f} B "
        f"params, f32 masters, {cfg.dtype} compute, remat {cfg.remat}) on {B} x {T} tokens; "
        f"state built in {time.monotonic() - t0:.1f}s, "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    ran = train_steps("training", cfg, state, step, batch, TRAIN_STEPS)
    losses, times, S = ran["losses"], ran["times"], TRAIN_STEPS
    step_s = statistics.median(times[1:])
    mfu = 6 * n_params * B * T / step_s / 989e12
    log(f"training: step time median {step_s:.4f}s (steps 1-{S - 1}: "
        f"{[round(t, 4) for t in times[1:]]}), {B * T / step_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} (6 N tokens / step time / 989e12), "
        f"peak memory {ran['peak'] / 2**30:.2f} GiB (steps 1-{S - 1}); loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; {card}")
    figures = {"launches": ran["launches"], "step_s": step_s, "tokens_s": B * T / step_s,
               "mfu": mfu, "peak": ran["peak"]}

    if profile:  # one more step
        def profiled():
            t1 = time.perf_counter()
            float(step(state, batch)[1]["loss"])
            return time.perf_counter() - t1

        profile_report(profiled)

    # the gradient gate, on the trained parameters
    state["opt_state"] = None
    gc.collect()
    torch.cuda.empty_cache()
    params = state["params"]
    del state
    gradient_gate("gradient gate", params, batch, cfg, plain_path,
                  {name: (getattr(ops, module), attr, make)
                   for name, (module, attr, make) in BWD_FAULTS.items()})
    return figures


# ------------------------------------------------------ phases 4f and 6


def bf16_params(state) -> None:
    """The reference's bench recipe (bench.py:1576-1584): after
    init_train_state, every f32 parameter leaf becomes bf16, in the
    caller; the train step takes the leaves as they are."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.detach().to(torch.bfloat16) if tree.dtype == torch.float32 else tree

    state["params"] = cast(state["params"])


def factored_bytes(params) -> int:
    """What adafactor's statistics take in f32 by the leaf shapes alone: a
    leaf of >= 2 dims whose second largest dim is >= 128 keeps two
    statistics, its shape without its largest dim and its shape without its
    second largest (one each where they tie); any other leaf one of its own
    shape."""
    total = 0
    for _, t in named_leaves(params):
        shape = tuple(t.shape)
        big = sorted(shape)
        if len(shape) >= 2 and big[-2] >= 128:
            total += math.prod(shape) // big[-1] + math.prod(shape) // big[-2]
        else:
            total += math.prod(shape)
    return 4 * total


def opt_state_bytes(opt_state) -> int:
    """The bytes an optimizer state's tensors hold on the card."""
    held = [t for key in ("v_row", "v_col", "v") for t in opt_state[key] if t is not None]
    return sum(t.numel() * t.element_size() for t in held)


def factored_train(label: str, cfg, B: int, T: int, steps: int, timed_from: int,
                   profile: bool = False) -> dict:
    """The reference's factored recipe on one card: init_train_state with
    make_optimizer(factored=True) (lr 3e-4 after a warmup of 2, as phase 4;
    the reference's bench keeps the default warmup of 100, under which a
    bf16 weight of 0.02, whose ulp is 1.2e-4, barely moves in 10 steps),
    parameters cast to bf16 after init, then `steps` steps on one
    synthetic batch (train_steps' gates). The optimizer state must be
    factored: its bytes equal factored_bytes and stay under 1 % of the bf16
    parameters. With `profile`, one more step under torch.profiler.
    Returns the figures, with "state": the trained state."""
    from ray_tpu_torch import train

    opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                               factored=True)
    t0 = time.monotonic()
    state = train.init_train_state(cfg, opt, seed=0)
    held, want = opt_state_bytes(state["opt_state"]), factored_bytes(state["params"])
    bf16_params(state)
    gc.collect()
    torch.cuda.empty_cache()
    leaves = named_leaves(state["params"])
    n_params = sum(t.numel() for _, t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    del leaves
    batch = train.synthetic_batch(cfg, B, T, seed=0)
    step = train.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    log(f"{label}: d_model {cfg.d_model}, layers {cfg.n_layers}, heads {cfg.n_heads}/"
        f"{cfg.kv_heads}, d_ff {cfg.d_ff}, experts {cfg.num_experts} (top "
        f"{cfg.num_selected_experts if cfg.is_moe else 0}), vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.4f} B params in bf16 ({param_bytes / 2**30:.3f} GiB), adafactor, "
        f"{cfg.dtype} compute, remat {cfg.remat}, on {B} x {T} tokens; state built in "
        f"{time.monotonic() - t0:.1f}s, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
        f"optimizer state {held / 2**20:.3f} MiB in f32 (by the leaf shapes "
        f"{want / 2**20:.3f} MiB), {100 * held / param_bytes:.3f} % of the bf16 parameters")
    if held != want:
        fail(f"{label}: the optimizer state holds {held} bytes, the leaf shapes give {want}")
    if not held < 0.01 * param_bytes:
        fail(f"{label}: the optimizer state is {100 * held / param_bytes:.3f} % of the "
             f"parameters (limit 1 %): not factored")
    ran = train_steps(label, cfg, state, step, batch, steps)
    times = ran["times"][timed_from:]
    step_s = statistics.median(times)
    after = opt_state_bytes(state["opt_state"])
    log(f"{label}: step time median {step_s:.4f}s (steps {timed_from}-{steps - 1}: "
        f"{[round(t, 4) for t in times]}), {B * T / step_s:.1f} tokens/s, MFU "
        f"{6 * n_params * B * T / step_s / 989e12:.4f} (6 N tokens / step time / 989e12; N "
        f"counts every expert), peak memory {ran['peak'] / 2**30:.2f} GiB (steps 1-"
        f"{steps - 1}); loss {ran['losses'][0]:.5f} -> {ran['losses'][-1]:.5f}; optimizer "
        f"state after the steps {after / 2**20:.3f} MiB (its statistics take the "
        f"parameters' bf16)")
    if profile:
        def profiled():
            t1 = time.perf_counter()
            float(step(state, batch)[1]["loss"])
            return time.perf_counter() - t1

        profile_report(profiled)
    return dict(ran, step_s=step_s, tokens_s=B * T / step_s,
                mfu=6 * n_params * B * T / step_s / 989e12, state=state)


def train2b_path(card: str, adamw: dict, profile: bool) -> dict:
    """Phase 4f: llama-2b under the reference's train2b recipe (bench.py:2429:
    4 x 2048 tokens, 8 steps, factored, bf16 parameters), beside phase 4's
    AdamW with f32 masters."""
    from ray_tpu_torch.models import get_config

    ran = factored_train("phase 4f: train llama-2b, train2b recipe", get_config("llama-2b"),
                         4, 2048, TRAIN_STEPS, 1, profile)
    del ran["state"]
    release()
    log(f"phase 4f beside phase 4 (llama-2b, 4 x 2048; {card}): step {ran['step_s']:.4f} "
        f"against {adamw['step_s']:.4f} s, {ran['tokens_s']:.1f} against "
        f"{adamw['tokens_s']:.1f} tokens/s, MFU {ran['mfu']:.4f} against {adamw['mfu']:.4f}, "
        f"peak {ran['peak'] / 2**30:.2f} against {adamw['peak'] / 2**30:.2f} GiB")
    return ran


# ------------------------------------------------------------- phase 4p

# the reference's pretrain -> checkpoint -> serve flow at llama-2b under
# phase 4f's recipe: 12 steps of 4 x 2048 tokens from data.from_numpy,
# checkpoints of {params, opt_state, step} after steps 3, 7 and 11 (two
# kept), a restart that fails after step 9 and resumes from step 7's
PRETRAIN_STEPS = 12
PRETRAIN_CKPT_STEPS = (3, 7, 11)
PRETRAIN_FAIL_AT = 9
PRETRAIN_BATCH = (4, 2048)  # rows x tokens a step, phase 4f's
# a fit() may leave this much more card memory allocated than it found
# (one train2b state is ~3.7 GB of bf16 parameters and adafactor state)
PRETRAIN_MEMORY_TOL = 0.5 * 2**30
# what a retired llama-2b replica may leave allocated beside the weights its
# caller holds: after a sound shutdown 0.19 and 0.41 GiB stayed on the H100,
# not attributed (PERF.md, phase 4p); a replica whose instance is kept holds
# its KV pool, f32 head copy and graph pools besides
SERVE_RETIRED_MEMORY_TOL = 0.75 * 2**30
# threads a training gang starts: its members' actor lanes, the data
# plane's host prefetch and the checkpoint writer
GANG_THREADS = ("actor-", "data-host-prefetch", "checkpoint-writer")


def split_tokens(batch):
    """Phase 4p's host transform: rows of T + 1 ids -> tokens, targets."""
    toks = batch["tokens"]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def pretrain_loop(cfg, marks: dict):
    """The training loop phase 4p's TorchTrainer runs, as a user writes it:
    phase 4f's recipe from seed 0, or the state of get_checkpoint() (the
    batches before it skipped); batches from get_dataset_shard("train").
    iter_device_batches; a report every step with its loss, its time and
    the host's wait inside next(). At config["ckpt_steps"] the state
    {params, opt_state, step} goes to an AsyncCheckpointWriter under the
    trial directory (the host
    copy before the next step; the write overlaps it) with the checksums of
    the parameters in the step's report; the checkpoint is reported once its
    write has finished, with the next step's report (at once after the last
    step). The first attempt raises after step config["fail_at"]. `marks`
    (shared with fit()'s caller: the gang runs in this process) gets the
    monotonic times of the failure and of the first resumed step."""
    def loop(config):
        from ray_tpu_torch import train

        ckpt = train.get_checkpoint()
        marks["attempts"] = attempt = marks.get("attempts", 0) + 1
        marks.setdefault("entered", []).append(time.monotonic())
        opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                                   factored=True)
        if ckpt is None:
            state = train.init_train_state(cfg, opt, seed=0)
            bf16_params(state)
        else:
            t0 = time.perf_counter()
            state = train.load_pytree(os.path.join(ckpt.path, "state"))
            marks["resume_load_s"] = time.perf_counter() - t0
        start = state["step"]  # steps taken before this attempt
        step = train.make_train_step(cfg, opt)
        writer = train.AsyncCheckpointWriter()
        pending = None  # (path, step) of a checkpoint being written
        batches = iter(train.get_dataset_shard("train").iter_device_batches(
            batch_size=PRETRAIN_BATCH[0], transform=split_tokens))
        for i in range(config["steps"]):
            t0 = time.perf_counter()
            batch = next(batches)
            wait_s = time.perf_counter() - t0
            if i < start:
                continue  # consumed by the attempt this one resumes
            if ckpt is not None and i == start:
                marks["resumed_at"] = time.monotonic()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            metrics = {"step": i, "attempt": attempt, "loss": float(m["loss"]),
                       "step_s": time.perf_counter() - t1, "wait_s": wait_s}
            done = None
            if pending is not None:
                t2 = time.perf_counter()
                writer.wait()
                done, pending = pending, None
                metrics["ckpt_wait_s"] = time.perf_counter() - t2
            if i in config["ckpt_steps"]:
                metrics["checksums"] = list(leaf_checksums(state["params"]).values())
                path = os.path.join(train.get_context().get_trial_dir(), f"step{i}")
                writer.save({"params": state["params"], "opt_state": state["opt_state"],
                             "step": state["step"]}, os.path.join(path, "state"))
                pending = (path, i)
                if i == config["steps"] - 1:
                    writer.wait()
                    done, pending = pending, None
            report_ckpt = None
            if done is not None:
                report_ckpt = train.Checkpoint(done[0])
                report_ckpt.set_metadata({"step": done[1]})
                (written,) = [s for s in writer.stats if s["path"].startswith(done[0] + os.sep)]
                metrics.update(ckpt_step=done[1], snapshot_s=written["snapshot_s"],
                               write_s=written["write_s"], ckpt_bytes=written["bytes"])
            if attempt == 1 and i == config.get("fail_at"):
                marks["failed_at"] = time.monotonic()
                raise RuntimeError(f"phase 4p: planted failure after step {i}")
            train.report(metrics, checkpoint=report_ckpt)
        writer.wait()
        marks["ended"] = time.monotonic()

    return loop


def gang_threads() -> set:
    return {t for t in threading.enumerate() if t.name.startswith(GANG_THREADS) and t.is_alive()}


def pretrain_fit(cfg, ds, storage: str, name: str, label: str, **config) -> dict:
    """One TorchTrainer.fit() of pretrain_loop over `ds` on the card, its
    checkpoints under <storage>/<name> (the trial directory). Reads
    card memory just before it and just after (and after a garbage
    collection), the gang's threads left, and the launch counts of the fit
    alone. -> {"result", "marks", "wall", "launches", "mem0", "mem1",
    "mem1_gc", "threads_left"}."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import dispatch

    from ray_tpu_torch.train import checkpoint, worker_group

    marks: dict = {}
    config = {"steps": PRETRAIN_STEPS, "ckpt_steps": PRETRAIN_CKPT_STEPS, **config}
    shutdown, run, poll = (worker_group.WorkerGroup.shutdown, worker_group.TrainWorker._cls.run,
                           worker_group.WorkerGroup.poll)

    # where the end of a fit() goes: the member's run returning, fit()'s
    # polls of the gang, the gang's teardown
    def timed_shutdown(group):
        t = time.monotonic()
        shutdown(group)
        marks.setdefault("teardown_s", []).append(time.monotonic() - t)

    def timed_run(worker, *args, **kwargs):
        try:
            return run(worker, *args, **kwargs)
        finally:
            marks["run_returned"] = time.monotonic()

    register = checkpoint.CheckpointManager.register

    def timed_register(manager, *args):  # evicting a checkpoint deletes its files
        t = time.monotonic()
        try:
            return register(manager, *args)
        finally:
            marks.setdefault("register_s", []).append(time.monotonic() - t)

    def timed_poll(group):
        t = time.monotonic()
        try:
            return poll(group)
        finally:
            marks["poll_max_s"] = max(marks.get("poll_max_s", 0.0), time.monotonic() - t)
            marks["last_poll_end"] = time.monotonic()

    logger = train.MLflowLoggerCallback(experiment_name="phase4p", name=name,
                                        dir=os.path.join(storage, "mlflow"))
    trainer = train.TorchTrainer(
        pretrain_loop(cfg, marks), train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(
            name=name, storage_path=storage, callbacks=[logger],
            checkpoint_config=train.CheckpointConfig(num_to_keep=2),
            failure_config=train.FailureConfig(max_failures=1)),
        datasets={"train": ds})
    threads0 = gang_threads()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.monotonic()
    with swapped(worker_group.WorkerGroup, shutdown=timed_shutdown, poll=timed_poll), \
            swapped(worker_group.TrainWorker._cls, run=timed_run), \
            swapped(checkpoint.CheckpointManager, register=timed_register):
        result = trainer.fit()
    torch.cuda.synchronize()
    marks["returned"] = time.monotonic()
    marks["called"] = t0
    wall = marks["returned"] - t0
    launches = dispatch.launch_counts()
    mem1 = torch.cuda.memory_allocated()
    gc.collect()
    mem1_gc = torch.cuda.memory_allocated()
    deadline = time.monotonic() + 5
    while (gang_threads() - threads0) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(t.name for t in gang_threads() - threads0)
    with open(os.path.join(logger.dir, name, "history.jsonl")) as f:
        logged = [json.loads(line)["loss"] for line in f]
    reported = [m["loss"] for m in result.metrics_history]
    log(f"{label}: the MLflowLoggerCallback's history.jsonl holds {len(logged)} losses, "
        f"equal to the {len(reported)} fit() reported: {logged == reported}")
    if logged != reported:
        fail(f"{label}: the logger's losses {logged} are not fit()'s {reported}")
    log(f"{label}: fit() {wall:.2f}s over {marks.get('attempts')} attempt(s), error "
        f"{result.error!r}; card memory {mem0 / 2**30:.3f} GiB before, {mem1 / 2**30:.3f} after "
        f"({mem1_gc / 2**30:.3f} after a garbage collection); gang threads left "
        f"{left or 'none'}")
    return {"result": result, "marks": marks, "wall": wall, "launches": launches,
            "mem0": mem0, "mem1": mem1, "mem1_gc": mem1_gc, "threads_left": left}


def checkpoint_checks(result, label: str) -> list:
    """Every checkpoint the fit kept, loaded onto the card: -> [(step, its
    reported checksums, the loaded parameters' checksums, load s)]."""
    from ray_tpu_torch import train

    reported = {m["step"]: m["checksums"] for m in result.metrics_history if "checksums" in m}
    out = []
    for ckpt in sorted(
            (os.path.join(result.path, n) for n in os.listdir(result.path)
             if n.startswith("step")), key=lambda p: int(p.rsplit("step", 1)[-1])):
        step = train.Checkpoint(ckpt).get_metadata().get("step")
        t0 = time.perf_counter()
        loaded = train.load_pytree(os.path.join(ckpt, "state"))
        load_s = time.perf_counter() - t0
        sums = list(leaf_checksums(loaded["params"]).values())
        out.append((step, reported.get(step), sums, load_s, loaded["step"]))
        del loaded
        release()
    log(f"{label}: checkpoints kept {[o[0] for o in out]}; " + "; ".join(
        f"step {s}: state step {n}, loaded in {t:.3f}s, checksums equal the reported ones "
        f"{got == want}" for s, want, got, t, n in out))
    return out


def late_snapshot_writer():
    """Planted fault checkpoint_after_update: an AsyncCheckpointWriter whose
    save() keeps references to the live tensors and copies them to the host
    only at the next wait(), after the next step's in-place update."""
    from ray_tpu_torch.train import checkpoint

    class LateSnapshot(checkpoint.AsyncCheckpointWriter):
        _late = None

        def save(self, tree, path):
            self.wait()
            self._late = (tree, path)

        def wait(self):
            late, self._late = self._late, None
            if late is not None:
                super().save(*late)
            super().wait()

    return LateSnapshot


def pretrain_path(card: str) -> dict:
    """Phase 4p: the reference's pretrain -> checkpoint -> serve flow
    (examples/pretrain_and_serve.py) at llama-2b, full width and depth,
    through the port's entry points on the card.
    (a) data.from_numpy of [48, 2049] int32 token rows (numpy seed 0, six
        blocks); the loop reads iter_device_batches(batch_size=4).
    (b) The yardstick: the same 12 batches through train.lm directly from
        the same initial weights.
    (c) TorchTrainer(...).fit() for 12 steps, checkpoints after steps 3, 7
        and 11 (num_to_keep=2). Gates: step 0's loss bit-identical to (b)'s,
        every loss within LOSS_GAP_TOL of (b)'s, exact launch counts, each
        kept checkpoint's parameters bit for bit as reported (checksums),
        two checkpoint directories left.
    (d) fit() again, failing after step 9 on its first attempt under
        FailureConfig(max_failures=1): it resumes from step 7's checkpoint.
        Gates: steps 8-11 within LOSS_GAP_TOL of (c)'s, card memory after
        fit() within PRETRAIN_MEMORY_TOL of before, no gang thread left.
    (e) serve.run(LLMServer.bind(params_fn=<load_pytree of (c)'s checkpoint
        on the card>)) and phase 3's burst through the handle. Gates: every
        request returns its 32 tokens, phase 3's logprob gate against
        forward over the loaded weights, no launch outside a graph, the
        wgmma and split kernels by name, no thread left by serve.shutdown().
    (f) Planted faults: checkpoint_after_update (the checksum gate) and
        restart_keeps_state (the memory gate) must each be caught.
    Returns {"launches": (c)'s + (e)'s}."""
    import tempfile

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, serve, train
    from ray_tpu_torch.core import core_worker, node_agent
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.ops import dispatch

    t_phase = time.monotonic()

    def retire(runtime_threads) -> tuple:
        """serve.shutdown(), then the threads it left (waiting up to 15 s)
        and the card memory allocated beyond mem_p."""
        serve.shutdown()
        deadline = time.monotonic() + 15
        while True:
            left = [t.name for t in threading.enumerate()
                    if t not in runtime_threads and t.is_alive()]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        release()
        return left, torch.cuda.memory_allocated() - mem_p

    cfg = get_config("llama-2b")
    (B, T), S = PRETRAIN_BATCH, PRETRAIN_STEPS
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (B * S, T + 1)).astype(np.int32)
    serve.shutdown()
    rt.shutdown()
    rt.init(system_config=RUNTIME_FLAGS)  # thread mode, this host's CPUs and its card
    storage = tempfile.mkdtemp(prefix="phase4p-")
    try:
        ds = data.from_numpy({"tokens": rows}, parallelism=6)
        log(f"phase 4p: llama-2b (d_model {cfg.d_model}, layers {cfg.n_layers}, heads "
            f"{cfg.n_heads}/{cfg.kv_heads}, vocab {cfg.vocab_size}), train2b recipe, {S} steps "
            f"of {B} x {T}; data.from_numpy int32 [{B * S}, {T + 1}] in "
            f"{ds.stats()['num_blocks']} blocks ({rows[:B].nbytes} bytes a batch); "
            f"checkpoints in {storage}")

        # (b) the yardstick: train.lm directly on the same batches
        opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        bf16_params(state)
        n_params = sum(t.numel() for _, t in named_leaves(state["params"]))
        step = train.make_train_step(cfg, opt)
        direct, direct_s = [], []
        for i in range(S):  # the batches as the loop gets them: split on the host
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                     for k, v in split_tokens({"tokens": rows[B * i:B * (i + 1)]}).items()}
            t1 = time.perf_counter()
            state, m = step(state, batch)
            direct.append(float(m["loss"]))
            direct_s.append(time.perf_counter() - t1)
        del state, step, m, batch
        release()
        log(f"phase 4p (b) train.lm directly: losses {[round(x, 5) for x in direct]}; step "
            f"time p50 {statistics.median(direct_s[1:]):.4f}s (steps 1-{S - 1})")

        # (c) the trainer
        fit_c = pretrain_fit(cfg, ds, storage, "c", "phase 4p (c)")
        res_c = fit_c["result"]
        if res_c.error is not None:
            fail(f"phase 4p (c): fit() failed: {res_c.error!r}")
        hist = [m for m in res_c.metrics_history]
        losses = [m["loss"] for m in hist]
        gaps = [abs(a - b) for a, b in zip(losses, direct)]
        step_s = [m["step_s"] for m in hist]
        waits = [m["wait_s"] for m in hist]
        log(f"phase 4p (c) fit(): losses {[round(x, 5) for x in losses]}; step 0 "
            f"{losses[0]!r} against (b)'s {direct[0]!r}; largest |loss - (b)| "
            f"{max(gaps):.3e} (tol {LOSS_GAP_TOL})")
        if [m["step"] for m in hist] != list(range(S)):
            fail(f"phase 4p (c): reported steps {[m['step'] for m in hist]}")
        if losses[0] != direct[0]:
            fail(f"phase 4p (c): step 0's loss {losses[0]!r} is not (b)'s {direct[0]!r}")
        if max(gaps) > LOSS_GAP_TOL:
            fail(f"phase 4p (c): a loss differs from train.lm's by {max(gaps):.3e}")
        launches_c = fit_c["launches"]
        log(f"launches on the pretrain path, (c)'s fit ({S} steps): {launches_c}")
        for name, n in train_launches(cfg, S).items():
            if launches_c[name] != n:
                fail(f"phase 4p (c) launched {name} {launches_c[name]} times, expected {n}")
        kept = checkpoint_checks(res_c, "phase 4p (c)")
        if [k[0] for k in kept] != list(PRETRAIN_CKPT_STEPS[-2:]):
            fail(f"phase 4p (c): checkpoints kept {[k[0] for k in kept]}, not the last two")
        for s, want, got, _, n in kept:
            if got != want or n != s + 1:
                fail(f"phase 4p (c): the step-{s} checkpoint does not hold the reported "
                     f"parameters (state step {n})")
        writes = [m for m in hist if "write_s" in m]
        snaps = [m["snapshot_s"] for m in hist if "snapshot_s" in m]
        ck_bytes = writes[-1]["ckpt_bytes"]
        step_p50, direct_p50 = statistics.median(step_s[1:]), statistics.median(direct_s[1:])
        tok_s = B * T / step_p50
        log(f"phase 4p (c) ({card}): step time through fit() p50 {step_p50:.4f}s against "
            f"train.lm directly {direct_p50:.4f}s; {tok_s:.1f} tokens/s, MFU "
            f"{6 * n_params * B * T / step_p50 / 989e12:.4f} (6 N tokens / step time / "
            f"989e12, N {n_params / 1e9:.4f} B); the host's wait inside next() of the device "
            f"iterator per step p50 {1e3 * statistics.median(waits):.3f} ms max "
            f"{1e3 * max(waits):.3f} ms; checkpoint {ck_bytes / 1e9:.3f} GB: card-to-host "
            f"snapshot {[round(x, 4) for x in snaps]} s ({ck_bytes / 1e9 / statistics.median(snaps):.2f} "
            f"GB/s p50), write {[round(m['write_s'], 3) for m in writes]} s "
            f"({ck_bytes / 1e9 / statistics.median([m['write_s'] for m in writes]):.2f} GB/s "
            f"p50), the next step's wait for the write "
            f"{[round(m['ckpt_wait_s'], 3) for m in hist if 'ckpt_wait_s' in m]} s; "
            f"load_pytree {[round(k[3], 3) for k in kept]} s; fit() {fit_c['wall']:.2f}s")
        if len([n for n in os.listdir(res_c.path) if n.startswith("step")]) != 2:
            fail("phase 4p (c): num_to_keep=2 left another number of checkpoint directories")

        # (d) a restart that resumes from step 7's checkpoint
        fit_d = pretrain_fit(cfg, ds, storage, "d", "phase 4p (d)", fail_at=PRETRAIN_FAIL_AT)
        res_d, marks = fit_d["result"], fit_d["marks"]
        hist_d = res_d.metrics_history
        resumed = [m for m in hist_d if m["attempt"] == 2]
        gap_d = max(abs(m["loss"] - losses[m["step"]]) for m in resumed) if resumed else math.inf
        entered = marks.get("entered", []) + [math.nan, math.nan]
        overhead = marks.get("resumed_at", math.nan) - marks.get("failed_at", math.nan)
        log(f"phase 4p (d) ({card}): attempts {marks.get('attempts')}, first attempt's steps "
            f"{[m['step'] for m in hist_d if m['attempt'] == 1]}, resumed steps "
            f"{[m['step'] for m in resumed]}; largest |loss - (c)| over them {gap_d:.3e}; restart "
            f"overhead (failure to the first resumed step) {overhead:.3f}s: the gang's "
            f"restart {entered[1] - marks.get('failed_at', math.nan):.3f}s, then load_pytree "
            f"{marks.get('resume_load_s', math.nan):.3f}s and the skipped batches; fit() "
            f"{fit_d['wall']:.2f}s against (c)'s {fit_c['wall']:.2f}s (each: call to the "
            f"first loop entry {entered[0] - marks['called']:.3f} / "
            f"{fit_c['marks']['entered'][0] - fit_c['marks']['called']:.3f}s, the loop's end to "
            f"fit()'s return {marks['returned'] - marks.get('ended', math.nan):.3f} / "
            f"{fit_c['marks']['returned'] - fit_c['marks']['ended']:.3f}s: the loop's end to "
            f"its run's return {marks['run_returned'] - marks['ended']:.3f} / "
            f"{fit_c['marks']['run_returned'] - fit_c['marks']['ended']:.3f}s, to fit()'s "
            f"last poll's end {marks['last_poll_end'] - marks['ended']:.3f} / "
            f"{fit_c['marks']['last_poll_end'] - fit_c['marks']['ended']:.3f}s (longest poll "
            f"{marks['poll_max_s']:.3f} / {fit_c['marks']['poll_max_s']:.3f}s; registering each "
            f"reported checkpoint, num_to_keep=2 deleting the oldest: "
            f"{[round(x, 3) for x in marks.get('register_s', [])]} / "
            f"{[round(x, 3) for x in fit_c['marks'].get('register_s', [])]}s), the gang's "
            f"teardown {[round(x, 3) for x in marks.get('teardown_s', [])]} / "
            f"{[round(x, 3) for x in fit_c['marks'].get('teardown_s', [])]}s)")
        if res_d.error is not None or marks.get("attempts") != 2:
            fail(f"phase 4p (d): {res_d.error!r} after {marks.get('attempts')} attempts")
        if [m["step"] for m in resumed] != list(range(PRETRAIN_CKPT_STEPS[1] + 1, S)):
            fail(f"phase 4p (d): resumed at steps {[m['step'] for m in resumed]}, not from "
                 f"step {PRETRAIN_CKPT_STEPS[1]}'s checkpoint")
        if gap_d > LOSS_GAP_TOL:
            fail(f"phase 4p (d): a resumed loss differs from (c)'s by {gap_d:.3e}")
        if abs(fit_d["mem1"] - fit_d["mem0"]) > PRETRAIN_MEMORY_TOL:
            fail(f"phase 4p (d): card memory {fit_d['mem0'] / 2**30:.3f} GiB before fit(), "
                 f"{fit_d['mem1'] / 2**30:.3f} after")
        if fit_d["threads_left"]:
            fail(f"phase 4p (d): threads outlived fit(): {fit_d['threads_left']}")

        # (e) serve the checkpoint (c) kept last
        torch.cuda.synchronize()
        mem_e0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loaded = train.load_pytree(os.path.join(res_c.checkpoint.path, "state"))
        load_s = time.perf_counter() - t0
        params = loaded["params"]
        del loaded
        sums = list(leaf_checksums(params).values())
        if sums != kept[-1][1]:
            fail("phase 4p (e): the served weights are not step 11's")
        torch.cuda.synchronize()
        mem_p = torch.cuda.memory_allocated()  # the loaded tree, which this phase holds on
        runtime_threads = set(threading.enumerate())
        t0 = time.monotonic()
        handle = serve.run(serve.LLMServer.bind(
            model_name="llama-2b", params_fn=lambda: (params, cfg), engine_config=ENGINE),
            name="pretrained")
        ((replica, ready_s),) = wait_ready("llm", 1, t0, "phase 4p (e)")  # LLMServer's name
        dispatch.reset_launches()
        requests = burst_requests(cfg, torch.Generator().manual_seed(5))
        results, _, wall = handle_burst(handle, requests, "phase 4p (e)")
        launches_e = dispatch.launch_counts()
        require_no_eager_launches("phase 4p (e)")
        figures = report_burst("phase 4p (e)", requests, results, wall)
        gaps_e = logprob_gaps(params, cfg, requests, results)
        log(f"phase 4p (e) ({card}): load_pytree of step 11's checkpoint onto the card "
            f"{load_s:.3f}s; the replica built and warmed in {ready_s:.1f}s; {figures}; "
            f"logprob |engine - forward| per request max {[round(g[0], 4) for g in gaps_e]} "
            f"mean {[round(g[1], 4) for g in gaps_e]} (tol {LOGPROB_TOL}); launches {launches_e}")
        for i, gap in enumerate(gaps_e):
            if not within_logprob_tol(gap):
                fail(f"phase 4p (e) request {i}: logprobs differ from the forward by max "
                     f"{gap[0]:.4f}, mean {gap[1]:.4f}")
        for name in SERVE_KERNELS:
            if launches_e[name] <= 0:
                fail(f"phase 4p (e) never launched kernel {name}")
        long_prompt = {"prompt_ids": requests[3]["prompt_ids"], "max_tokens": 4}
        short_prompt = {"prompt_ids": requests[1]["prompt_ids"], "max_tokens": 4}
        names = launched_kernels(lambda: (handle.remote(short_prompt).result(timeout=300),
                                          handle.remote(long_prompt).result(timeout=300)))
        stems = ("flash_fwd_wgmma_kernel", "paged_chunk_wgmma_kernel",
                 "paged_decode_split_kernel", "paged_combine_kernel", "rms_norm_fwd_vec_kernel")
        log(f"phase 4p (e): kernels of a 100- and a 700-token prompt under the profiler, by "
            f"name: " + "; ".join(
                f"{stem} x{sum(stem in n for n in names)} "
                f"({next((n[:110] for n in names if stem in n), 'none')})" for stem in stems))
        require_kernels("phase 4p (e)", names, stems)
        del handle, replica
        left, kept_e = retire(runtime_threads)
        log(f"phase 4p (e): after serve.shutdown() threads left {left or 'none'}; the retired "
            f"replica left {kept_e / 2**30:.3f} GiB of card memory beside the loaded tree "
            f"(tol {SERVE_RETIRED_MEMORY_TOL / 2**30:.2f} GiB)")
        if left:
            fail(f"phase 4p (e): threads outlived serve.shutdown(): {left}")
        if kept_e > SERVE_RETIRED_MEMORY_TOL:
            fail(f"phase 4p (e): the retired replica's engine kept {kept_e / 2**30:.3f} GiB")
        # planted fault replica_kept_after_shutdown: the killed actor keeps its instance
        with swapped(node_agent, _release_instance=lambda runner: None):
            planted_handle = serve.run(serve.LLMServer.bind(
                model_name="llama-2b", params_fn=lambda: (params, cfg), engine_config=ENGINE),
                name="pretrained")
            planted_handle.remote(short_prompt).result(timeout=300)
            del planted_handle
            _, kept_planted = retire(runtime_threads)
        caught_replica = kept_planted > SERVE_RETIRED_MEMORY_TOL
        log(f"phase 4p planted fault replica_kept_after_shutdown: the retired replica left "
            f"{kept_planted / 2**30:.3f} GiB: the memory gate fails {caught_replica}")
        del params
        release()
        log(f"phase 4p (e): card memory {mem_e0 / 2**30:.3f} GiB before load_pytree, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} after with the loaded tree dropped")

        # (f) the planted faults
        with swapped(train, AsyncCheckpointWriter=late_snapshot_writer()):
            late = pretrain_fit(cfg, ds, storage, "f1", "phase 4p planted checkpoint_after_update",
                                steps=3, ckpt_steps=(1,))
        late_kept = checkpoint_checks(late["result"], "phase 4p planted checkpoint_after_update")
        caught_late = any(got != want for _, want, got, _, _ in late_kept)
        log(f"phase 4p planted fault checkpoint_after_update: the checkpoint's checksums differ "
            f"from those reported at its step {caught_late}")
        with swapped(core_worker, release_frames=lambda error: None):
            kept_state = pretrain_fit(cfg, ds, storage, "f2", "phase 4p planted restart_keeps_state",
                                      steps=5, ckpt_steps=(1,), fail_at=3)
        caught_kept = abs(kept_state["mem1"] - kept_state["mem0"]) > PRETRAIN_MEMORY_TOL
        log(f"phase 4p planted fault restart_keeps_state: card memory "
            f"{kept_state['mem0'] / 2**30:.3f} GiB before fit(), {kept_state['mem1'] / 2**30:.3f} "
            f"after: the memory gate fails {caught_kept}")
        for name, hit in (("checkpoint_after_update", caught_late),
                          ("restart_keeps_state", caught_kept),
                          ("replica_kept_after_shutdown", caught_replica)):
            if not hit:
                fail(f"phase 4p: its gates pass planted fault {name}")
    finally:
        serve.shutdown()
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        release()
    log(f"phase 4p: card memory after the runtime's shutdown {torch.cuda.memory_allocated() / 2**30:.3f} "
        f"GiB; the phase took {time.monotonic() - t_phase:.1f}s ({card})")
    return {"launches": {name: launches_c[name] + launches_e[name] for name in launches_c}}


# ------------------------------------------------------------- phase 4i

# llama-2b pretraining fed by worker processes: synthetic documents, packed
# into rows by map_batches tasks in the worker-process pool and shifted into
# inputs and targets by a callable class's actor pool, in actor processes
PROCS_DOCS = 96  # documents, their lengths drawn uniformly from PROCS_DOC_TOKENS
PROCS_DOC_TOKENS = (256, 3072)
PROCS_BLOCKS = 8  # blocks of documents: packing tasks
PROCS_POOL_ACTORS = 2
PROCS_PACK_STALL_S = 0.05  # a tokenizer's time per block, stood in by a sleep
PROCS_STAGED_BYTES = 180 * 2**20  # under 3/4 of the 256 MiB staging arena: staged
PROCS_CHUNKED_BYTES = 300 * 2**20  # past the arena: the chunked fallback
PROCS_FAULTS = ("pool_runs_in_process", "child_touches_cuda", "buffer_released_before_copy")
PROCS_CHILD_WAIT_S = 10.0
PROCS_DEVICE = "cuda"  # where gate (d)'s tensor lives


def procs_documents(cfg) -> dict:
    """PROCS_DOCS token-id documents of llama-2b's vocabulary from numpy seed
    0, zero-padded into one [docs, longest] int32 array beside their lengths
    (a block of rows is what the Dataset holds)."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(*PROCS_DOC_TOKENS, PROCS_DOCS).astype(np.int32)
    docs = np.zeros((PROCS_DOCS, int(lengths.max())), np.int32)
    for i, n in enumerate(lengths):
        docs[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return {"doc": docs, "len": lengths}


def pack_documents(block, width: int):
    """The packing task: a block's documents, each followed by id 0 (the
    end of a document), cut into rows of `width` ids; the tail that does
    not fill a row is dropped. Also the pid it ran in."""
    time.sleep(PROCS_PACK_STALL_S)
    stream = np.concatenate([np.append(d[:n], 0) for d, n in zip(block["doc"], block["len"])])
    rows = stream[:len(stream) // width * width].reshape(-1, width).astype(np.int32)
    return {"ids": rows, "pack_pid": np.full(len(rows), os.getpid(), np.int64)}


class ShiftTokens:
    """The actor pool's callable class: rows -> inputs and targets, and the
    pid of the actor that shifted them."""

    def __init__(self):
        self.pid = os.getpid()

    def __call__(self, batch):
        ids = batch["ids"]
        return {"tokens": ids[:, :-1], "targets": ids[:, 1:], "pack_pid": batch["pack_pid"],
                "shift_pid": np.full(len(ids), self.pid, np.int64)}


def procs_dataset(docs: dict):
    from ray_tpu_torch import data

    return (data.from_numpy(docs, parallelism=PROCS_BLOCKS)
            .map_batches(pack_documents, fn_kwargs={"width": PRETRAIN_BATCH[1] + 1})
            .map_batches(ShiftTokens, compute="actors", concurrency=PROCS_POOL_ACTORS))


def procs_epoch(ds) -> dict:
    """Every row of one epoch through iter_batches, in order, as arrays."""
    cols: dict = {}
    for batch in ds.iter_batches(batch_size=PRETRAIN_BATCH[0], drop_last=False):
        for k, v in batch.items():
            cols.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in cols.items()}


def process_tree() -> dict:
    """{pid: command line} of every live descendant of this process."""
    parents, cmds = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if fields[0] != "Z":
            parents[int(entry)], cmds[int(entry)] = int(fields[1]), cmd
    out, frontier = {}, [os.getpid()]
    while frontier:
        p = frontier.pop()
        for child, parent in parents.items():
            if parent == p and child not in out:
                out[child] = cmds[child]
                frontier.append(child)
    return out


def cuda_in(pid: int) -> list:
    """What of the card a process holds: its open /dev/nvidia* files and its
    libcuda* mappings (read from /proc)."""
    found = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                found.append(target)
        with open(f"/proc/{pid}/maps") as f:
            found += sorted({line.split()[-1] for line in f if "libcuda" in line})
    except OSError:
        pass
    return found


_IMPORT_BASELINE = None


def import_baseline() -> set:
    """What of the card a fresh interpreter holds once it has imported the
    package, as the forkserver does, before any CUDA call: torch's import
    maps the CUDA runtime and driver libraries (no device file opens until
    CUDA starts). Gate (a) lets a child hold these and nothing more."""
    global _IMPORT_BASELINE
    if _IMPORT_BASELINE is None:
        import inspect

        code = (f"import json, os, sys\nsys.path.insert(0, {HERE!r})\nimport ray_tpu_torch\n"
                f"{inspect.getsource(cuda_in)}\nprint(json.dumps(cuda_in(os.getpid())))")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, check=True)
        _IMPORT_BASELINE = set(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"phase 4i: a fresh interpreter that imports ray_tpu_torch holds "
            f"{sorted(_IMPORT_BASELINE) or 'nothing'} of the card")
    return _IMPORT_BASELINE


def compute_apps() -> list:
    """nvidia-smi's compute apps (pids of the card's host; a container's
    own pids may differ, so gate (a) counts them)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def child_report(label: str) -> tuple:
    """Gate (a)'s reading of the children now: ({pid: what of the card it
    holds beyond import_baseline()} for every descendant holding more,
    nvidia-smi's compute apps)."""
    base = import_baseline()
    held = {pid: [x for x in cuda_in(pid) if x not in base] for pid in process_tree()}
    held = {pid: h for pid, h in held.items() if h}
    apps = compute_apps()
    log(f"{label}: {len(process_tree())} processes under the driver (pid {os.getpid()}); "
        f"holding the card beyond the import: {held or 'none'}; nvidia-smi compute apps {apps}")
    return held, apps


def card_sum(t):
    return os.getpid(), float(t.sum())


def read_flag():
    return os.environ.get("RTT_PROCS_FLAG"), os.getpid()


def procs_pids(_):
    return os.getpid()


def procs_fit(cfg, ds, storage: str, name: str, chaos=None) -> dict:
    """One TorchTrainer.fit() of PRETRAIN_STEPS steps at llama-2b on the
    card (phase 4f's recipe from seed 0), fed by iter_device_batches over
    `ds`; its gang member runs in this process. Each step reports its loss;
    the transform on the host keeps each batch's rows and pids. `chaos`
    runs on its own thread while the fit runs. -> {"result", "rows",
    "pids", "launches", "wall", "mid"}."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import dispatch

    seen = {"tokens": [], "pack_pid": [], "shift_pid": []}

    def transform(batch):
        for k in seen:
            seen[k].append(np.asarray(batch[k]))
        return {"tokens": batch["tokens"], "targets": batch["targets"]}

    marks = {}

    def loop(config):
        opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        bf16_params(state)
        step = train.make_train_step(cfg, opt)
        batches = iter(train.get_dataset_shard("train").iter_device_batches(
            batch_size=PRETRAIN_BATCH[0], transform=transform))
        for i in range(PRETRAIN_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            step_s = time.perf_counter() - t0
            if i == PRETRAIN_STEPS // 2:  # mid-epoch: the children as they are
                marks["mid"] = child_report(f"phase 4i ({name}) at step {i}")
            train.report({"step": i, "loss": loss, "step_s": step_s})

    trainer = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name=name, storage_path=storage), datasets={"train": ds})
    stop = threading.Event()
    chaos_thread = None
    if chaos is not None:
        chaos_thread = threading.Thread(target=chaos, args=(stop,), name="phase4i-chaos")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.monotonic()
    if chaos_thread is not None:
        chaos_thread.start()
    try:
        result = trainer.fit()
    finally:
        stop.set()
        if chaos_thread is not None:
            chaos_thread.join(timeout=60)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dispatch.launch_counts()
    if result.error is not None:
        fail(f"phase 4i ({name}): fit() failed: {result.error!r}")
    # the host stage runs ahead of the steps: the rows the steps took come first
    return {"result": result, "launches": launches, "wall": wall, "mid": marks.get("mid"),
            "rows": np.concatenate(seen["tokens"])[:PRETRAIN_BATCH[0] * PRETRAIN_STEPS],
            "pids": set(np.concatenate(seen["pack_pid"] + seen["shift_pid"]).tolist())}


def kill_mid_epoch(pool_fn, actor_pids_fn, killed: dict):
    """The chaos of gate (c): SIGKILL the newest pool task's worker as soon as
    one is in flight, and one pool actor's process once it has started."""
    import signal

    def chaos(stop):
        deadline = time.monotonic() + 120
        while not stop.is_set() and time.monotonic() < deadline and len(killed) < 2:
            pool = pool_fn()
            if "worker" not in killed and pool:
                pid = pool.kill_newest_worker()
                if pid is not None:
                    killed["worker"] = pid
            if "actor" not in killed:
                pids = actor_pids_fn()
                if pids:
                    time.sleep(0.1)  # it has taken its first block by now
                    try:
                        os.kill(pids[0], signal.SIGKILL)
                        killed["actor"] = pids[0]
                    except OSError:
                        pass
            time.sleep(0.001)

    return chaos


def pool_actor_pids(runtime) -> list:
    """Pids of the live actor processes of data's actor pool."""
    agent = runtime.driver_agent
    with agent._lock:
        runners = list(agent._actors.values())
    return [r.process.pid for r in runners
            if r.process is not None and r.process.alive()
            and "_MapPoolWorker" in repr(r.instance)]


def transfer_figures(card: str) -> list:
    """Gate (e): a ~180 MiB host blob between two transfer endpoints in this
    process natively (handoff off) and through the same-host shm handoff,
    and a 300 MiB one over the chunked fallback; each byte-equal, with its
    GB/s. -> the three [path, bytes, seconds] rows."""
    from ray_tpu_torch.core import object_transfer as ot
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.ids import ObjectID, TaskID
    from ray_tpu_torch.core.object_store import MemoryObjectStore

    rng = np.random.default_rng(1)
    store = MemoryObjectStore(capacity_bytes=2 * PROCS_CHUNKED_BYTES)
    server = ot.ObjectTransferServer(store)
    client = ot.ObjectTransferClient()
    rows = []
    try:
        deadline = time.monotonic() + 60
        while server._plane.native is None and time.monotonic() < deadline:
            time.sleep(0.01)
        warm = ObjectID.for_task_return(TaskID.of(), 0)
        store.put(warm, np.zeros(16))
        config.apply_overrides({"object_transfer_shm_handoff": False})
        client.pull(server.address, warm)  # starts the client's native plane
        while client._plane.native is None and time.monotonic() < deadline:
            time.sleep(0.01)
        for path, nbytes, handoff in (("native", PROCS_STAGED_BYTES, False),
                                      ("shm", PROCS_STAGED_BYTES, True),
                                      ("chunked", PROCS_CHUNKED_BYTES, True)):
            blob = rng.integers(0, 255, nbytes, dtype=np.uint8)
            oid = ObjectID.for_task_return(TaskID.of(), 0)
            store.put(oid, blob)
            config.apply_overrides({"object_transfer_shm_handoff": handoff})
            client._call(server.address, "stage", oid.hex(), False)  # staged before the clock
            before = ot._pull_seconds.count({"path": path})
            t0 = time.perf_counter()
            got = client.pull(server.address, oid)
            dt = time.perf_counter() - t0
            took = ot._pull_seconds.count({"path": path}) - before
            equal = bool(np.array_equal(got, blob))
            log(f"phase 4i (e) ({card}): a {nbytes / 2**20:.0f} MiB blob over the {path} path "
                f"in {dt:.4f}s, {nbytes / dt / 1e9:.3f} GB/s; byte-equal {equal}; the pull took "
                f"that path {took} time(s)")
            if not equal or took != 1:
                fail(f"phase 4i (e): the {path} pull of {nbytes} bytes: equal {equal}, "
                     f"took the path {took} times")
            rows.append([path, nbytes, dt])
            store.delete(oid)
            del got, blob
    finally:
        config.apply_overrides({"object_transfer_shm_handoff": True})
        client.close()
        server.stop()
    return rows


def procs_path(card: str) -> dict:
    """Phase 4i: llama-2b pretraining fed by worker processes, at the
    runtime's defaults (worker processes and actor processes on).
    The pipeline: data.from_numpy of PROCS_DOCS synthetic documents (numpy
    seed 0, llama-2b's vocabulary) in PROCS_BLOCKS blocks; map_batches
    tasks pack them into [N, 2049] rows (pack_documents, in the pool);
    a callable class's actor pool shifts them into inputs and targets
    (ShiftTokens, in actor processes); iter_device_batches(batch_size=4)
    feeds TorchTrainer.fit at llama-2b, full width and depth, for
    PRETRAIN_STEPS steps, its gang member on the card in this process.
    (a) Every packing task and pool actor ran in a pid not this one; no
        child process holds a /dev/nvidia* file or maps a libcuda* library
        beyond what importing the package maps in a fresh interpreter
        (import_baseline), read mid-fit and after; nvidia-smi lists one
        compute app, the driver's.
    (b) The epoch's rows bit-equal to the same pipeline in thread mode; the
        fit's losses bit-equal to train.lm over those rows from the same
        weights; launches exactly train_launches.
    (c) A second fit while the newest pool task's worker and one pool actor
        are SIGKILLed mid-epoch: the tasks retry and the actor restarts; its
        rows and losses equal (b)'s.
    (d) A CPU task given a CUDA tensor runs in this pid and the fallback
        counter rises by 1; a runtime_env env_vars task reads its variable
        in a worker; util.multiprocessing.Pool.map runs in worker pids.
    (e) The transfer plane (transfer_figures).
    (f) After rt.shutdown(): no child process but multiprocessing's
        resource tracker within PROCS_CHILD_WAIT_S, no /dev/shm segment of
        this run's names, card memory within PRETRAIN_MEMORY_TOL of before.
    Planted faults (PROCS_FAULTS): pool_runs_in_process (gate a),
    child_touches_cuda (the CUDA-tensor rule removed: gate a),
    buffer_released_before_copy (the lane frees a task's result buffers
    before the driver copies them out: gate b). Prints `df /dev/shm`, the
    forkserver's boot, a pool task's round trip and a shm put/get in GB/s.
    Returns {"launches": (b)'s}."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.core import node_agent, process_pool, shm_store
    from ray_tpu_torch.core.config import config as rtconfig
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.util import multiprocessing as rtmp

    t_phase = time.monotonic()
    cfg = get_config("llama-2b")
    (B, T), S = PRETRAIN_BATCH, PRETRAIN_STEPS
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True, text=True).stdout
    log(f"phase 4i: df -h /dev/shm:\n{df.rstrip()}")
    docs = procs_documents(cfg)
    driver = os.getpid()
    before_tree = set(process_tree())
    import_baseline()  # read once, before any fit
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    storage = tempfile.mkdtemp(prefix="phase4i-")

    def fallbacks() -> float:
        return sum(v for _, _, v in node_agent._pool_fallback_counter.samples())

    def run_names() -> list:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(("rtt_pool_", "rtt_xs_", "rtt_xc_"))
                      and f"_{driver}_" in n)

    def children_hold_card(held, apps) -> bool:  # the driver's context is the one app
        return bool(held) or len(apps) > 1

    try:
        # (b)'s yardstick rows: the pipeline in thread mode
        rt.shutdown()
        rt.init(system_config=RUNTIME_FLAGS)
        want = procs_epoch(procs_dataset(docs))
        rt.shutdown()
        n_rows = len(want["tokens"])
        log(f"phase 4i: llama-2b (d_model {cfg.d_model}, layers {cfg.n_layers}), {PROCS_DOCS} "
            f"documents of {PROCS_DOC_TOKENS} tokens in {PROCS_BLOCKS} blocks packed into "
            f"{n_rows} rows of {T + 1} ids (thread mode); {S} steps of {B} x {T}")
        if n_rows < B * S:
            fail(f"phase 4i: the documents pack into {n_rows} rows, fewer than {B * S}")

        # the runtime at its defaults; its first pool task waits for the
        # forkserver's boot (the server imports the package) and a fork
        t0 = time.monotonic()
        runtime = rt.init()
        cfg_procs = (int(rtconfig.worker_processes), bool(rtconfig.actor_processes))
        pool = runtime.driver_agent._ensure_pool()
        pool.run(procs_pids, (0,), {})
        boot_s = time.monotonic() - t0
        trips = []
        for _ in range(50):
            t1 = time.perf_counter()
            pool.run(procs_pids, (0,), {})
            trips.append(time.perf_counter() - t1)
        arena = shm_store.ShmObjectStore(f"/rtt_pool_{driver}_bw", capacity=512 * 2**20)
        blob = np.random.default_rng(2).integers(0, 255, 256 * 2**20, dtype=np.uint8)
        oid = b"procs-bandwidth-0000"
        t1 = time.perf_counter()
        arena.put(oid, blob)
        put_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        back = arena.get_bytes(oid)
        get_s = time.perf_counter() - t1
        arena.close()
        if back != blob.tobytes():
            fail("phase 4i: the shm store's get differs from its put")
        del back
        log(f"phase 4i ({card}): worker_processes {cfg_procs[0]}, actor_processes "
            f"{cfg_procs[1]}; init() to the first pool task's return (the forkserver's boot "
            f"and a fork) {boot_s:.3f}s; a pool task's round trip p50 "
            f"{1e3 * statistics.median(trips):.3f} ms max {1e3 * max(trips):.3f} ms (50 calls); "
            f"a 256 MiB shm "
            f"put {blob.nbytes / put_s / 1e9:.3f} GB/s, get (copy out) "
            f"{blob.nbytes / get_s / 1e9:.3f} GB/s")
        del blob
        if cfg_procs[0] <= 0 or not cfg_procs[1]:
            fail(f"phase 4i: init() at its defaults gave {cfg_procs}")

        # (a) + (b): the fit
        fit_b = procs_fit(cfg, procs_dataset(docs), storage, "b")
        losses = [m["loss"] for m in fit_b["result"].metrics_history]
        steps = [m["step_s"] for m in fit_b["result"].metrics_history]
        held_mid, apps_mid = fit_b["mid"]
        held_end, apps_end = child_report("phase 4i (a) after the fit")
        in_driver = driver in fit_b["pids"]
        log(f"phase 4i (a): the packing tasks and pool actors ran in pids "
            f"{sorted(fit_b['pids'])} (driver {driver})")
        if in_driver or not fit_b["pids"]:
            fail(f"phase 4i (a): work ran in the driver's process: {sorted(fit_b['pids'])}")
        if children_hold_card(held_mid, apps_mid) or children_hold_card(held_end, apps_end):
            fail(f"phase 4i (a): a child process holds the card: {held_mid or held_end}, "
                 f"apps {apps_mid} / {apps_end}")
        rows_equal = np.array_equal(fit_b["rows"], want["tokens"][:B * S])
        # the yardstick: train.lm directly over the thread-mode rows
        opt = train.make_optimizer(learning_rate=3e-4, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        bf16_params(state)
        step = train.make_train_step(cfg, opt)
        direct, direct_s = [], []
        for i in range(S):
            batch = {k: torch.from_numpy(np.ascontiguousarray(want[k][B * i:B * (i + 1)])).cuda()
                     for k in ("tokens", "targets")}
            t1 = time.perf_counter()
            state, m = step(state, batch)
            direct.append(float(m["loss"]))
            direct_s.append(time.perf_counter() - t1)
        del state, step, m, batch
        release()
        log(f"phase 4i (b): the fit's {len(fit_b['rows'])} rows bit-equal to thread mode's "
            f"{rows_equal}; losses {[round(x, 5) for x in losses]}; bit-equal to train.lm's "
            f"{losses == direct}")
        log(f"phase 4i (b) ({card}): step time through fit() p50 {statistics.median(steps[1:]):.4f}s "
            f"against train.lm directly {statistics.median(direct_s[1:]):.4f}s; fit() "
            f"{fit_b['wall']:.2f}s")
        if not rows_equal:
            fail("phase 4i (b): the fit's rows differ from the thread-mode pipeline's")
        if losses != direct:
            fail(f"phase 4i (b): losses {losses} are not train.lm's {direct}")
        launches = fit_b["launches"]
        log(f"launches on the procs path, (b)'s fit ({S} steps): {launches}")
        for name, n in train_launches(cfg, S).items():
            if launches[name] != n:
                fail(f"phase 4i (b) launched {name} {launches[name]} times, expected {n}")

        # (c): the same fit while a worker and a pool actor are killed
        killed: dict = {}
        chaos = kill_mid_epoch(lambda: runtime.driver_agent._pool,
                               lambda: pool_actor_pids(runtime), killed)
        fit_c = procs_fit(cfg, procs_dataset(docs), storage, "c", chaos=chaos)
        losses_c = [m["loss"] for m in fit_c["result"].metrics_history]
        epoch_c = procs_epoch(procs_dataset(docs))
        log(f"phase 4i (c): SIGKILLed {killed}; the fit's rows equal (b)'s "
            f"{np.array_equal(fit_c['rows'], fit_b['rows'])}, losses equal "
            f"{losses_c == losses}; a second epoch's rows equal thread mode's "
            f"{np.array_equal(epoch_c['tokens'], want['tokens'])}")
        if set(killed) != {"worker", "actor"}:
            fail(f"phase 4i (c): killed only {killed}")
        if not np.array_equal(fit_c["rows"], fit_b["rows"]) or losses_c != losses:
            fail("phase 4i (c): after the kills the rows or the losses differ from (b)'s")
        if not np.array_equal(epoch_c["tokens"], want["tokens"]):
            fail("phase 4i (c): an epoch after the kills differs from thread mode's")

        # (d): where in-process work goes
        before = fallbacks()
        on_card = torch.arange(1024, dtype=torch.float32, device=PROCS_DEVICE)
        pid_d, total = rt.get(rt.remote(card_sum).remote(on_card), timeout=120)
        flag, pid_env = rt.get(rt.remote(read_flag).options(
            runtime_env={"env_vars": {"RTT_PROCS_FLAG": "on"}}).remote(), timeout=120)
        with rtmp.Pool(processes=2) as mp_pool:
            pool_pids = set(mp_pool.map(procs_pids, range(8)))
        log(f"phase 4i (d): a CUDA-tensor task ran in pid {pid_d} (driver {driver}), sum "
            f"{total}, fallbacks +{fallbacks() - before}; the env_vars task read {flag!r} in "
            f"pid {pid_env}; Pool.map ran in {sorted(pool_pids)}")
        if pid_d != driver or fallbacks() - before != 1 or total != 1023 * 1024 / 2:
            fail("phase 4i (d): the CUDA-tensor task left the driver's process or was not counted")
        if flag != "on" or pid_env == driver or driver in pool_pids:
            fail("phase 4i (d): the env_vars task or Pool.map ran in the driver's process")
        del on_card

        # (e): the transfer plane
        transfer = transfer_figures(card)

        # (f): cleanup
        rt.shutdown()
        del runtime, pool
        release()
        deadline = time.monotonic() + PROCS_CHILD_WAIT_S
        while True:
            left = {p: c for p, c in process_tree().items()
                    if p not in before_tree and "resource_tracker" not in c}
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        mem1 = torch.cuda.memory_allocated()
        log(f"phase 4i (f): after rt.shutdown() processes left {left or 'none'}; /dev/shm "
            f"segments of this run {run_names() or 'none'}; card memory {mem0 / 2**30:.3f} GiB "
            f"before the phase, {mem1 / 2**30:.3f} after")
        if left or run_names():
            fail(f"phase 4i (f): left behind {left} {run_names()}")
        if abs(mem1 - mem0) > PRETRAIN_MEMORY_TOL:
            fail(f"phase 4i (f): card memory {mem0} before, {mem1} after")

        # the planted faults, each on a runtime of its own
        copy_out = process_pool._copy_out

        def freed_before_copy(store, buffer_ids):
            for bid in buffer_ids:
                store.delete(bid)
            return copy_out(store, buffer_ids)

        def pool_runs_in_process():  # gate (a): the packing tasks' pids
            with swapped(process_pool.ProcessPool,
                         run=lambda self, fn, args, kwargs, **kw: fn(*args, **kwargs)):
                epoch = procs_epoch(procs_dataset(docs))
            return driver in set(epoch["pack_pid"].tolist())

        def child_touches_cuda():  # gate (a): the CUDA-tensor rule removed
            with swapped(process_pool, _off_cpu=lambda obj: False):
                on_card = torch.ones(8, device=PROCS_DEVICE)
                rt.get(rt.remote(card_sum).remote(on_card), timeout=300)
                held, apps = child_report("phase 4i planted child_touches_cuda")
            return children_hold_card(held, apps)

        def buffer_released_before_copy():  # gate (b): the epoch's rows
            with swapped(process_pool, _copy_out=freed_before_copy):
                try:
                    epoch = procs_epoch(procs_dataset(docs))
                except Exception as e:  # noqa: BLE001 — no rows, none equal to (b)'s
                    log(f"phase 4i planted buffer_released_before_copy: the epoch raised "
                        f"{e!r:.200}")
                    return True
            return not np.array_equal(epoch["tokens"], want["tokens"])

        planted_runs = {"pool_runs_in_process": pool_runs_in_process,
                        "child_touches_cuda": child_touches_cuda,
                        "buffer_released_before_copy": buffer_released_before_copy}
        for name in PROCS_FAULTS:
            rt.init()
            try:
                caught = planted_runs[name]()
            finally:
                rt.shutdown()
            log(f"phase 4i planted fault {name}: caught {caught}")
            if not caught:
                fail(f"phase 4i: its gates pass planted fault {name}")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        release()
    log(f"phase 4i: the phase took {time.monotonic() - t_phase:.1f}s ({card}); transfer rows "
        f"{[[p, n, round(s, 4)] for p, n, s in transfer]}")
    return {"launches": launches}


# ------------------------------------------------------------- phase 4t

# a Tuner of llama-2b trials under phase 4f's recipe, GPU actors sharing the
# card, each reading its batches as a tenant of one ingest service
TUNE_LRS = (0.0, 1e-4, 3e-4, 1e-3)
TUNE_HEAVY_LR = 1e-3  # its tenant weighs 3, the others 1
TUNE_MAX_T = 12
TUNE_SHARE = 0.25  # resources_per_trial {"GPU": 0.25}: four trials on the card
# fit() may leave this much more card memory allocated than it found
TUNE_MEMORY_TOL = 0.1 * 2**30
# what a stop may take beyond the step the trainable is inside when the
# controller decides: the stop's round trip to the runner's second lane, the
# report that raises, the unwinding and the kill's join of the lanes
STOP_SLACK_S = 0.25
# the weight-3 tenant's dispatches over a weight-1 tenant's while all four
# have blocks waiting: deficit round-robin gives 3
FAIR_SHARE_MIN = 2.0
PBT_LRS = (0.0, 1e-3)
PBT_MUTATIONS = [3e-4, 1e-3]
PBT_INTERVAL = 4
# PBT trials take 11 steps: PBT consults a trial at every multiple of the
# interval, its last report included, and a bottom trial exploited at its
# last step restarts from a checkpoint before it, runs to that step again
# and is exploited again, without end (the reference's controller and
# scheduler do the same; its tests checkpoint every step)
PBT_STEPS = 11
# the longest the lr-0 trial waits at a milestone for the controller to take
# the other trial's report of it (see pbt_trainable)
PBT_TURN_S = 120.0
TUNE_THREADS = ("actor-", "ingest-", "data-host-prefetch")


def tune_rows(cfg) -> "np.ndarray":
    """Phase 4t's token rows, [4 x TUNE_MAX_T, 2049] int32: phase 4f's batch
    (synthetic_batch seed 0) once a step, so that every trial's step 0 is
    4f's and a trial with a learning rate learns what 4f learns (its loss
    falls over the steps) while the lr-0 trial's stays at step 0's. Fresh
    rows would teach a trial nothing in 12 steps: on uniform tokens every
    lr stays at ln V, and a Zipf law's rows after 4f's batch made every
    lr > 0 jump to 13-20 nats at step 2 on the H100 (PERF.md, phase 4t)."""
    import numpy as np

    from ray_tpu_torch import train

    (B, T) = PRETRAIN_BATCH
    first = train.synthetic_batch(cfg, B, T, seed=0, device="cpu")
    head = torch.cat([first["tokens"], first["targets"][:, -1:]], dim=1).numpy()
    return np.tile(head, (TUNE_MAX_T, 1)).astype(np.int32)


def thread_launches(cfg, steps: int) -> dict:
    """The launches of `steps` training steps that the calling thread makes
    itself: the forward's K1 (2 x layers + 1) and K2 with lse (layers). The
    backward, remat's recompute of the forward included, runs on autograd's
    device thread, which the trials share: those launches are held in the
    fit's totals (train_launches of every trial's steps together)."""
    L = cfg.n_layers
    return {"rms_norm": (2 * L + 1) * steps, "flash_attention": L * steps,
            "flash_attention_lse": L * steps, "rms_norm_bwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def state_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in state_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in state_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def sorted_tree(tree):
    """Every dict of the tree with its keys sorted, as jax.tree maps and
    jax.device_get hand a dict back (the reference's flagship saves so)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def tune_threads() -> set:
    return {t for t in threading.enumerate() if t.name.startswith(TUNE_THREADS) and t.is_alive()}


def logging_next(dispatched: list):
    """FairShareScheduler.next that also notes each dispatch in
    `dispatched`: (tenant, the tenants' waiting blocks just before it)."""
    from ray_tpu_torch.data import tenant

    nxt = tenant.FairShareScheduler.next

    def logged(sched):
        waiting = {n: len(st.pending) for n, st in list(sched._tenants.items())}
        out = nxt(sched)
        if out is not None:
            dispatched.append((out[0], waiting))
        return out

    return logged


def fair_share(dispatched: list, weights: dict) -> tuple:
    """Over the dispatches made while every tenant had blocks waiting: the
    weight-3 tenant's count over the mean weight-1 tenant's, and how many
    dispatches that window held."""
    window = [t for t, waiting in dispatched
              if set(waiting) >= set(weights) and all(waiting[n] > 0 for n in weights)]
    heavy = [n for n, w in weights.items() if w > 1]
    light = [n for n, w in weights.items() if w == 1]
    light_mean = sum(window.count(n) for n in light) / max(len(light), 1)
    return sum(window.count(n) for n in heavy) / max(light_mean, 1e-9), len(window)


def tenant_drain(rows, label: str) -> tuple:
    """Four tenants (one at weight 3) register phase 4t's rows with one
    ingest service, start their epochs together and drain them to the card
    through iter_device_batches, on four threads: -> (fair_share ratio,
    the contended window's dispatches, shares)."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data import tenant

    weights = {f"drain-{i}": (3.0 if i == 0 else 1.0) for i in range(4)}
    svc = data.IngestService(pool_min=1, pool_max=1, autoscale=False,
                             quantum_bytes=2 * rows[0].nbytes)
    dispatched: list = []
    barrier = threading.Barrier(len(weights))
    got: dict = {}

    def drain(name, weight):
        it = svc.register(data.from_numpy({"tokens": rows}, parallelism=len(rows)),
                          tenant=name, weight=weight)
        barrier.wait(timeout=60)
        n = 0
        for b in it.iter_device_batches(batch_size=PRETRAIN_BATCH[0], device="cuda",
                                        transform=split_tokens):
            n += b["tokens"].shape[0]
        torch.cuda.current_stream().synchronize()
        got[name] = n
        it.deregister()

    try:
        with swapped(tenant.FairShareScheduler, next=logging_next(dispatched)):
            threads = [threading.Thread(target=drain, args=kv, name=f"tenant-{kv[0]}")
                       for kv in weights.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        shares = svc.shares()
    finally:
        svc.shutdown()
    ratio, window = fair_share(dispatched, weights)
    log_line = ", ".join(f"{n} (weight {weights[n]:g}) share {s['share']:.3f} blocks "
                         f"{int(s['served_blocks'])}" for n, s in sorted(shares.items()))
    log(f"{label}: four tenants drained {sorted(got.values())} rows each; while all four "
        f"waited, {window} dispatches, the weight-3 tenant's over a weight-1 tenant's "
        f"{ratio:.2f} (gate >= {FAIR_SHARE_MIN}); {log_line}")
    return ratio, window, got == {n: len(rows) for n in weights}


class StopTimes:
    """TuneController._stop_trial, timed: for each stop, when the controller
    decided and when the stop returned; a watcher thread notes when the
    trial's lane threads had ended and its state's tensors (weak references
    the trainable left in `held`) were freed, without holding the
    controller up."""

    def __init__(self, held: dict):
        from ray_tpu_torch.tune import tune_controller

        self.held = held
        self.stops: dict = {}
        self.watchers: list = []
        self._stop = tune_controller.TuneController._stop_trial
        self.cls = tune_controller.TuneController

    def __call__(self, ctl, trial, **kw):
        decided = time.monotonic()
        actor = ctl._actors.get(trial.trial_id)
        prefix = f"actor-{actor._actor_id.hex()[:8]}" if actor is not None else None
        lanes = [t for t in threading.enumerate() if prefix and t.name.startswith(prefix)]
        refs = list(self.held.get(trial.trial_id, []))
        rec = dict(early=kw.get("early"))
        rec["decided"] = decided
        self.stops.setdefault(trial.trial_id, []).append(rec)

        def watch():
            deadline = decided + 60.0
            while time.monotonic() < deadline and (any(t.is_alive() for t in lanes)
                                                   or any(r() is not None for r in refs)):
                time.sleep(0.002)
            rec.update(freed=time.monotonic() - decided,
                       lanes_alive=any(t.is_alive() for t in lanes),
                       state_alive=any(r() is not None for r in refs))

        watcher = threading.Thread(target=watch, daemon=True, name="stop-watch")
        watcher.start()
        self.watchers.append(watcher)
        self._stop(ctl, trial, **kw)
        rec["returned"] = time.monotonic() - decided

    def join(self) -> None:
        for w in self.watchers:
            w.join(timeout=90)

    def installed(self):
        return swapped(self.cls, _stop_trial=lambda ctl, trial, **kw: self(ctl, trial, **kw))


def tune_trainable(cfg, rows, marks: dict):
    """A trial as a user writes it: phase 4f's recipe at config["lr"], its
    batches from an IngestIterator of the shared service (its tenant named
    after the trial), a report after every step. `marks` (shared with the
    caller: trials run in this process) gets each trial's losses, step
    times, launches and weak references to its state."""
    def trainable(config):
        from ray_tpu_torch import data, train, tune
        from ray_tpu_torch.ops import dispatch

        trial = tune.get_context().experiment_name
        rec = marks["trials"].setdefault(trial, {"lr": config["lr"], "losses": [],
                                                 "step_s": [], "starts": [], "ends": []})
        it = data.IngestClient().register(
            data.from_numpy({"tokens": rows}, parallelism=len(rows)), tenant=trial,
            weight=3.0 if config["lr"] == TUNE_HEAVY_LR else 1.0)
        try:
            opt = train.make_optimizer(learning_rate=config["lr"], warmup_steps=2,
                                       total_steps=100, factored=True)
            state = train.init_train_state(cfg, opt, seed=0)
            bf16_params(state)
            marks["held"][trial] = [weakref.ref(t) for t in state_tensors(state)]
            step = train.make_train_step(cfg, opt)
            batches = iter(it.iter_device_batches(batch_size=PRETRAIN_BATCH[0], device="cuda",
                                                  transform=split_tokens))
            with dispatch.tallying_launches() as launches:
                rec["launches"] = launches
                for i in range(config["steps"]):
                    batch = next(batches)
                    rec["starts"].append(time.monotonic())
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    rec["losses"].append(float(m["loss"]))
                    rec["step_s"].append(time.perf_counter() - t0)
                    rec["ends"].append(time.monotonic())
                    tune.report({"loss": rec["losses"][-1], "training_iteration": i + 1})
        finally:
            it.deregister()

    return trainable


def pbt_trainable(cfg, rows, storage: str, marks: dict):
    """A PBT trial: phase 4f's recipe at config["lr"]; after every
    PBT_INTERVAL steps (before the last) it saves {params, opt_state, step}
    with save_pytree, its keys sorted, and reports the checkpoint; a trial
    handed a checkpoint restores it with load_pytree(target=<its own init
    state>) and skips the batches before it. Each incarnation's record
    (losses by step, what it restored, its copies alive at its start) goes
    to marks["pbt"][trial].
    PBT compares a trial at its milestone with the others' last reports and
    exploits only a source that has reported a checkpoint, so which trial
    runs ahead on the shared card decides whether an exploit happens at
    all. The lr-0 trial therefore reports each milestone only once the
    controller has taken another trial's report of the same milestone
    (marks["handled"], filled by handled_reports), or after PBT_TURN_S:
    then it is the bottom trial and that report's checkpoint its source."""
    def trainable(config):
        from ray_tpu_torch import data, train, tune
        from ray_tpu_torch.train.session import _get_session

        trial = tune.get_context().experiment_name
        session = _get_session()
        lives = marks["pbt"].setdefault(trial, [])
        rec = {"lr": config["lr"], "losses": {}, "held": [],
               "copies_alive": sum(any(r() is not None for r in life["held"])
                                   for life in lives)}
        lives.append(rec)
        it = data.IngestClient().register(
            data.from_numpy({"tokens": rows}, parallelism=len(rows)),
            tenant=f"{trial}-{len(lives)}", weight=1.0)
        try:
            opt = train.make_optimizer(learning_rate=config["lr"], warmup_steps=2,
                                       total_steps=100, factored=True)
            state = train.init_train_state(cfg, opt, seed=0)
            bf16_params(state)
            start, ckpt = 0, tune.get_checkpoint()
            if ckpt is not None:
                t0 = time.perf_counter()
                state = train.load_pytree(os.path.join(ckpt.path, "state"), target=state)
                rec["restore_s"] = time.perf_counter() - t0
                rec["restored"] = ckpt.get_metadata()
                start = rec["restored"]["iteration"]
            rec["held"] = [weakref.ref(t) for t in state_tensors(state)]
            marks["held"][trial] = rec["held"]
            step = train.make_train_step(cfg, opt)
            batches = iter(it.iter_device_batches(batch_size=PRETRAIN_BATCH[0], device="cuda",
                                                  transform=split_tokens))
            for i in range(config["steps"]):
                batch = next(batches)
                if i < start:
                    continue  # consumed by the trial this one restored
                state, m = step(state, batch)
                rec["losses"][i] = float(m["loss"])
                out = None
                if (i + 1) % PBT_INTERVAL == 0 and i + 1 < config["steps"]:
                    path = os.path.join(storage, f"{trial}-{len(lives)}-it{i + 1}")
                    t0 = time.perf_counter()
                    train.save_pytree(sorted_tree(state), os.path.join(path, "state"))
                    rec.setdefault("save_s", []).append(time.perf_counter() - t0)
                    out = train.Checkpoint(path)
                    out.set_metadata({"trial": trial, "life": len(lives) - 1,
                                      "iteration": i + 1})
                if config["lr"] == 0.0 and (i + 1) % PBT_INTERVAL == 0:
                    # until another trial's report of this milestone is taken,
                    # or this life is stopped (the report below then raises)
                    deadline = time.monotonic() + PBT_TURN_S
                    with marks["turn"]:
                        while not (any(n >= i + 1 for t, n in marks["handled"].items()
                                       if t != trial) or session._stopping.is_set()) \
                                and time.monotonic() < deadline:
                            marks["turn"].wait(0.05)
                tune.report({"loss": rec["losses"][i], "training_iteration": i + 1},
                            checkpoint=out)
        finally:
            it.deregister()

    return trainable


def handled_reports(marks: dict):
    """TuneController._handle_reports that, once the controller has taken a
    trial's reports, notes the trial's last reported iteration in
    marks["handled"] and wakes the trainables waiting on marks["turn"]."""
    from ray_tpu_torch.tune import tune_controller

    handle = tune_controller.TuneController._handle_reports

    def handled(controller, trial):
        handle(controller, trial)
        with marks["turn"]:
            marks["handled"][trial.trial_id] = trial.metric("training_iteration", 0)
            marks["turn"].notify_all()

    return handled


def _check_target_in_order(tree, target, where: str = "tree") -> None:
    """Planted fault restore_ignores_target_order: load_pytree's target check
    as it was, which refuses a dict whose keys come in another order."""
    if isinstance(target, dict):
        if not isinstance(tree, dict) or list(tree) != list(target):
            raise ValueError(f"load_pytree: {where}'s keys are not the target's, in order")
        for k in target:
            _check_target_in_order(tree[k], target[k], f"{where}[{k!r}]")
    elif isinstance(target, (list, tuple)):
        for i, (a, b) in enumerate(zip(tree, target)):
            _check_target_in_order(a, b, f"{where}[{i}]")


def restore_gate(path: str, target, sums: dict) -> bool:
    """A PBT restore's gate on one checkpoint: load_pytree(path,
    target=target) holds the checkpoint's parameters (checksums) in the
    target's key order and dtypes."""
    from ray_tpu_torch import train

    try:
        back = train.load_pytree(path, target=target)
    except ValueError as e:
        log(f"  the restore raised: {e}")
        return False
    ok = (list(back["params"]) == list(target["params"])
          and all(a.dtype == b.dtype for a, b in zip(state_tensors(back), state_tensors(target)))
          and leaf_checksums(back["params"]) == sums)
    del back
    return ok


def tune_path(card: str, solo: dict | None = None) -> dict:
    """Phase 4t: tune/ and the shared ingest service at llama-2b, full width
    and depth, through the port's entry points on the card.
    (a) Four tenants (one at weight 3) drain phase 4t's rows from one
        IngestService to the card (tenant_drain): while all four wait, the
        weight-3 tenant gets >= FAIR_SHARE_MIN times a weight-1 tenant's
        dispatches.
    (b) Tuner(trainable, param_space={"lr": grid_search(TUNE_LRS)},
        TuneConfig(max_concurrent_trials=4, resources_per_trial={"GPU":
        0.25}, scheduler=AsyncHyperBandScheduler(max_t=12, grace_period=2,
        reduction_factor=2))): four llama-2b trials under phase 4f's recipe
        share the card, each a tenant of one ingest service. Gates: every
        trial's step 0 bit-equal to the others', to train.lm's on the same
        batch and to phase 4f's; a trial stopped early and the lr-0 trial
        not the best; a trial that ran to max_t within LOSS_GAP_TOL of
        train.lm run directly on the same batches at its lr; each trial's
        thread's launches thread_launches(its steps) and the fit's
        train_launches(every trial's steps); each early stop freed the
        trial's lanes and state within its longest step plus STOP_SLACK_S
        of the decision, with at most one step begun after it; card
        memory after fit() within TUNE_MEMORY_TOL of
        before, no trial or ingest thread left.
    (c) PopulationBasedTraining over two trials (lr 0 and 1e-3), the lr-0
        trial reporting each milestone after the controller has taken the
        other's (pbt_trainable): a restored trial's first loss equals its
        source's loss at that step within LOSS_GAP_TOL, and no earlier copy
        of it is alive when it starts.
    (d) Planted faults: trial_kept_running_after_stop (the runner's stop a
        no-op, as the reference's kill), tenant_weight_ignored (every
        tenant weighs 1) and restore_ignores_target_order (the old target
        check) must each fail their gate.
    `solo`: phase 4f's figures, when it ran. Returns {"launches": (b)'s and
    (c)'s fits}."""
    import tempfile

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train, tune
    from ray_tpu_torch.data import tenant
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.tune import schedulers, tune_controller

    t_phase = time.monotonic()
    cfg = get_config("llama-2b")
    (B, T) = PRETRAIN_BATCH
    rows = tune_rows(cfg)
    rt.shutdown()
    rt.init(system_config=RUNTIME_FLAGS)  # thread mode, this host's CPUs and its card
    storage = tempfile.mkdtemp(prefix="phase4t-")
    try:
        log(f"phase 4t: llama-2b, train2b recipe, trials of up to {TUNE_MAX_T} steps of "
            f"{B} x {T}; rows int32 {list(rows.shape)}, one a block; {card}")

        # (a) the shared ingest service's fair share, and its planted fault
        ratio, window, whole = tenant_drain(rows, "phase 4t (a)")
        if not whole or window < 8 or ratio < FAIR_SHARE_MIN:
            fail(f"phase 4t (a): the weight-3 tenant got {ratio:.2f}x a weight-1 tenant's "
                 f"blocks over {window} contended dispatches (rows whole: {whole})")
        with swapped(tenant.TenantSpec, resolved_weight=lambda spec: 1.0):
            planted_ratio, planted_window, _ = tenant_drain(
                rows, "phase 4t planted tenant_weight_ignored")
        caught_weight = planted_window < 8 or planted_ratio < FAIR_SHARE_MIN

        # step 0 as phase 4f takes it: a fresh state, its synthetic batch
        opt = train.make_optimizer(learning_rate=0.0, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        bf16_params(state)
        f4_loss0 = float(train.make_train_step(cfg, opt)(
            state, train.synthetic_batch(cfg, B, T, seed=0))[1]["loss"])
        del state
        release()

        # (b) ASHA over four trials sharing the card
        marks: dict = {"trials": {}, "held": {}}
        clock = StopTimes(marks["held"])
        svc = data.get_ingest_service(pool_min=1, pool_max=2, autoscale=False,
                                      quantum_bytes=2 * rows[0].nbytes)
        threads0 = tune_threads()
        torch.cuda.synchronize()
        # cuBLAS keeps a workspace per handle, and each trial's thread takes
        # a handle: cleared before both readings, so that they count tensors
        torch._C._cuda_clearCublasWorkspaces()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ingest_log: list = []
        dispatch.reset_launches()
        t0 = time.monotonic()
        with clock.installed(), swapped(tenant.FairShareScheduler,
                                        next=logging_next(ingest_log)):
            grid = tune.Tuner(
                tune_trainable(cfg, rows, marks),
                param_space={"lr": tune.grid_search(list(TUNE_LRS)), "steps": TUNE_MAX_T},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min", max_concurrent_trials=4,
                    resources_per_trial={"CPU": 1.0, "GPU": TUNE_SHARE},
                    scheduler=tune.AsyncHyperBandScheduler(
                        metric="loss", mode="min", max_t=TUNE_MAX_T, grace_period=2,
                        reduction_factor=2))).fit()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches_b = dispatch.launch_counts()
        clock.join()
        peak = torch.cuda.max_memory_allocated()
        shares = svc.shares()
        stall = {}
        for _, tags, v in data.executor._m_stall.samples():
            tags = dict(tags)
            if tags.get("stage") == "ingest":
                stall[tags.get("tenant")] = v
        from ray_tpu_torch.core.metrics import registry

        hits = registry.get("ingest_cache_hits_total")
        data.shutdown_ingest_service()
        release()
        torch._C._cuda_clearCublasWorkspaces()
        mem1 = torch.cuda.memory_allocated()
        deadline = time.monotonic() + 5
        while (tune_threads() - threads0) and time.monotonic() < deadline:
            time.sleep(0.05)
        left = sorted(t.name for t in tune_threads() - threads0)
        trials = {t.trial_id: t for t in grid.trials}
        recs = marks["trials"]
        for tid, t in sorted(trials.items(), key=lambda kv: kv[1].config["lr"]):
            r = recs.get(tid, {})
            log(f"phase 4t (b) trial lr {t.config['lr']:g}: {t.status.value}"
                f"{' (stopped early)' if t.stopped_early else ''}, steps {len(r.get('losses', []))}"
                f" (reported {len(t.results)}), losses "
                f"{[round(x, 5) for x in r.get('losses', [])]}, step time while sharing the card "
                f"p50 {statistics.median(r.get('step_s') or [math.nan]):.4f}s max "
                f"{max(r.get('step_s') or [math.nan]):.4f}s; launches {r.get('launches')}; "
                f"ingest share {shares.get(tid, {}).get('share', math.nan):.3f}, blocks "
                f"{int(shares.get(tid, {}).get('served_blocks', 0))}, stall "
                f"{stall.get(tid, 0.0):.4f}s, cache hits "
                f"{hits.get({'tenant': tid}) if hits is not None else 0:.0f}")
            for s in clock.stops.get(tid, []):
                log(f"  stop (early {s['early']}): returned {s['returned']:.3f}s, lanes ended "
                    f"and state freed {s['freed']:.3f}s after the decision (lanes alive "
                    f"{s['lanes_alive']}, state alive {s['state_alive']}); steps begun after "
                    f"it {sum(t0 > s['decided'] for t0 in r.get('starts', []))}")
        errors = [t.error for t in grid.trials if t.error]
        if errors:
            fail(f"phase 4t (b): trials failed: {errors}")
        losses0 = [r["losses"][0] for r in recs.values() if r["losses"]]
        best = grid.get_best_result()
        stopped = [t for t in grid.trials if t.stopped_early]
        full = [t for t in grid.trials if len(recs[t.trial_id]["losses"]) == TUNE_MAX_T]
        ends = [e for r in recs.values() for e in r["ends"]]
        steps_all = sum(len(r["losses"]) for r in recs.values())
        span = max(ends) - min(e - s for r in recs.values() for e, s in zip(r["ends"], r["step_s"]))

        # the yardstick: train.lm directly on the same batches at a full trial's lr
        lr_full = max(t.config["lr"] for t in full) if full else TUNE_LRS[-1]
        opt = train.make_optimizer(learning_rate=lr_full, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        bf16_params(state)
        step = train.make_train_step(cfg, opt)
        direct, direct_s = [], []
        for i in range(TUNE_MAX_T):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                     for k, v in split_tokens({"tokens": rows[B * i:B * (i + 1)]}).items()}
            t1 = time.perf_counter()
            state, m = step(state, batch)
            direct.append(float(m["loss"]))
            direct_s.append(time.perf_counter() - t1)
        del state, step, m, batch
        release()
        solo_s = statistics.median(direct_s[1:])
        f4_s = f" and phase 4f alone {solo['step_s']:.4f}s" if solo else ""
        shared_s = [statistics.median(r["step_s"][1:] or r["step_s"]) for r in recs.values()]
        log(f"phase 4t (b) ({card}): fit() {wall:.2f}s, {len(trials)} trials, {steps_all} "
            f"steps; step time while sharing the card p50 by trial "
            f"{[round(x, 4) for x in shared_s]}s against train.lm alone {solo_s:.4f}s{f4_s}; "
            f"the card's summed {steps_all * B * T / span:.1f} tokens/s over the "
            f"{span:.2f}s its trials stepped (alone {B * T / solo_s:.1f}); peak memory "
            f"{peak / 2**30:.2f} GiB; card memory {mem0 / 2**30:.3f} GiB before fit(), "
            f"{mem1 / 2**30:.3f} after; threads left {left or 'none'}; step 0 "
            f"{sorted(set(losses0))} against train.lm's {direct[0]!r} and phase 4f's "
            f"{f4_loss0!r}; the trial of lr {lr_full:g} against train.lm directly "
            f"{[round(x, 5) for x in direct]}; launches of the fit {launches_b}")
        if len(set(losses0)) != 1 or losses0[0] != direct[0] or losses0[0] != f4_loss0:
            fail(f"phase 4t (b): step 0's losses {losses0} are not all train.lm's "
                 f"{direct[0]!r} and phase 4f's {f4_loss0!r}")
        if not stopped:
            fail("phase 4t (b): ASHA stopped no trial")
        if best.config["lr"] == 0.0:
            fail("phase 4t (b): the lr-0 trial is the best result")
        if not full:
            fail("phase 4t (b): no trial ran to max_t")
        (full_id,) = [t.trial_id for t in full if t.config["lr"] == lr_full]
        gap = max(abs(a - b) for a, b in zip(recs[full_id]["losses"], direct))
        if gap > LOSS_GAP_TOL:
            fail(f"phase 4t (b): the full trial's losses differ from train.lm's by {gap:.3e}")
        for tid, r in recs.items():
            want = thread_launches(cfg, len(r["losses"]))
            got = {name: r["launches"].get(name, 0) for name in want}
            if got != want:
                fail(f"phase 4t (b): trial {tid}'s thread launched {got}, expected {want}")
        want = train_launches(cfg, steps_all)
        if {name: launches_b[name] for name in want} != want:
            fail(f"phase 4t (b): the fit launched {launches_b}, expected {want} "
                 f"({steps_all} steps)")
        for name in ("rms_norm", "rms_norm_bwd", "flash_attention", "flash_attention_lse",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if launches_b[name] <= 0:
                fail(f"phase 4t (b) never launched kernel {name}")
        for t in stopped:
            s = clock.stops[t.trial_id][0]
            limit = max(recs[t.trial_id]["step_s"]) + STOP_SLACK_S
            later = sum(t0 > s["decided"] for t0 in recs[t.trial_id]["starts"])
            if s["lanes_alive"] or s["state_alive"] or s["freed"] > limit or later > 1:
                fail(f"phase 4t (b): trial {t.trial_id} began {later} steps after the stop "
                     f"decision and was freed {s['freed']:.3f}s after it (limit "
                     f"{limit:.3f}s; lanes alive {s['lanes_alive']}, state alive "
                     f"{s['state_alive']})")
        if abs(mem1 - mem0) > TUNE_MEMORY_TOL:
            fail(f"phase 4t (b): card memory {mem0 / 2**30:.3f} GiB before fit(), "
                 f"{mem1 / 2**30:.3f} after")
        if left:
            fail(f"phase 4t (b): threads outlived fit(): {left}")
        asha_ratio, asha_window = fair_share(ingest_log, {
            tid: (3.0 if t.config["lr"] == TUNE_HEAVY_LR else 1.0) for tid, t in trials.items()})
        log(f"phase 4t (b): the trials' ingest dispatches while all four waited {asha_window}, "
            f"the weight-3 tenant's over a weight-1 tenant's {asha_ratio:.2f}")

        # (c) PBT over two trials, restores through load_pytree(target=)
        marks = {"pbt": {}, "held": {}, "handled": {}, "turn": threading.Condition()}
        clock = StopTimes(marks["held"])
        data.get_ingest_service(pool_min=1, pool_max=2, autoscale=False)
        dispatch.reset_launches()
        t0 = time.monotonic()
        with clock.installed(), swapped(tune_controller.TuneController,
                                        _handle_reports=handled_reports(marks)):
            pbt = tune.Tuner(
                pbt_trainable(cfg, rows, storage, marks),
                param_space={"lr": tune.grid_search(list(PBT_LRS)), "steps": PBT_STEPS},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min", max_concurrent_trials=2,
                    resources_per_trial={"CPU": 1.0, "GPU": TUNE_SHARE},
                    scheduler=tune.PopulationBasedTraining(
                        metric="loss", mode="min", perturbation_interval=PBT_INTERVAL,
                        hyperparam_mutations={"lr": PBT_MUTATIONS}, seed=0))).fit()
        torch.cuda.synchronize()
        launches_c = dispatch.launch_counts()
        clock.join()
        data.shutdown_ingest_service()
        release()
        wall_c = time.monotonic() - t0
        restores = []
        for tid, lives in marks["pbt"].items():
            for n, life in enumerate(lives):
                log(f"phase 4t (c) trial {tid} life {n}: lr {life['lr']:g}, steps "
                    f"{sorted(life['losses'])}, losses "
                    f"{[round(life['losses'][i], 5) for i in sorted(life['losses'])]}; copies "
                    f"alive at its start {life['copies_alive']}; saves "
                    f"{[round(x, 3) for x in life.get('save_s', [])]}s"
                    + (f"; restored {life['restored']} in {life['restore_s']:.3f}s"
                       if "restored" in life else ""))
                if "restored" in life:
                    # the source's loss at that step: the life that wrote the
                    # checkpoint, if it took the step before it was stopped
                    i, src = life["restored"]["iteration"], life["restored"]
                    want = marks["pbt"][src["trial"]][src["life"]]["losses"].get(i)
                    restores.append((tid, i, life["losses"].get(i, math.nan), want,
                                     life["copies_alive"]))
        for tid, stops in clock.stops.items():
            for s in stops:
                log(f"  stop of {tid} (early {s['early']}): freed {s['freed']:.3f}s after the "
                    f"decision")
        log(f"phase 4t (c) ({card}): fit() {wall_c:.2f}s; restores (trial, step, its first "
            f"loss, the source's loss at that step, copies alive) {restores}")
        if pbt.errors or not [r for r in restores if r[3] is not None]:
            fail(f"phase 4t (c): no restore whose source took the step after it "
                 f"({[t.error for t in pbt.errors]})")
        for tid, i, got, want, alive in restores:
            if (want is not None and not abs(got - want) <= LOSS_GAP_TOL) or alive:
                fail(f"phase 4t (c): trial {tid}'s first loss after restoring step {i} is "
                     f"{got!r}, its source's {want!r}; earlier copies alive {alive}")

        # (d) the planted faults
        ckpt = sorted(p for p in os.listdir(storage) if "-it" in p)[0]
        path = os.path.join(storage, ckpt, "state")
        sums = leaf_checksums(train.load_pytree(path)["params"])
        opt = train.make_optimizer(learning_rate=0.0, warmup_steps=2, total_steps=100,
                                   factored=True)
        target = train.init_train_state(cfg, opt, seed=0)
        bf16_params(target)
        sound_restore = restore_gate(path, target, sums)
        from ray_tpu_torch.train import checkpoint

        with swapped(checkpoint, _check_target=_check_target_in_order):
            caught_order = not restore_gate(path, target, sums)
        del target
        release()
        if not sound_restore:
            fail(f"phase 4t (d): load_pytree of {ckpt} with its init target fails the restore gate")
        held: dict = {"trials": {}, "held": {}}

        def one_trial(label):
            clk = StopTimes(held["held"])

            class StopAt(schedulers.FIFOScheduler):
                def on_result(self, trial, result, all_trials):
                    return schedulers.STOP if result["training_iteration"] == 2 else \
                        schedulers.CONTINUE

            data.get_ingest_service(pool_min=1, pool_max=1, autoscale=False)
            with clk.installed():
                g = tune.Tuner(tune_trainable(cfg, rows, held),
                               param_space={"lr": 0.0, "steps": 8},
                               tune_config=tune.TuneConfig(
                                   resources_per_trial={"CPU": 1.0, "GPU": TUNE_SHARE},
                                   scheduler=StopAt())).fit()
            data.shutdown_ingest_service()
            clk.join()
            ((tid, (s, *_)),) = clk.stops.items()
            r = held["trials"][tid]
            limit = max(r["step_s"][:3]) + STOP_SLACK_S
            log(f"{label}: stopped at iteration 2, ran {len(r['losses'])} steps, "
                f"{sum(t0 > s['decided'] for t0 in r['starts'])} begun after the decision, "
                f"freed {s['freed']:.3f}s after it (limit {limit:.3f}s)")
            held["trials"].clear()
            release()
            later = sum(t0 > s["decided"] for t0 in r["starts"])
            return s["freed"] > limit or later > 1 or s["lanes_alive"] or s["state_alive"] \
                or bool(g.errors)

        if one_trial("phase 4t (d) one trial stopped by a scheduler"):
            fail("phase 4t (d): a trial stopped at iteration 2 was not freed within its step")
        with swapped(tune_controller.TrialRunner._cls, stop=lambda runner: True):
            caught_running = one_trial("phase 4t planted trial_kept_running_after_stop")
        for name, hit in (("trial_kept_running_after_stop", caught_running),
                          ("tenant_weight_ignored", caught_weight),
                          ("restore_ignores_target_order", caught_order)):
            log(f"phase 4t planted fault {name}: its gate fails {bool(hit)}")
            if not hit:
                fail(f"phase 4t: its gates pass planted fault {name}")
    finally:
        data.shutdown_ingest_service()
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        release()
    log(f"phase 4t: the phase took {time.monotonic() - t_phase:.1f}s ({card})")
    return {"launches": {name: launches_b[name] + launches_c[name] for name in launches_b}}


# ------------------------------------------------------------- phase 4r

RL_DEVICE = "cuda"  # where phase 4r's learners and engines run
RL_MODEL = "llama-600m"
RL_STEPS = 3  # GRPO steps at RL_LR after the lr-0 step, and online-RL iterations
RL_LR = 1e-5
RL_GROUP = 8
RL_NEW_TOKENS = 16
RL_PROMPT_LEN = 32
RL_STREAM_TOKENS = 600  # the greedy stream held across a sync in 4r (b)
RL_STREAM_PROMPT = 300  # its prompt: past ENGINE's 256-token prefill chunk
RL_GATE_TOKENS = 1024  # a row of 4r (a)'s gradient gate: 8 rows, phase 4's 8192 targets
RL_MEMORY_TOL = SERVE_RETIRED_MEMORY_TOL
PPO_UPDATE_TOL = 1e-4
# the faults 4r's gates must catch: the frozen reference policy bound to the
# trained one, EngineWorker.update_weights reporting the version without the
# swap, and the rollouts' logprobs dropped (logp_old backfilled with the
# current policy's)
RL_FAULTS = ("ref_policy_aliased", "sync_reported_without_swap", "rollout_logprobs_discarded")


def unique_reward(prompt_ids, completion_ids) -> float:
    """bench_grpo's reward: the unique-token ratio of the completion."""
    return len(set(completion_ids)) / max(len(completion_ids), 1)


def grpo_launches(cfg, steps: int) -> dict:
    """The exact launches of `steps` GRPO train_steps (RL_NEW_TOKENS new
    tokens, remat): generate's prefill (K2 without lse once a layer, K1's
    forward 2L + 1) and its RL_NEW_TOKENS decode steps (K1 2L + 1 each;
    the contiguous-cache decode attends in plain PyTorch), two no-grad
    _seq_logp forwards (K2 L, K1 2L + 1 each), and the update's forward and
    backward as phase 4's step (K2 with lse twice a layer, K1 4L + 1 and
    its backward 2L + 1, K3 and K4 once a layer)."""
    L, N = cfg.n_layers, RL_NEW_TOKENS
    fwd = 2 * L + 1
    return {"rms_norm": (fwd * (1 + N) + 2 * fwd + 4 * L + 1) * steps,
            "rms_norm_bwd": fwd * steps,
            "flash_attention": 5 * L * steps, "flash_attention_lse": 2 * L * steps,
            "flash_attention_bwd_dq": L * steps, "flash_attention_bwd_dkv": L * steps,
            "paged_attention_decode": 0, "paged_attention_chunk": 0,
            "paged_attention_verify": 0}


def tree_snapshot(tree) -> list:
    from ray_tpu_torch.rl.module import tree_leaves

    return [t.detach().clone() for t in tree_leaves(tree)]


def same_as(tree, snapshot) -> bool:
    from ray_tpu_torch.rl.module import tree_leaves

    return all(torch.equal(t.detach(), s) for t, s in zip(tree_leaves(tree), snapshot))


def new_grpo(cfg, config):
    """A GRPO learner over f32 parameters from seed 0."""
    from ray_tpu_torch import rl
    from ray_tpu_torch.models import init_params

    params = init_params(cfg, seed=0, device=RL_DEVICE, dtype=torch.float32)
    return rl.GRPO(params, cfg, unique_reward, config, device=RL_DEVICE)


def grpo_steps(label: str, grpo, prompt, snapshot, steps: int) -> dict:
    """One train_step at learning rate 0, then `steps` at RL_LR. Gates: the
    lr-0 step leaves the parameters bit-identical, every loss is finite,
    ref_params stays bit-identical to `snapshot` (the init) and the KL is
    > 0 from the second RL_LR step on (the first starts from the init).
    Returns {"problems" (empty when every gate held), "outs", "times",
    "launches" (of the RL_LR steps)}."""
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.train.lm import Adafactor

    problems = []
    out0 = grpo.train_step(prompt)
    if not same_as(grpo.params, snapshot):
        problems.append("the lr-0 step changed the parameters")
    grpo.optimizer = Adafactor(lambda count: RL_LR, grad_clip=None)
    outs, times = [out0], []
    dispatch.reset_launches()
    for _ in range(steps):
        t1 = time.perf_counter()
        outs.append(grpo.train_step(prompt))  # its floats wait for the step
        times.append(time.perf_counter() - t1)
    launches = dispatch.launch_counts()
    for i, o in enumerate(outs):
        log(f"{label} step {i} (lr {0.0 if i == 0 else RL_LR}): loss {o['loss']:.6f} pg "
            f"{o['pg_loss']:.6f} kl {o['kl']:.4e} reward {o['reward_mean']:.4f}"
            + ("" if i == 0 else f" {times[i - 1]:.3f}s"))
    if not all(math.isfinite(o["loss"]) for o in outs):
        problems.append(f"non-finite losses {[o['loss'] for o in outs]}")
    if not same_as(grpo.ref_params, snapshot):
        problems.append("ref_params moved")
    if not all(o["kl"] > 0 for o in outs[2:]):
        problems.append(f"KL {[o['kl'] for o in outs]} not > 0 after the first nonzero step")
    log(f"{label}: problems {problems or 'none'}")
    return {"problems": problems, "outs": outs, "times": times, "launches": launches}


def grpo_loss_grads(grpo):
    """gradient_gate's grads_fn: GRPO's loss on a batch's tokens and
    advantages, on-policy on the path it runs on: logp_old and logp_ref are
    that path's own no-grad _seq_logp (ratio 1, r 1, so the KL term adds
    no gradient), as at the first update of a GRPO iteration."""
    from ray_tpu_torch.rl.module import tree_leaves

    def fn(params, batch, cfg):
        own, _ = grpo._seq_logp(params, batch["tokens"], batch["prompt_len"])
        loss, _ = grpo._loss(params, dict(batch, logp_old=own, logp_ref=own))
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(params))
    return fn


# The bf16 gradient gate of 4r (a), against a witness. At this untrained
# init the two bf16 paths part by 0.029-0.051 per leaf (GRAD_TOL is for
# phase 4's trained weights, where they part by 0.0038), so neither is
# held against the other: both are held against the f32 plain path's
# gradients, and per leaf the kernel path's gap to that witness must stay
# within WITNESS_RATIO times the plain path's, plus WITNESS_FLOOR (where
# the plain path's gap is near 0; the f32 paths agree to 1e-5); each
# planted backward fault (BWD_FAULTS, on the bf16 kernel path) must exceed
# that somewhere.
WITNESS_RATIO = 2.0
WITNESS_FLOOR = 1e-3


def witness_gate(label: str, grpo, batch, faults) -> None:
    """GRPO's loss and gradients (grpo_loss_grads) on the bf16 kernel path
    and the bf16 plain path, each against the f32 plain path's (the
    witness): the bf16 losses within LOSS_GAP_TOL of each other, and per
    leaf the kernel path's relative L2 gap to the witness within
    WITNESS_RATIO times the plain path's plus WITNESS_FLOOR; each planted
    fault (name -> (module, attribute, wrapper maker)) must exceed that on
    some leaf."""
    fn = grpo_loss_grads(grpo)
    names = [n for n, _ in named_leaves(grpo.params)]
    with swapped(grpo, cfg=dataclasses.replace(grpo.cfg, dtype="float32")), plain_path():
        loss_w, witness = fn(grpo.params, batch, None)
    with plain_path():
        loss_p, g = fn(grpo.params, batch, None)
    plain = grad_gaps(names, g, witness)
    loss_k, g = fn(grpo.params, batch, None)
    kernel = grad_gaps(names, g, witness)
    del g
    faulted = {}
    for name, (module, attr, make) in faults.items():
        with planted(module, (attr, make)):
            _loss, g = fn(grpo.params, batch, None)
        faulted[name] = grad_gaps(names, g, witness)
        del g
    del witness
    release()

    def ratios(gaps):  # <= 1 within the limit
        return {n: gaps[n] / (WITNESS_RATIO * plain[n] + WITNESS_FLOOR) for n in names}

    def fmt(gaps):
        return " ".join(f"{n} {x:.5f}" for n, x in gaps.items())

    log(f"{label} (relative L2 per leaf to the f32 plain path, the kernel path's within "
        f"{WITNESS_RATIO}x the plain path's + {WITNESS_FLOOR}; 'of limit' is the largest "
        f"share of that limit): loss f32 plain {loss_w:.6f}, bf16 kernel "
        f"{loss_k:.6f}, bf16 plain {loss_p:.6f} (|gap| {abs(loss_k - loss_p):.3e}, limit "
        f"{LOSS_GAP_TOL})")
    log(f"  bf16 plain: max {max(plain.values()):.5f}: {fmt(plain)}")
    sound = ratios(kernel)
    log(f"  bf16 kernel: max {max(kernel.values()):.5f}, of limit {max(sound.values()):.3f}: "
        f"{fmt(kernel)}")
    for name, gaps in faulted.items():
        log(f"  planted {name}: max {max(gaps.values()):.5f}, of limit "
            f"{max(ratios(gaps).values()):.3f}: {fmt(gaps)}")
    if not abs(loss_k - loss_p) <= LOSS_GAP_TOL:
        fail(f"{label}: kernel and plain losses differ by {abs(loss_k - loss_p):.3e}")
    worst = max(sound, key=sound.get)
    if not sound[worst] <= 1.0:
        fail(f"{label}: the kernel path's gradients leave the witness by {kernel[worst]:.5f} "
             f"on {worst}, the plain path's by {plain[worst]:.5f}")
    for name, gaps in faulted.items():
        if not max(ratios(gaps).values()) > 1.0:
            fail(f"{label} ({WITNESS_RATIO}x + {WITNESS_FLOOR}) passes planted fault {name}")


def grpo_part(card: str, cfg, prompt) -> tuple:
    """4r (a), and (c)'s first fault. Returns ((a)'s launches, whether
    the planted ref_policy_aliased failed its gate)."""
    from ray_tpu_torch import ops, rl

    gcfg = rl.GRPOConfig(group_size=RL_GROUP, max_new_tokens=RL_NEW_TOKENS, temperature=1.0,
                         factored=True, lr=0.0)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    grpo = new_grpo(cfg, gcfg)
    snapshot = tree_snapshot(grpo.ref_params)
    torch.cuda.synchronize()
    log(f"phase 4r (a): GRPO {cfg.name} ({sum(s.numel() for s in snapshot) / 1e9:.4f} B "
        f"params, f32 masters, {cfg.dtype} compute, remat {cfg.remat}), group {RL_GROUP}, "
        f"{RL_NEW_TOKENS} new tokens, factored, prompt 1..{len(prompt)}; built in "
        f"{time.monotonic() - t0:.1f}s, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # phase 4's gradient gate on the GRPO loss at the init, each path
    # on-policy (grpo_loss_grads), with seeded positive advantages, over
    # RL_GROUP rows of the prompt and RL_GATE_TOKENS - RL_PROMPT_LEN seeded
    # completion tokens (phase 4's 8192 targets): in bf16, the compute this
    # path runs (the wgmma kernels), against the f32 witness (witness_gate),
    # and in f32 (the FMA kernels), kernel path against plain path
    gen = torch.Generator().manual_seed(3)
    completions = torch.randint(0, cfg.vocab_size, (RL_GROUP, RL_GATE_TOKENS - len(prompt)),
                                generator=gen)
    tokens = torch.cat([torch.tensor([prompt] * RL_GROUP), completions], dim=1).to(RL_DEVICE)
    adv = 0.5 + torch.rand(RL_GROUP, generator=gen)
    gate_batch = {"tokens": tokens, "prompt_len": len(prompt), "advantages": adv.to(RL_DEVICE)}
    faults = {name: (getattr(ops, module), attr, make)
              for name, (module, attr, make) in BWD_FAULTS.items()}
    witness_gate("phase 4r (a) gradient gate (the GRPO loss, bf16, at the init)", grpo,
                 gate_batch, faults)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with swapped(grpo, cfg=cfg32):
        gradient_gate("phase 4r (a) gradient gate (the GRPO loss, f32, at the init)",
                      grpo.params, gate_batch, cfg32, plain_path, faults,
                      grads_fn=grpo_loss_grads(grpo))
    ran = grpo_steps("phase 4r (a)", grpo, prompt, snapshot, RL_STEPS)
    if ran["problems"]:
        fail(f"phase 4r (a): {ran['problems']}")
    want = grpo_launches(cfg, RL_STEPS)
    log(f"phase 4r (a): launches over {RL_STEPS} steps {ran['launches']} (reckoned {want})")
    for name, n in want.items():
        if ran["launches"][name] != n:
            fail(f"phase 4r (a): {name} launched {ran['launches'][name]} times, expected {n}")
    dt = sum(ran["times"])
    log(f"phase 4r (a): GRPO {RL_GROUP * RL_STEPS / dt:.3f} samples/s ({RL_STEPS} steps of "
        f"{RL_GROUP} in {dt:.3f}s: {[round(t, 3) for t in ran['times']]}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    launches = ran["launches"]
    del grpo, gate_batch, tokens, ran
    release()
    # (c) RL_FAULTS ref_policy_aliased: the frozen policy bound to the trained one
    aliased = new_grpo(cfg, gcfg)
    aliased.ref_params = aliased.params
    caught = bool(grpo_steps("phase 4r planted ref_policy_aliased", aliased, prompt, snapshot,
                             2)["problems"])
    del aliased, snapshot
    release()
    return launches, caught


class LogprobFreeStream:
    """A DisaggStream whose logprobs read None: planted fault
    rollout_logprobs_discarded (the loop backfills logp_old with the
    current policy's)."""

    def __init__(self, ds):
        self._ds = ds

    def __getattr__(self, name):
        return getattr(self._ds, name)

    @property
    def logprobs(self):
        return None


def _sync_without_swap(self, request):
    """Planted fault sync_reported_without_swap: EngineWorker.update_weights
    reports the version without swapping anything in."""
    return {"weights_version": request.get("version")}


def backlog_measure(co) -> str:
    """What the fleet's prefill backlog (DisaggCoordinator.backlog) rests
    on: the legs' service time the coordinator measured, and what each
    prefill replica runs at once and took to build."""
    workers = co.workers("prefill")
    return (f"prefill leg service time {co._leg_s['prefill'] * 1e3:.2f} ms (moving average "
            f"of the returned), replicas run {[w.admits('prefill') for w in workers]} legs at once and "
            f"built in {[round(w.build_s(), 2) for w in workers]} s")


def rl_iteration_gates(loop, history, seen, workers) -> list:
    """The online loop's gates after a run of iterations: every rollout
    carries a logprob per token and the loop's weights_version at
    submission (seen["versions"], one per iteration), every replica,
    asked itself, reports loop.version, and each iteration's ledger is a
    partition of its wall. Returns the problems. The rl_weights_version_skew
    gauge is printed, not gated: the loop sets it from the coordinator's
    gossip, which may lag a sync by adapter_gossip_s, so uniformly stale
    versions read 0 as well."""
    from ray_tpu_torch.core.metrics import registry

    problems = []
    for i, (m, trajs, v0) in enumerate(zip(history, seen["trajs"], seen["versions"])):
        bad = [t for t in trajs if t.weights_version != v0 or len(t.logprobs) != len(
            t.completion) or any(lp is None for lp in t.logprobs)]
        if len(trajs) != int(m["submitted"]) or bad:
            problems.append(f"iteration {i}: {len(bad)} of {len(trajs)} rollouts lack logprobs "
                            f"or version {v0} ({int(m['submitted'])} submitted)")
        parts = sum(m[f"ledger_{k}"] for k in ("rollout", "reward", "train", "weight_sync",
                                               "other"))
        if not abs(parts - m["ledger_wall_seconds"]) <= 1e-9 * max(1.0, parts):
            problems.append(f"iteration {i}: the ledger's parts {parts} are not its wall "
                            f"{m['ledger_wall_seconds']}")
    if len(seen["trajs"]) != len(history):
        problems.append(f"{len(seen['trajs'])} trained groups recorded for {len(history)} "
                        f"iterations")
    versions = {str(w.key): int(w.weights_version()) for w in workers}
    skew = registry.get("rl_weights_version_skew").get()
    log(f"phase 4r (b): replica versions {versions}, loop {loop.version}, "
        f"rl_weights_version_skew (gossip, advisory) {skew}")
    if set(versions.values()) != {loop.version}:
        problems.append(f"replica versions {versions}, loop {loop.version}")
    return problems


def online_part(card: str, cfg) -> tuple:
    """4r (b), and (c)'s other two faults, on a runtime the caller
    started. Returns ((b)'s launches, {fault: whether its gate failed})."""
    import numpy as np

    from ray_tpu_torch import rl
    from ray_tpu_torch.core.metrics import registry
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.rl.module import tree_map
    from ray_tpu_torch.serve.disagg import DisaggCoordinator, EngineWorker
    from ray_tpu_torch.serve.fleet import FleetController

    L = cfg.n_layers
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (RL_PROMPT_LEN,), generator=gen).tolist()
               for _ in range(2)]
    half = cfg.vocab_size // 2

    def half_vocab(prompt_ids, completion_ids):
        return float(np.mean([t < half for t in completion_ids])) if completion_ids else 0.0

    loop = fleet = None
    servers = []
    try:
        params = init_params(cfg, seed=0, device=RL_DEVICE, dtype=torch.float32)
        for role in ("prefill", "decode"):
            servers.append(new_server(
                f"phase 4r (b): {role}-role LLMServer {cfg.name} (bf16 copies of the trainer's "
                f"weights)", params_fn=lambda: (tree_map(
                    lambda t: t.detach().to(torch.bfloat16).clone(), params), cfg),
                engine_config=ENGINE, role=role, device=RL_DEVICE))
        workers = [EngineWorker(servers[0].engine, "prefill"),
                   EngineWorker(servers[1].engine, "decode")]
        co = DisaggCoordinator(workers[:1], workers[1:], {"small_blob_bytes": 0})
        fleet = FleetController(co)  # the fleet's defaults
        loop = rl.OnlineRLLoop(params, cfg, half_vocab, fleet, prompts, rl.OnlineRLConfig(
            grpo=rl.GRPOConfig(group_size=RL_GROUP, max_new_tokens=RL_NEW_TOKENS,
                               temperature=1.0, lr=RL_LR, factored=True)), device=RL_DEVICE)
        del params
        fleet.start()
        real_train = loop._train_groups

        def recording(seen, gaps=None):
            """_train_groups that keeps each iteration's trajectories and,
            with `gaps`, holds the first iteration's rollout logprobs
            against the trainer's _seq_logp of the same tokens first."""
            def train(groups):
                trajs = [t for g in groups.values() for t in g]
                seen["trajs"].append(trajs)
                if gaps is not None and len(seen["trajs"]) == 1:
                    for t in trajs:
                        lp, _ = loop.grpo._seq_logp(loop.grpo.params,
                                                    [t.prompt + t.completion], len(t.prompt))
                        want = lp[0, len(t.prompt) - 1:].float()
                        got = torch.tensor([x if x is not None else float("nan")
                                            for x in t.logprobs], device=want.device)
                        d = (got - want).abs()
                        gaps.append((d.max().item(), d.mean().item()))
                return real_train(groups)
            return train

        seen, gaps = {"trajs": [], "versions": []}, []
        loop._train_groups = recording(seen, gaps)
        ups0 = len(fleet.actions)
        dispatch.reset_launches()
        history = []
        for _ in range(RL_STEPS):
            seen["versions"].append(loop.version)
            history.append(loop.run_iteration())
        launches_it, eager_it = dispatch.launch_counts(), dispatch.eager_launch_counts()
        for m in history:
            log(f"phase 4r (b) iteration {int(m['training_iteration'])}: reward "
                f"{m['reward_mean']:.4f} loss {m['loss']:.6f} kl {m['kl']:.4e}, "
                f"{int(m['trajectories'])} trajectories; wall {m['ledger_wall_seconds']:.3f}s: "
                f"rollout {m['ledger_rollout']:.3f}s reward {m['ledger_reward']:.4f}s train "
                f"{m['ledger_train']:.3f}s weight_sync {m['ledger_weight_sync']:.4f}s other "
                f"{m['ledger_other']:.4f}s, sync stall fraction "
                f"{m['ledger_sync_stall_fraction']:.4f}; {card}")
        tokens = sum(len(t.completion) for trajs in seen["trajs"] for t in trajs)
        rollout_s = sum(m["ledger_rollout"] for m in history)
        log(f"phase 4r (b): rollouts {tokens / rollout_s:.1f} tok/s ({tokens} completion tokens "
            f"in {rollout_s:.3f}s of rollout), rl_sync_stall_fraction gauge "
            f"{registry.get('rl_sync_stall_fraction').get():.4f}, rewards by iteration "
            f"{[round(m['reward_mean'], 4) for m in history]}; launches {launches_it}, of which "
            f"outside graph replays (the updates and the trainer's forwards) {eager_it}; {card}")
        log(f"phase 4r (b): iteration 1's rollout logprobs against the trainer's _seq_logp, "
            f"(max, mean) per rollout {[tuple(round(x, 4) for x in g) for g in gaps]} "
            f"(tol {LOGPROB_TOL})")
        problems = rl_iteration_gates(loop, history, seen, workers)
        if not gaps or not all(within_logprob_tol(g) for g in gaps):
            problems.append("iteration 1's rollout logprobs leave LOGPROB_TOL")
        ups = [a for a in fleet.actions[ups0:] if a["kind"] == "scale-up"]
        log(f"phase 4r (b): fleet actions under the rollouts {fleet.actions[ups0:]} "
            f"(target_queue_depth {fleet.cfg.target_queue_depth}); {backlog_measure(co)}")
        if ups:
            problems.append(f"the fleet scaled up under the rollouts (C15): {ups}")
        trained = int(sum(m["groups_trained"] for m in history))
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if eager_it[name] != L * trained:
                problems.append(f"{name} ran {eager_it[name]} times in {trained} updates, "
                                f"expected {L * trained}")
        if problems:
            fail(f"phase 4r (b): {problems}")

        # a greedy stream of a RL_STREAM_PROMPT-token prompt (past the prefill
        # chunk: K6 on the prefill replica, where the 32-token rollouts take a
        # bucket) in flight across a fourth sync, still in (b)'s count
        box = {"tokens": []}
        stream_prompt = torch.randint(1, cfg.vocab_size, (RL_STREAM_PROMPT,),
                                      generator=gen).tolist()
        ds = co.open_stream(stream_prompt, max_tokens=RL_STREAM_TOKENS)

        def consume():
            try:
                for tok in ds.tokens():
                    box["tokens"].append(tok)
            except Exception as e:  # noqa: BLE001 — the gate reports it
                box["error"] = repr(e)

        reader = threading.Thread(target=consume, name="rl-stream-reader")
        reader.start()
        while len(box["tokens"]) < 8 and reader.is_alive():
            time.sleep(0.005)
        at_sync = len(box["tokens"])
        t1 = time.monotonic()
        loop._sync_weights()
        sync_s = time.monotonic() - t1
        after_sync = len(box["tokens"])
        reader.join(FLEET_WAIT_S)
        toks = box["tokens"]
        launches, eager = dispatch.launch_counts(), dispatch.eager_launch_counts()
        log(f"phase 4r (b): a greedy stream of {RL_STREAM_TOKENS} tokens after a "
            f"{RL_STREAM_PROMPT}-token prompt had {at_sync} tokens when a sync to version "
            f"{loop.version} began and {after_sync} when it returned ({sync_s * 1e3:.1f} ms; the "
            f"decode engine's update_stats {servers[1].engine.update_stats}), {len(toks)} at its "
            f"end, error {box.get('error')}; replica versions {co.weights_versions()}; "
            f"launches over (b) {launches}, outside graph replays {eager}; {card}")
        if not (at_sync < RL_STREAM_TOKENS and len(toks) == RL_STREAM_TOKENS
                and all(0 <= t < cfg.vocab_size for t in toks) and "error" not in box):
            fail("phase 4r (b): the stream across the sync did not end whole and in vocab")
        problems = [f"{name} ran in no graph replay" for name in (
            "rms_norm", "flash_attention", "paged_attention_decode", "paged_attention_chunk")
            if launches[name] - eager[name] <= 0]
        if any(eager[n] for n in ("paged_attention_decode", "paged_attention_chunk",
                                  "paged_attention_verify")):
            problems.append(f"paged kernels outside graph replays: {eager}")
        if problems:
            fail(f"phase 4r (b): {problems}")

        # (c) the other two faults, one iteration each on this loop
        caught = {}
        seen_c = {"trajs": [], "versions": [loop.version]}
        loop._train_groups = recording(seen_c)
        with swapped(EngineWorker, update_weights=_sync_without_swap):
            hist_c = [loop.run_iteration()]
        caught["sync_reported_without_swap"] = rl_iteration_gates(loop, hist_c, seen_c, workers)
        loop._sync_weights()  # swap for real: every replica at loop.version again
        real_open = co.open_stream
        seen_c = {"trajs": [], "versions": [loop.version]}
        loop._train_groups = recording(seen_c)
        with swapped(co, open_stream=lambda *a, **k: LogprobFreeStream(real_open(*a, **k))):
            hist_c = [loop.run_iteration()]
        caught["rollout_logprobs_discarded"] = rl_iteration_gates(loop, hist_c, seen_c,
                                                                  workers)
        for name, problems in caught.items():
            log(f"phase 4r planted fault {name}: its gates report {problems}")
        return launches, {name: bool(p) for name, p in caught.items()}
    finally:
        if loop is not None:
            loop.stop()
        if fleet is not None:
            fleet.stop()
        for server in servers:
            server.shutdown()


def ppo_part(card: str) -> None:
    """4r (e): PPO on CartPole with the learner on the card, on a runtime
    the caller started."""
    import numpy as np

    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.module import tree_leaves, tree_map

    algo = rl.PPO(rl.PPOConfig(env_fn=rl.CartPole, num_env_runners=2,
                               rollout_steps_per_runner=256, minibatch_size=128, num_epochs=2),
                  device=RL_DEVICE)
    t1 = time.monotonic()
    outs = [algo.train() for _ in range(RL_STEPS)]
    log(f"phase 4r (e): PPO on CartPole, the learner on the card: losses "
        f"{[round(o['loss'], 6) for o in outs]}, episode return mean "
        f"{[round(o['episode_return_mean'], 2) for o in outs]}, {RL_STEPS} iterations in "
        f"{time.monotonic() - t1:.2f}s")
    if not all(math.isfinite(o["loss"]) for o in outs):
        fail("phase 4r (e): a PPO loss is not finite")
    rng = np.random.default_rng(0)
    n = 128
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "returns": rng.normal(size=n).astype(np.float32)}
    host = rl.PPO(rl.PPOConfig(env_fn=rl.CartPole, num_env_runners=0), device="cpu",
                  params=tree_map(lambda t: t.detach().cpu().clone(), algo.params))
    host.opt_state = {"count": algo.opt_state["count"],
                      "mu": tree_map(lambda t: t.cpu().clone(), algo.opt_state["mu"]),
                      "nu": tree_map(lambda t: t.cpu().clone(), algo.opt_state["nu"])}
    _, _, aux_c = algo._update(algo.params, algo.opt_state, batch)
    _, _, aux_h = host._update(host.params, host.opt_state, batch)
    gap = max(float((a.detach().cpu() - h.detach()).abs().max())
              for a, h in zip(tree_leaves(algo.params), tree_leaves(host.params)))
    loss_gap = abs(float(aux_c["loss"]) - float(aux_h["loss"]))
    log(f"phase 4r (e): one update on the card against the same on the CPU: largest "
        f"parameter gap {gap:.3e}, loss gap {loss_gap:.3e} (limit {PPO_UPDATE_TOL}); {card}")
    if not (gap <= PPO_UPDATE_TOL and loss_gap <= PPO_UPDATE_TOL):
        fail("phase 4r (e): the update on the card leaves the CPU's")


def rl_path(card: str) -> dict:
    """Phase 4r: rl/ on the card (RL_MODEL, RL_DEVICE). (a) GRPO at
    bench_grpo's configuration (f32 parameters from seed 0, group 8, 16
    new tokens, temperature 1.0, factored, prompt 1..32, the unique-token
    reward): a train_step at learning rate 0 leaves the parameters
    bit-identical, then RL_STEPS at RL_LR: finite losses, ref_params
    bit-identical to the init, KL > 0 after the first nonzero step,
    launches exactly grpo_launches; the gradient gate on the GRPO loss at
    the init, each path on-policy, at seeded positive advantages over 8
    rows of RL_GATE_TOKENS seeded tokens (BWD_FAULTS): in bf16 each path
    against the f32 plain path's gradients (witness_gate), and in f32
    kernel path against plain path (phase 4's gradient_gate). (b)
    OnlineRLLoop over FleetController(
    DisaggCoordinator(a prefill- and a decode-role LLMServer engine over
    bf16 copies of the trainer's weights)) at the fleet's defaults, its
    evaluation loop running: two seeded 32-token prompts, group 8, 16 new
    tokens, the half-vocab reward, RL_STEPS iterations; every rollout
    stamped with a logprob a token and the loop's version at submission,
    iteration 1's rollout logprobs within LOGPROB_TOL of the trainer's
    _seq_logp, every replica, asked itself, at loop.version after the
    syncs (the skew gauge, from gossip, printed), each ledger a
    partition, no fleet scale-up (C15), K3/K4
    in the updates (once a layer an update); then a greedy stream of a
    RL_STREAM_PROMPT-token prompt held across a fourth sync ends whole and
    in vocab; over the iterations and the stream, K1, K2, K5 and K6 in
    graph replays (K6 from the stream's chunked prefill: a 32-token
    rollout prompt takes a prefill bucket, and the prefix cache matches
    only chunk-aligned runs). (c) RL_FAULTS (the reference policy aliased to the trained
    one, a sync reported without the swap, rollout logprobs discarded)
    must each fail its gate. (d) after loop.stop() and the engines'
    shutdown, card memory within RL_MEMORY_TOL of the phase's start and no
    thread the phase started alive. (e) PPO on CartPole with the learner
    on the card: RL_STEPS iterations with finite losses, and one update on
    the card against the same update on the CPU within PPO_UPDATE_TOL.
    Returns {"launches": (a)'s and (b)'s counts}."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import get_config

    t_phase = time.monotonic()
    release()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    threads0 = {t.ident for t in threading.enumerate()}
    cfg = get_config(RL_MODEL)
    launches_a, caught_alias = grpo_part(card, cfg, list(range(1, RL_PROMPT_LEN + 1)))
    t_b = time.monotonic()
    rt.init(num_cpus=8, system_config=RUNTIME_FLAGS)
    try:
        launches_b, caught = online_part(card, cfg)
    finally:
        rt.shutdown()
    caught["ref_policy_aliased"] = caught_alias
    if sorted(caught) != sorted(RL_FAULTS):
        fail(f"phase 4r: planted {sorted(caught)}, not RL_FAULTS")
    for name, hit in caught.items():
        log(f"phase 4r planted fault {name}: its gate fails {hit}")
        if not hit:
            fail(f"phase 4r: its gates pass planted fault {name}")
    # (d) cleanup
    deadline = time.monotonic() + 10.0
    while True:
        left = [t.name for t in threading.enumerate() if t.ident not in threads0]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    release()
    mem = torch.cuda.memory_allocated()
    log(f"phase 4r (d): (b) and (c) took {time.monotonic() - t_b:.1f}s; card memory "
        f"{mem / 2**30:.3f} GiB against {mem0 / 2**30:.3f} GiB at the phase's start (limit "
        f"+{RL_MEMORY_TOL / 2**30:.2f}); threads the phase started still alive: {left}")
    if mem - mem0 > RL_MEMORY_TOL or left:
        fail("phase 4r (d): the phase left card memory or threads behind")
    rt.init(num_cpus=8, system_config=RUNTIME_FLAGS)
    try:
        ppo_part(card)
    finally:
        rt.shutdown()
    release()
    log(f"phase 4r: the phase took {time.monotonic() - t_phase:.1f}s ({card})")
    return {"launches": {n: launches_a[n] + launches_b[n] for n in launches_a}}


# gather against dense at the training shape, in f32 (layer 0's weights
# cast): both give each token the same k weighted expert rows, summed in
# another order, so any gap beyond f32 rounding (~1e-7 of the output's
# scale) is a routing or indexing fault. In bf16 the gather rounds each
# weighted row before the sum, and where the rows cancel the gap reaches
# an ulp of the rows, not of the output (1.56e-2 at |output| <= 2.83 on
# the H100): a bound there would be loose.
MOE_FORM_TOL = 1e-5  # of the dense form's largest |output|


class OneRouting:
    """transformer.top_k_gating for the passes of a gradient gate: the first
    pass routes as the model does and records each call's expert ids; every
    later pass takes the ids of the same call of the first, with gate
    weights softmaxed over its own logits at those ids (what top-k gives
    where the ids agree). So every pass routes every token, and drops the
    same assignments, alike: bf16 rounding elsewhere cannot flip a choice
    and open a gap that no fault made."""

    def __init__(self, transformer):
        self.transformer, self.gating = transformer, transformer.top_k_gating
        self.ids, self.at = [], None

    def __call__(self, logits, k):
        if self.at is None:
            w, ids = self.gating(logits, k)
            self.ids.append(ids)
            return w, ids
        ids = self.ids[self.at]
        self.at += 1
        return torch.softmax(logits.gather(-1, ids), dim=-1), ids

    @contextlib.contextmanager
    def one_pass(self):
        with swapped(self.transformer, top_k_gating=self):
            yield
        if self.at is not None and self.at != len(self.ids):
            fail(f"a gate pass routed {self.at} times, the first {len(self.ids)}")
        self.at = 0


@contextlib.contextmanager
def plain_moe_path():
    """plain_path with the MoE layers in the dense dispatch/combine form,
    an independent formulation of the same routing."""
    from ray_tpu_torch.models import transformer

    with plain_path(), swapped(transformer, _moe_ffn_gather=transformer._moe_ffn_dense):
        yield


def _gate_weights_detached(f):
    """The gate weights reach the combine detached: the router learns from
    the load-balance loss alone."""
    def gating(logits, k):
        w, ids = f(logits, k)
        return w.detach(), ids
    return gating


def _expert_inputs_detached(f):
    """The experts' inputs are detached: no gradient flows back through the
    FFN into the residual stream."""
    return lambda expert_in, lp: f(expert_in.detach(), lp)


# MoE faults the gradient gate must catch, planted on
# ray_tpu_torch.models.transformer: name -> (attribute, wrapper maker)
MOE_BWD_FAULTS = {
    "gate_weights_detached": ("top_k_gating", _gate_weights_detached),
    "expert_inputs_detached": ("_experts", _expert_inputs_detached),
    "combine_reads_next_slot": ("_moe_combine", _next_slot),
}


def moe_train_path(card: str, profile: bool) -> dict:
    """Phase 6: moe-1b trained as the reference's bench_moe (bench.py:1711:
    2 x 1024 tokens, factored, bf16 parameters, 2 warm and 8 timed steps),
    then its dense twin (llama-600m at moe-1b's backbone, d_ff = k x 4096),
    and moe_dispatch_overhead_pct by bench_moe's formula. On the trained
    parameters, the gather form against the dense form on one input at the
    training shape (one routing: a top-k flip cannot excuse a gap)."""
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.models import transformer

    B, T, warm, timed = 2, 1024, 2, 8
    moe_cfg = get_config("moe-1b")
    moe = factored_train("phase 6: train moe-1b", moe_cfg, B, T, warm + timed, warm, profile)
    lp = {k: v.float() for k, v in
          transformer.layer_views(moe["state"]["params"]["layers"])[0].items()}
    # a direction every token shares skews the routing, so that experts
    # overflow and the capacity drops take part in the comparison
    dev = lp["router"].device
    gen = torch.Generator(device=dev).manual_seed(6)
    shared = 2.0 * torch.randn((moe_cfg.d_model,), generator=gen, device=dev)
    x = torch.randn((B, T, moe_cfg.d_model), generator=gen, device=dev) + shared
    with torch.no_grad():
        y_g, aux_g = transformer._moe_ffn_gather(x, lp, moe_cfg)
        y_d, aux_d = transformer._moe_ffn_dense(x, lp, moe_cfg)
        keep = transformer._moe_route(x, lp["router"], moe_cfg)[5]
    err, scale = (y_g - y_d).abs().max().item(), y_d.abs().max().item()
    log(f"phase 6: gather against dense on layer 0 at [{B}, {T}, {moe_cfg.d_model}] f32 "
        f"(capacity {transformer._moe_route(x[:, :1], lp['router'], moe_cfg)[-1]} at T = 1, "
        f"{transformer._moe_route(x, lp['router'], moe_cfg)[-1]} at T = {T}; "
        f"{int((~keep).sum())} of {keep.numel()} assignments dropped): max |gather - dense| "
        f"{err:.3e}, max |dense| {scale:.3e} (tol {MOE_FORM_TOL} of it), aux "
        f"{aux_g.item():.6f} / {aux_d.item():.6f}")
    if not err <= MOE_FORM_TOL * scale or aux_g.item() != aux_d.item():
        fail("phase 6: the gather form disagrees with the dense form")
    if bool(keep.all()):
        fail("phase 6: no assignment was dropped, so the comparison left capacity out")
    del lp, x, y_g, y_d
    # the gradient gate on the trained bf16 parameters: the kernel path in
    # the gather form against the plain attention and norms in the dense
    # form, every pass on the first pass's routing, router and expert leaves
    # included; the kernels' backward faults and the MoE faults planted
    params = moe["state"]["params"]
    moe["state"]["opt_state"] = None
    release()
    from ray_tpu_torch import ops, train

    faults = {name: (getattr(ops, module), attr, make)
              for name, (module, attr, make) in BWD_FAULTS.items()}
    faults.update({name: (transformer, attr, make)
                   for name, (attr, make) in MOE_BWD_FAULTS.items()})
    gradient_gate("phase 6: moe-1b gradient gate", params, train.synthetic_batch(
        moe_cfg, B, T, seed=0), moe_cfg, plain_moe_path, faults,
        OneRouting(transformer).one_pass)
    del moe["state"], params
    release()
    dense_cfg = get_config("llama-600m", n_layers=moe_cfg.n_layers, d_model=moe_cfg.d_model,
                           n_heads=moe_cfg.n_heads, n_kv_heads=moe_cfg.n_kv_heads,
                           head_dim=moe_cfg.head_dim,
                           d_ff=moe_cfg.num_selected_experts * moe_cfg.d_ff)
    dense = factored_train("phase 6: train the dense twin", dense_cfg, B, T, warm + timed, warm,
                           profile)
    del dense["state"]
    release()
    overhead = 100.0 * max(moe["step_s"] - dense["step_s"], 0.0) / moe["step_s"]
    log(f"phase 6 (moe-1b, {B} x {T}; {card}): step {moe['step_s']:.4f} s, "
        f"{moe['tokens_s']:.1f} tokens/s, peak {moe['peak'] / 2**30:.2f} GiB; dense twin step "
        f"{dense['step_s']:.4f} s, {dense['tokens_s']:.1f} tokens/s, peak "
        f"{dense['peak'] / 2**30:.2f} GiB; moe_dispatch_overhead_pct {overhead:.2f} "
        f"(100 max(t_moe - t_dense, 0) / t_moe)")
    launches = {k: moe["launches"][k] + dense["launches"][k] for k in moe["launches"]}
    return {"launches": launches, "overhead_pct": overhead}


def moe_dynamics(card: str) -> None:
    """--moe-dynamics: moe-1b trained as phase 6 trains it (2 x 1024 tokens
    of one synthetic batch, adafactor after a warmup of 2, 10 steps) under
    variants, each from the same seed, every step's loss, cross-entropy,
    load-balance loss, gradient norm and accuracy printed: phase 6's own
    recipe; the same with the plain attention and norms and the MoE layers
    in the dense form (an independent forward and backward); a learning
    rate of 1e-4; f32 parameters. It gates nothing and prints no result
    line: it tells a fault of the kernel path from the recipe's dynamics."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import get_config

    cfg = get_config("moe-1b")
    B, T, steps = 2, 1024, 10
    batch = train.synthetic_batch(cfg, B, T, seed=0)
    variants = {  # label -> (learning rate, bf16 parameters, path)
        "phase 6's recipe (lr 3e-4, bf16 parameters)": (3e-4, True, contextlib.nullcontext),
        "plain attention and norms, dense MoE form": (3e-4, True, plain_moe_path),
        "lr 1e-4": (1e-4, True, contextlib.nullcontext),
        "f32 parameters": (3e-4, False, contextlib.nullcontext),
    }
    for label, (lr, bf16, path) in variants.items():
        opt = train.make_optimizer(learning_rate=lr, warmup_steps=2, total_steps=100,
                                   factored=True)
        state = train.init_train_state(cfg, opt, seed=0)
        if bf16:
            bf16_params(state)
        step = train.make_train_step(cfg, opt)
        rows = []
        with path():
            for _ in range(steps):
                state, m = step(state, batch)
                rows.append(" ".join(f"{float(m[k]):.4f}" for k in
                                     ("loss", "ce_loss", "aux_loss", "grad_norm", "accuracy")))
        log(f"moe-1b dynamics, {label} (per step: loss ce aux grad_norm accuracy): "
            f"{' | '.join(rows)}; {card}")
        del state, step, opt
        release()


def ab_compare(variant_csrc: str, card: str) -> None:
    """Kernel variants side by side in one process: the kernel library of
    this checkout (A) and one built from `variant_csrc` (B, a copy of
    ray_tpu_torch/csrc with one change), each checked against the plain
    version, then timed in turns A B B A, bf16: K1's forward at decode
    ([8, 4096]) and at the training block ([8192, 2560], f32 w) and its
    backward at the training block, K4 at the training shape, K5 at the
    engine's batch and at one sequence of 1024 keys, K6 at the engine's
    256-query chunk at start 512, and K7 at the engine's verify span (B=8,
    S=5) and at one sequence of 1024 keys."""
    from pathlib import Path

    from ray_tpu_torch.ops import attention, dispatch, norm, paged_attention

    lib_a = dispatch.library()
    saved = dispatch.CSRC_DIR, dispatch.BUILD_ROOT
    dispatch.CSRC_DIR = Path(variant_csrc).resolve()
    dispatch.BUILD_ROOT = dispatch.CSRC_DIR.parent / "_build"
    try:
        lib_b = dispatch.load(dispatch.build())
    finally:
        dispatch.CSRC_DIR, dispatch.BUILD_ROOT = saved
    with open(dispatch.BUILD_INFO["log"]) as f:
        for name, res in ptxas_report(f.read()).items():
            log(f"  B {name}: {res.get('registers', '?')} registers, spill stores "
                f"{res.get('spill_stores', '?')} B")

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    B, T, H, KVH, D = 4, 2048, 20, 5, 128
    q, do, k, v = rnd((B, T, H, D)), rnd((B, T, H, D)), rnd((B, T, KVH, D)), rnd((B, T, KVH, D))
    o, lse = attention._fwd_reference_with_lse(q, k, v)
    delta = attention._attention_delta(o, do)
    want_dkv = attention._dkv_reference(q, k, v, do, lse, delta)
    kp, vp = rnd((8, 512, 16, 128)), rnd((8, 512, 16, 128))
    table = torch.randint(1, 512, (8, 64), generator=gen, device="cuda", dtype=torch.int32)
    q8, q1 = rnd((8, 32, 128)), rnd((1, 32, 128))
    l8 = torch.tensor([0, 1, 17, 100, 333, 700, 1000, 1024], dtype=torch.int32, device="cuda")
    l1 = torch.tensor([1024], dtype=torch.int32, device="cuda")
    t1 = table[:1].contiguous()
    q6, q7, q71 = rnd((256, 32, 128)), rnd((8, 5, 32, 128)), rnd((1, 5, 32, 128))
    p8 = torch.tensor([20, 100, 333, 500, 640, 777, 850, 900], dtype=torch.int32, device="cuda")
    p1 = torch.tensor([1019], dtype=torch.int32, device="cuda")
    t5 = table[5].contiguous()
    meta6 = torch.tensor([512, 768], dtype=torch.int32, device="cuda")
    meta6 = [meta6[:1], meta6[1:]]  # read in place by K6, as the chunk programs pass them
    xd, wd = rnd((8, 4096)), 1.0 + 0.1 * rnd((4096,))
    xt, gt = rnd((8192, 2560)), rnd((8192, 2560))
    wt = 1.0 + 0.1 * torch.randn((2560,), generator=gen, device="cuda")
    # name -> (call, its plain result, the TOL kinds of its outputs)
    att = ("attention", dt)
    calls = {
        "K1 [8,4096] bf16": (lambda: norm.rms_norm(xd, wd, 1e-5),
                             norm.rms_norm_reference(xd, wd, 1e-5), [("rms_norm", dt)]),
        "K1 [8192,2560] bf16/f32": (lambda: norm.rms_norm(xt, wt, 1e-5),
                                    norm.rms_norm_reference(xt, wt, 1e-5), [("rms_norm", dt)]),
        "K1 backward [8192,2560] bf16/f32": (
            lambda: norm.rms_norm_bwd(xt, wt, gt, 1e-5), norm._rms_bwd(xt, wt, gt, 1e-5),
            [("rms_norm", dt), ("rms_norm_dw", torch.float32)]),
        "K4 B=4 T=2048 H=20/5": (
            lambda: attention.flash_attention_bwd_dkv(q, k, v, do, lse, delta), want_dkv,
            [att, att]),
        "K5 B=8 lengths 0..1024": (
            lambda: paged_attention.paged_attention_decode(q8, kp, vp, table, l8),
            paged_attention._paged_reference(q8, kp, vp, table, l8, 128 ** -0.5), [att]),
        "K5 B=1 length 1024": (
            lambda: paged_attention.paged_attention_decode(q1, kp, vp, t1, l1),
            paged_attention._paged_reference(q1, kp, vp, t1, l1, 128 ** -0.5), [att]),
        "K6 C=256 start 512": (
            lambda: paged_attention.paged_attention_chunk(q6, kp, vp, t5, *meta6),
            paged_attention._chunk_reference(q6, kp, vp, t5, 512, 768, 128 ** -0.5), [att]),
        "K7 B=8 S=5 positions 20..900": (
            lambda: paged_attention.paged_attention_verify(q7, kp, vp, table, p8),
            paged_attention._verify_reference(q7, kp, vp, table, p8, 128 ** -0.5), [att]),
        "K7 B=1 S=5 1024 keys": (
            lambda: paged_attention.paged_attention_verify(q71, kp, vp, t1, p1),
            paged_attention._verify_reference(q71, kp, vp, t1, p1, 128 ** -0.5), [att]),
    }
    for name, (fn, want, kinds) in calls.items():
        times = {"A": [], "B": []}
        for which in "ABBA":
            dispatch._lib = lib_a if which == "A" else lib_b
            got = fn()
            for g, w, (kind, kdt) in zip(got if isinstance(got, tuple) else (got,),
                                         want if isinstance(want, tuple) else (want,), kinds):
                check_close(f"{name} ({which})", kind, kdt, g, w)
            times[which].append(device_ms(fn, 5, 3))
        dispatch._lib = lib_a
        log(f"A/B {name}: A {[round(t, 4) for t in times['A']]} ms, "
            f"B {[round(t, 4) for t in times['B']]} ms ({card})")


def readback_ab(card: str, rounds: int = 4) -> None:
    """--readback-ab: phase 3's llama3-8b server serves phase 3's burst
    (five requests at once, prompts of 23/100/200/700/50, 32 tokens, one
    sampled; fresh prompts each burst, so no prefix is cached) with the
    engine's readbacks into pinned memory (programs.read_back, "pinned")
    and into pageable memory as before it ("pageable"), in turns pinned,
    pageable, pageable, pinned, `rounds` times, after one burst that is
    discarded. Prints each burst's TTFT p50 and max, TPOT p50 and output
    tok/s, then the median of each by form."""
    from ray_tpu_torch.serve import engine as engine_mod

    server = new_server("--readback-ab: LLMServer llama3-8b", model_name="llama3-8b",
                        engine_config=ENGINE, seed=0)
    rng = torch.Generator().manual_seed(21)
    V = server.engine.cfg.vocab_size

    def burst():
        def prompt(n):
            return torch.randint(1, V, (n,), generator=rng).tolist()

        return [{"prompt_ids": prompt(n), "max_tokens": 32} for n in (23, 100, 200, 700)] + [
            {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9}]

    def pageable():
        return swapped(engine_mod, read_back=lambda *ts: tuple(t.to("cpu", copy=True)
                                                                for t in ts))

    figures = {"pinned": [], "pageable": []}
    run_requests(server, burst())
    for _ in range(rounds):
        for form in ("pinned", "pageable", "pageable", "pinned"):
            requests = burst()
            with pageable() if form == "pageable" else contextlib.nullcontext():
                results, wall, errors = run_requests(server, requests)
            if errors:
                server.shutdown()
                fail(f"--readback-ab {form}: {errors}")
            ttft = sorted(r["ttft_s"] for r in results)
            tpot = statistics.median((r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1)
                                     for r in results)
            row = (1e3 * statistics.median(ttft), 1e3 * ttft[-1], 1e3 * tpot,
                   sum(len(r["token_ids"]) for r in results) / wall)
            figures[form].append(row)
            log(f"--readback-ab {form}: TTFT p50 {row[0]:.2f} max {row[1]:.2f} ms, TPOT p50 "
                f"{row[2]:.2f} ms, {row[3]:.2f} tok/s")
    for form, rows in figures.items():
        med = [statistics.median(col) for col in zip(*rows)]
        log(f"--readback-ab {form}, median of {len(rows)} bursts ({card}): TTFT p50 "
            f"{med[0]:.2f} max {med[1]:.2f} ms, TPOT p50 {med[2]:.2f} ms, {med[3]:.2f} tok/s")
    server.shutdown()


# ------------------------------------------------------- phase 4o: observability

OBSERVE_MODEL = "llama3-8b"
OBSERVE_DEVICE = None  # LLMServer's device: None is the card
OBSERVE_LENGTHS = (23, 100, 200, 700, 50, 64, 300, 150)  # 700: the chunked prefill, K6
OBSERVE_KERNELS = ("rms_norm", "flash_attention", "paged_attention_decode",
                   "paged_attention_chunk")
# the kernel symbols gate (b) looks for in the device trace (PERF.md §6):
# K1's forward and K5's split decode
OBSERVE_TRACE_STEMS = ("rms_norm_fwd_", "paged_decode_split_kernel")


class NamedServer:
    """Phase 4o's named GPU actor: an LLMServer built from its config alone
    (weights from a seed), so that its creation spec holds no tensor and a
    snapshot can re-create it."""

    def __init__(self, model_name: str, engine_config: dict, seed: int, device=None):
        from ray_tpu_torch.serve import LLMServer

        t0 = time.monotonic()
        self.server = LLMServer._target(model_name=model_name, engine_config=engine_config,
                                        seed=seed, device=device)
        if self.server.engine.params["embed"].is_cuda:
            torch.cuda.synchronize()
        self.built_s = time.monotonic() - t0

    def built(self) -> float:
        return self.built_s

    def weight_bytes(self) -> int:
        return sum(t.nbytes for _, t in named_leaves(self.server.engine.params))

    def generate(self, request):
        return self.server(request)

    def shutdown(self) -> None:
        self.server.shutdown()


class Parked:
    """A CPU actor (an actor process) for gate (c)'s stack dump."""

    def parked_for_stack_dump(self, seconds: float) -> int:
        time.sleep(seconds)
        return os.getpid()


def observe_child_snapshot():
    """A pool task: the child's device-memory snapshot and its device files."""
    from ray_tpu_torch.util import profiler

    return (os.getpid(), profiler.device_memory_snapshot(),
            [x for x in cuda_in(os.getpid()) if x.startswith("/dev/nvidia")])


def observe_log_line(tag: str) -> int:
    print(f"{tag} from pid {os.getpid()}", flush=True)
    return os.getpid()


def observe_sleeper(pid_file: str, seconds: float) -> int:
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(seconds)
    return os.getpid()


def observe_requests(cfg) -> list:
    rng = torch.Generator().manual_seed(21)
    return [{"prompt_ids": torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist(),
             "max_tokens": 32} for n in OBSERVE_LENGTHS]


def observe_burst(rt, host, requests, label: str, counts: dict, traced: bool = False):
    """All requests through the actor's handle at once (each under a root
    span when `traced`); adds the launches to `counts`. -> the results."""
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.util import tracing

    dispatch.reset_launches()
    t0 = time.monotonic()
    refs = []
    for r in requests:
        if traced:
            with tracing.start_span("phase4o.request", {"prompt": len(r["prompt_ids"])}):
                refs.append(host.generate.remote(r))
        else:
            refs.append(host.generate.remote(r))
    results = rt.get(refs, timeout=600)
    wall = time.monotonic() - t0
    got = dispatch.launch_counts()
    for k in counts:
        counts[k] += got[k]
    missing = [k for k in OBSERVE_KERNELS if got[k] == 0]
    if missing:
        fail(f"phase 4o {label}: no launch of {missing} ({got})")
    report_burst(f"phase 4o {label}", requests, results, wall)
    return results


def observe_bursts(rt, host, requests, label: str, counts: dict, n: int = 3,
                   traced: bool = False):
    """`n` bursts in turn (observe_burst, each gated); -> (the last's results,
    every burst's TPOT p50 in ms), so that a cost is read over repeats."""
    tpots = []
    for i in range(n):
        results = observe_burst(rt, host, requests, f"{label} {i + 1}/{n}", counts, traced)
        tpots.append(tpot_ms(results))
    return results, tpots


def tpots_line(tpots) -> str:
    return f"{statistics.median(tpots):.2f} ms ({', '.join(f'{t:.2f}' for t in tpots)})"


def tpot_ms(results) -> float:
    return 1e3 * statistics.median((r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1)
                                   for r in results)


def trace_kernels(path: str) -> dict:
    """{kernel name: device us summed} of a torch.profiler chrome trace."""
    with open(path) as f:
        doc = json.load(f)
    out: dict = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            out[ev["name"]] = out.get(ev["name"], 0.0) + float(ev.get("dur", 0.0))
    return out


def observe_path(card: str) -> dict:
    """Phase 4o: single-host observability and tooling around a named
    llama3-8b server on the card; see the module docstring. Returns the
    launches of the served bursts."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import job_submission, microbenchmark
    from ray_tpu_torch.core import health, log_monitor, persistence
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.util import flight_recorder, profiler, sanitizer

    t_phase = time.monotonic()
    counts = {k: 0 for k in dispatch.KERNELS}
    cfg = get_config(OBSERVE_MODEL)
    requests = observe_requests(cfg)
    rt.shutdown()
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="phase4o-")
    snap_path = os.path.join(tmp, "control_plane.snap")

    # (a) set up: the sanitizer first, then the runtime and the named actor
    sanitizer.clear_reports()
    sanitizer.install()
    t0 = time.monotonic()
    runtime = rt.init(system_config={"control_plane_snapshot_path": snap_path,
                                     "control_plane_snapshot_interval_s": 1.0})
    agent = next(iter(runtime.agents.values()))
    t_init = time.monotonic() - t0
    host_cls = rt.remote(num_gpus=1, max_concurrency=8)(NamedServer)
    host = host_cls.options(name="llm").remote(OBSERVE_MODEL, ENGINE, 0, OBSERVE_DEVICE)
    built_s = rt.get(host.built.remote(), timeout=900)
    log(f"phase 4o (a): sanitizer installed, init() in {t_init:.2f}s (worker processes and "
        f"actor processes at their defaults, snapshots every 1 s), the named GPU actor 'llm' "
        f"built an LLMServer {OBSERVE_MODEL} in {built_s:.1f}s ({card})")
    observe_burst(rt, host, requests, "(a) warm-up burst", counts)
    plain, tpot_plain = observe_bursts(rt, host, requests, "(a) burst, recorder detached",
                                       counts)
    flight_recorder.attach(component="driver")
    attached, tpot_attached = observe_bursts(rt, host, requests,
                                             "(a) burst, recorder attached", counts,
                                             traced=True)
    spans_a = [e for e in flight_recorder.snapshot() if e["kind"] == "span"]
    want = [r["token_ids"] for r in plain]
    if [r["token_ids"] for r in attached] != want:
        fail("phase 4o (a): the same greedy prompts gave other tokens with the recorder on")
    log(f"phase 4o (a): TPOT p50, median of 3 bursts: {tpots_line(tpot_plain)} without the "
        f"flight recorder, {tpots_line(tpot_attached)} with it attached and every request "
        "traced")

    # (b) a device trace over a third burst, through the node agent
    started = agent.profile_start(kind="torch", duration_s=6.0)
    traced = observe_burst(rt, host, requests, "(b) burst under the device trace", counts)
    fetched = agent.profile_fetch(kind="torch")
    if not fetched["files"]:
        fail(f"phase 4o (b): the device trace wrote no file ({fetched}, {started})")
    trace = fetched["files"][0]
    kernels = trace_kernels(trace)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"phase 4o (b): device trace {trace}: {os.path.getsize(trace) / 2**20:.1f} MiB, "
        f"{len(kernels)} kernel names, {sum(kernels.values()) / 1e3:.1f} ms of kernels; "
        f"TPOT p50 {tpot_ms(traced):.2f} ms under it; top by device time: "
        + "; ".join(f"{_kernel_name(n)[:60]} {us / 1e3:.2f} ms" for n, us in top))
    require_kernels("phase 4o (b) device trace", list(kernels), OBSERVE_TRACE_STEMS)

    # (c) the sampling profiler over a burst, and a live child's stack
    agent.profile_start(kind="cpu", duration_s=30.0)
    sampled, tpot_sampled = observe_bursts(rt, host, requests, "(c) burst under the sampler",
                                           counts)
    prof = agent.profile_fetch(kind="cpu")
    top_stacks = sorted(profiler.parse_collapsed(prof["collapsed"]).items(),
                        key=lambda kv: -kv[1])[:3]
    log(f"phase 4o (c): {prof['samples']} samples at {config.profiler_sample_hz} Hz; TPOT p50 "
        f"{tpots_line(tpot_sampled)} sampled against {tpots_line(tpot_attached)} before "
        "(recorder attached in both); hottest stacks: "
        + " | ".join(f"{n}x ...{s[-100:]}" for s, n in top_stacks))
    if prof["samples"] <= 0:
        fail("phase 4o (c): the sampling profiler took no sample")
    parked = rt.remote(Parked).remote()
    parked_ref = parked.parked_for_stack_dump.remote(4.0)
    pids = {}
    for _ in range(100):
        pids = agent.profile_fetch(kind="pids")
        if pids["actors"]:
            break
        time.sleep(0.1)
    if not pids["actors"]:
        fail(f"phase 4o (c): no actor process to dump ({pids})")
    child = next(iter(pids["actors"].values()))
    time.sleep(1.0)  # the call reaches its method
    stack = agent.profile_fetch(pid=child, kind="stack")
    found = "parked_for_stack_dump" in stack["text"]
    log(f"phase 4o (c): stack dump of actor process {child}: {len(stack['text'])} bytes, "
        f"names parked_for_stack_dump: {found}")
    if not found:
        fail(f"phase 4o (c): the child's stack dump does not name its method:\n{stack['text']}")
    if rt.get(parked_ref, timeout=60) != child:
        fail("phase 4o (c): the parked call ran in another process")
    rt.kill(parked)

    # (d) device memory: the allocator's view in the driver, zeros in a child
    weight_bytes = rt.get(host.weight_bytes.remote(), timeout=60)
    for _ in range(5):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        snap = profiler.device_memory_snapshot()
        after = torch.cuda.memory_allocated()
        if before == after:
            break
    dev0 = snap["devices"][0] if snap["devices"] else {}
    log(f"phase 4o (d): device_memory_snapshot {dev0}, live blocks {snap['live_arrays']} "
        f"({snap['live_bytes'] / 2**30:.3f} GiB); memory_allocated {before}; weights "
        f"{weight_bytes / 2**30:.3f} GiB")
    if snap["backend"] != "cuda" or dev0.get("bytes_in_use") != before or before != after:
        fail(f"phase 4o (d): the snapshot's bytes_in_use {dev0.get('bytes_in_use')} against "
             f"memory_allocated {before} / {after}")
    if before < weight_bytes:
        fail(f"phase 4o (d): {before} bytes in use, below the weights' {weight_bytes}")
    cpid, csnap, cfiles = rt.get(rt.remote(observe_child_snapshot).remote(), timeout=120)
    log(f"phase 4o (d): a pool task (pid {cpid}) reads {csnap}; its device files {cfiles}")
    if (cpid == os.getpid() or csnap["backend"] is not None or csnap["devices"]
            or csnap["live_bytes"] or cfiles):
        fail("phase 4o (d): the pool task's snapshot is not zeros in a child without CUDA")

    # (e) the health payload's utilization and goodput
    plane = health.get_health_plane()
    plane.evaluate()
    payload = plane.payload()
    util, goodput = payload["utilization"], payload["goodput"]
    parts = sum(goodput.get(k, 0.0) for k in profiler.LEDGER_COMPONENTS)
    log(f"phase 4o (e): utilization {util}; goodput {goodput}")
    if not util.get("head"):
        fail(f"phase 4o (e): no utilization row for the node ({util})")
    if not goodput or abs(parts - goodput["wall_seconds"]) > 1e-9 * max(1.0, parts):
        fail(f"phase 4o (e): the goodput components {parts} do not partition the wall")
    health.shutdown_health_plane()  # its evaluation thread ends here

    # (f) persistence: a snapshot, shutdown, resume, the same tokens
    t_wait = time.monotonic()
    while time.monotonic() - t_wait < 30:
        if os.path.exists(snap_path) and "llm" in persistence.load_snapshot(
                snap_path)["named_actors"]:
            break
        time.sleep(0.2)
    else:
        fail("phase 4o (f): no snapshot named the actor within 30 s")
    stored = persistence.load_snapshot(snap_path)
    log(f"phase 4o (f): snapshot {os.path.getsize(snap_path)} bytes, named actors "
        f"{sorted(stored['named_actors'])}, jobs {len(stored['jobs'])}")
    rt.get(host.shutdown.remote(), timeout=120)
    rt.shutdown()
    del host
    gc.collect()
    torch.cuda.synchronize()
    mem_down = torch.cuda.memory_allocated()
    log(f"phase 4o (f): card memory {mem0 / 2**30:.3f} GiB before (a), "
        f"{mem_down / 2**30:.3f} GiB after shutdown()")
    if mem_down - mem0 > 2**30:
        fail(f"phase 4o (f): the card holds {(mem_down - mem0) / 2**30:.3f} GiB more after "
             "shutdown() than before (a)")
    hold = sanitizer.reports()
    sanitizer.uninstall()  # the restored runtime runs on stock locks
    t0 = time.monotonic()
    rt.init(resume_from=snap_path)
    restored = rt.get_actor("llm")
    t_get = time.monotonic() - t0
    first = restored.generate.remote(requests[0])
    done, _ = rt.wait([first], num_returns=1, timeout=900)
    if not done:
        fail("phase 4o (f): the restored actor answered nothing in 900 s")
    res0 = rt.get(first)
    first_token_s = time.monotonic() - t0 - (res0["latency_s"] - res0["ttft_s"])
    observe_burst(rt, restored, requests, "(f) warm-up burst after resume", counts)
    again, tpot_again = observe_bursts(rt, restored, requests, "(f) burst after resume",
                                       counts, traced=True)
    same = [r["token_ids"] for r in again] == want and res0["token_ids"] == want[0]
    log(f"phase 4o (f): init(resume_from=) to get_actor {t_get:.2f}s, to the first token "
        f"{first_token_s:.1f}s; the 8 prompts' tokens bit-equal to (a)'s: {same}; TPOT p50 "
        f"{tpots_line(tpot_again)} on stock locks against {tpots_line(tpot_attached)} under "
        "the sanitizer (both with the recorder attached and every request traced)")
    if not same:
        fail("phase 4o (f): the restored actor's tokens differ from (a)'s")

    # (g) a job in a driver process of its own, and a pool task's log line
    code = (f"import sys, torch; sys.path.insert(0, {HERE!r}); import ray_tpu_torch\n"
            "from ray_tpu_torch import ops\n"
            "g = torch.Generator(device='cuda').manual_seed(3)\n"
            "x = torch.randn(8, 4096, device='cuda', generator=g).bfloat16()\n"
            "w = torch.randn(4096, device='cuda', generator=g).bfloat16()\n"
            "d = (ops.rms_norm(x, w, 1e-5).float() - ops.rms_norm_reference(x, w, 1e-5)"
            ".float()).abs().max().item()\n"
            "print(f'phase4o-job rms_norm max |err| {d:.3e}', flush=True)\n")
    client = job_submission.JobSubmissionClient()
    t0 = time.monotonic()
    job = client.submit_job(entrypoint=f"{sys.executable} -c \"$PHASE4O_CODE\"",
                            runtime_env={"env_vars": {"PHASE4O_CODE": code}})
    status = client.wait_until_finish(job, timeout_s=300)
    logs = client.get_job_logs(job)
    line = [x for x in logs.splitlines() if x.startswith("phase4o-job")]
    log(f"phase 4o (g): job {job} {status} in {time.monotonic() - t0:.1f}s: {line}")
    if status != "SUCCEEDED" or not line:
        fail(f"phase 4o (g): the job ended {status}; its logs:\n{logs[-2000:]}")
    seen = []
    monitor = log_monitor.LogMonitor(sink=seen.append).start()
    try:
        wpid = rt.get(rt.remote(observe_log_line).remote("phase4o-log"), timeout=120)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10 and not any(
                "phase4o-log" in r["line"] for r in seen):
            time.sleep(0.1)
    finally:
        monitor.stop()
    hits = [r for r in seen if "phase4o-log" in r["line"]]
    log(f"phase 4o (g): the log monitor read {hits} (the task ran in pid {wpid})")
    if not hits or hits[0]["pid"] != str(wpid):
        fail("phase 4o (g): the log monitor missed the pool task's line or its pid")

    # (h) the core microbenchmarks on this host: run_all's cross-host rows
    # recycle the runtime into an RPC head with a joined process (phase 4n
    # runs the network; tests/test_torch_tooling.py the bench itself)
    with swapped(microbenchmark, bench_cross_host=lambda api, min_seconds=0.5: []):
        rows = microbenchmark.run_all(min_seconds=0.5)
    log("phase 4o (h): " + "; ".join(f"{r['metric']} {r['value']} {r['unit']}" for r in rows))

    # (i) the sanitizer's reports, the recorder's spans, a killed worker's postmortem
    cycles = [r for r in hold if r["violation"] == "lock_order_cycle"]
    holds = [r for r in hold if r["violation"] == "lock_hold"]
    log(f"phase 4o (i): sanitizer: {len(cycles)} lock-order cycles, {len(holds)} lock holds "
        f"over the budget: "
        + "; ".join(f"{r['site']} {r['held_ms']} ms" for r in holds[:12]))
    if cycles:
        fail(f"phase 4o (i): the sanitizer saw lock-order cycles: {cycles}")
    names = sorted({e["name"] for e in spans_a})
    log(f"phase 4o (i): after (a)'s traced burst the flight recorder held {len(spans_a)} "
        f"spans: {names[:8]}")
    if not any(n.startswith("execute:") for n in names) or "engine.generate" not in names:
        fail(f"phase 4o (i): no span of a served request in the flight recorder ({names})")
    pid_file = os.path.join(tmp, "sleeper.pid")
    victim = rt.remote(max_retries=0)(observe_sleeper).remote(pid_file, 60.0)
    t0 = time.monotonic()
    while not os.path.exists(pid_file) and time.monotonic() - t0 < 60:
        time.sleep(0.05)
    time.sleep(0.2)
    with open(pid_file) as f:
        vpid = int(f.read())
    os.kill(vpid, signal.SIGKILL)
    try:
        rt.get(victim, timeout=60)
        fail("phase 4o (i): the killed task returned")
    except Exception as e:  # noqa: BLE001 — the crash is what this gate waits for
        log(f"phase 4o (i): the killed task failed: {type(e).__name__}: {e}")
    arts = [p for p in flight_recorder.list_postmortems()
            if os.path.basename(p).startswith(f"postmortem-{vpid}-")]
    if not arts:
        fail(f"phase 4o (i): no postmortem of the killed worker {vpid}")
    art = flight_recorder.load_postmortem(arts[0])
    log(f"phase 4o (i): postmortem of pid {vpid}: cause {art['cause']!r}, exit code "
        f"{art['exitcode']}, {len(art['events'])} events, {len(art['spans'])} spans, "
        f"{len(art['stdout_tail'])} stdout lines")
    if art["pid"] != vpid or art["exitcode"] != -signal.SIGKILL:
        fail(f"phase 4o (i): the postmortem reads pid {art['pid']} exit {art['exitcode']}")

    rt.get(restored.shutdown.remote(), timeout=120)
    rt.shutdown()
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 4o: wall {time.monotonic() - t_phase:.1f}s; launches over its bursts "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"launches": counts}


# --------------------------------------------------------------- phase 4n

NETWORK_MODEL = "llama3-8b"
NETWORK_DEVICE = None  # the replicas' LLMServer device: None is the card
NETWORK_HEALTH_TIMEOUT_MS = 5000
# the head (this process) advertises no card; each joined host a share of it,
# room for two replicas: the controller replaces the killed host's replica
# on the survivor, as in the reference's serve test
NETWORK_HOST_GPUS = 1.0
NETWORK_REPLICA_GPUS = 0.5
NETWORK_TASK = {"num_cpus": 0, "resources": {"net_host": 0.1}}
# the second burst runs this share of the first burst's wall before the SIGKILL
NETWORK_KILL_AT = 0.4
# a request the killed host held fails with the runtime's typed errors
NETWORK_TYPED_ERRORS = ("RayActorError", "RayTaskError", "WorkerCrashedError")

_NETWORK_WORKER = """
import sys
sys.path.insert(0, {here!r})
import ray_tpu_torch
w = ray_tpu_torch.init(address={addr!r}, num_cpus=4, num_gpus={gpus},
                       resources={{"replica_pool": 2.0, "net_host": 1.0, "net_host_{i}": 1.0}},
                       system_config={{"worker_processes": 0}})
print("JOINED", flush=True)
w.wait(timeout={wait})
"""


def network_tasks(dev: str):
    """Phase 4n's two tasks for a joined host, made here so that they
    pickle by value (this script is __main__, which the host cannot
    import): (K1 on the host's card over the head's numpy rows -> (y on the
    card, the host's K1 launches during the call, its pid); the
    deployment's handle resolved and called from the host through the
    head's ownership tables, core/worker_api.py -> (the tokens, its pid))."""

    def k1(x_np, w_np, eps: float):
        import os

        import torch

        from ray_tpu_torch.ops import dispatch, norm

        x = torch.from_numpy(x_np).to(dev, torch.bfloat16)
        w = torch.from_numpy(w_np).to(dev, torch.bfloat16)
        before = dispatch.launch_counts()["rms_norm"]
        y = norm.rms_norm(x, w, eps)
        if y.is_cuda:
            torch.cuda.synchronize()
        return y, dispatch.launch_counts()["rms_norm"] - before, os.getpid()

    def back_channel(deployment: str, requests):
        import os

        from ray_tpu_torch import serve

        handle = serve.get_deployment_handle(deployment)
        return ([handle.remote(r).result(timeout=600)["token_ids"] for r in requests],
                os.getpid())

    return k1, back_channel


def network_path(card: str) -> dict:
    """Phase 4n: llama3-8b replicas on joined hosts (the module docstring);
    -> {"launches": the head's launch counts over its burst (none: the
    replicas' kernels run in the joined hosts' processes) and the K1 task's
    launch on a joined host, "walls": the phase's walls}."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import get_config, init_params
    from ray_tpu_torch.ops import dispatch, norm
    from ray_tpu_torch.serve import EngineConfig, InferenceEngine, LLMServer

    t_phase = time.monotonic()
    walls = {}
    cfg = get_config(NETWORK_MODEL)
    requests = observe_requests(cfg)
    rt.shutdown()
    gc.collect()
    if NETWORK_DEVICE is None:
        torch.cuda.synchronize()
    apps0 = compute_apps()
    mem0 = torch.cuda.memory_allocated() if NETWORK_DEVICE is None else 0

    # (2) the head serves RPC and advertises no card; two hosts start joining
    t0 = time.monotonic()
    head = rt.init(num_gpus=0, system_config={
        "control_plane_rpc_port": 0, "health_check_timeout_ms": NETWORK_HEALTH_TIMEOUT_MS,
        "worker_processes": 0, "actor_processes": False})
    addr = head._cp_server.address
    walls["head init"] = time.monotonic() - t0
    t0 = time.monotonic()
    import tempfile

    host_logs = [tempfile.NamedTemporaryFile(prefix=f"phase4n-host{i}-", suffix=".log",
                                             delete=False) for i in range(2)]
    t_join = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NETWORK_WORKER.format(here=HERE, addr=addr, i=i,
                                                      gpus=NETWORK_HOST_GPUS, wait=1800)],
        stdout=host_logs[i], stderr=subprocess.STDOUT) for i in range(2)]
    hosts, joined_at = {}, {}

    def watch_joins():
        while len(hosts) < 2 and time.monotonic() - t_join < 120:
            for n in head.control_plane.alive_nodes():
                for i in range(2):
                    if f"net_host_{i}" in n.resources_total and i not in hosts:
                        hosts[i], joined_at[i] = n.node_id, time.monotonic()
            if any(p.poll() is not None for p in procs):
                return
            time.sleep(0.02)

    watcher = threading.Thread(target=watch_joins, daemon=True, name="phase4n-joins")
    watcher.start()
    try:
        # (1) the reference tokens from a direct engine while the hosts join,
        # then its memory back
        t0 = time.monotonic()
        dev = "cuda" if NETWORK_DEVICE is None else NETWORK_DEVICE
        engine = InferenceEngine(init_params(cfg, seed=0, device=dev, dtype=cfg.dtype), cfg,
                                 EngineConfig(**ENGINE), device=dev)
        engine.warmup()
        # one at a time: a prompt's tokens do not depend on its batch (prefills
        # run one prompt each, every decode span at the full batch)
        want = [engine.generate(r["prompt_ids"], max_tokens=r["max_tokens"])["token_ids"]
                for r in requests]
        engine.stop()
        del engine
        gc.collect()
        if NETWORK_DEVICE is None:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_allocated() if NETWORK_DEVICE is None else 0
        walls["reference engine"] = time.monotonic() - t0
        log(f"phase 4n (1): a direct {NETWORK_MODEL} engine's tokens for {len(requests)} greedy "
            f"prompts in {walls['reference engine']:.1f}s; card memory {mem0 / 2**30:.3f} GiB "
            f"before it, {mem1 / 2**30:.3f} GiB after it was freed ({card})")
        if mem1 - mem0 > 2**30:
            fail(f"phase 4n (1): the freed engine left {(mem1 - mem0) / 2**30:.3f} GiB on the card")

        watcher.join(max(1.0, 120 - (time.monotonic() - t_join)))
        if any(p.poll() is not None for p in procs):
            fail(f"phase 4n (2): a joining host exited ({[p.poll() for p in procs]})")
        if len(hosts) < 2:
            fail("phase 4n (2): the two hosts did not join within 120 s")
        walls["join"] = max(joined_at.values()) - t_join
        pid_of = {hosts[i]: procs[i].pid for i in range(2)}
        log(f"phase 4n (2): init() serving RPC at {addr} in {walls['head init']:.2f}s; two "
            f"hosts (pids {[p.pid for p in procs]}) joined {walls['join']:.1f}s after they "
            f"started (beside (1)), each "
            f"advertising GPU {NETWORK_HOST_GPUS} and replica_pool 2; the head advertises "
            f"{head.control_plane.get_node(head.driver_agent.node_id).resources_total}")

        # (3) two replicas placed on the joined hosts by resource demand
        t0 = time.monotonic()
        # spread, as the reference's serve test does: the head sees a joined
        # host's free resources as of its last heartbeat
        handle = serve.run(LLMServer.options(
            num_replicas=2, ray_actor_options={
                "num_gpus": NETWORK_REPLICA_GPUS, "resources": {"replica_pool": 1.0},
                "scheduling_strategy": rt.SpreadSchedulingStrategy()}).bind(
            model_name=NETWORK_MODEL, engine_config=ENGINE, seed=0, device=NETWORK_DEVICE),
            name="net")
        replicas = wait_ready(handle.deployment_name, 2, t0, label="phase 4n (3)")
        walls["replica build"] = max(s for _, s in replicas)
        placed = {}
        for replica, _ in replicas:
            node = head.control_plane.get_actor(replica._actor_id).node_id
            if node not in pid_of:
                fail(f"phase 4n (3): a replica was placed off the joined hosts ({node})")
            placed[pid_of[node]] = replica
        if len(placed) != 2:
            fail("phase 4n (3): both replicas landed on one host")
        log(f"phase 4n (3): two {NETWORK_MODEL} replicas ready at "
            f"{[round(s, 1) for _, s in replicas]} s, one on each joined host "
            f"({sorted(placed)})")
        served0 = {pid: rt.get(r.stats.remote(), timeout=60)["total"] for pid, r in placed.items()}
        dispatch.reset_launches()
        results, latency, wall = handle_burst(handle, requests, label="phase 4n (3)")
        head_launches = dispatch.launch_counts()
        line = report_burst("phase 4n (3) burst across the hop", requests, results, wall)
        walls["burst TPOT p50 (ms)"] = tpot_ms(results)
        served1 = {pid: rt.get(r.stats.remote(), timeout=60)["total"] for pid, r in placed.items()}
        by_host = {pid: served1[pid] - served0[pid] for pid in placed}
        got = [r["token_ids"] for r in results]
        log(f"phase 4n (3): {line}; the call-to-result hop p50 "
            f"{statistics.median(latency):.3f} s; requests per host {by_host}; tokens "
            f"bit-equal to (1): {got == want}")
        if got != want:
            fail("phase 4n (3): the tokens through the joined hosts differ from the direct "
                 "engine's")
        if min(by_host.values()) < 1:
            fail(f"phase 4n (3): a replica served no request ({by_host})")

        # (4) SIGKILL one host in the middle of a second burst
        victim_i = 0
        victim = procs[victim_i]
        apps_before = compute_apps()
        outcomes = [None] * len(requests)

        def wait_one(i, response):
            try:
                outcomes[i] = ("ok", response.result(timeout=600)["token_ids"])
            except Exception as e:  # noqa: BLE001 — its type is the gate
                outcomes[i] = ("error", type(e).__name__, repr(e)[:200])

        threads = [threading.Thread(target=wait_one, args=(i, handle.remote(r)), daemon=True)
                   for i, r in enumerate(requests)]
        for t in threads:
            t.start()
        kill_after = NETWORK_KILL_AT * wall
        time.sleep(kill_after)
        os.kill(victim.pid, signal.SIGKILL)
        t_kill = time.monotonic()
        victim.wait(timeout=30)
        reap_s = None
        while time.monotonic() - t_kill < 60:
            if hosts[victim_i] not in [n.node_id for n in head.control_plane.alive_nodes()]:
                reap_s = time.monotonic() - t_kill
                break
            time.sleep(0.02)
        for t in threads:
            t.join(max(1.0, 660 - (time.monotonic() - t_kill)))
        hung = [i for i, t in enumerate(threads) if t.is_alive() or outcomes[i] is None]
        walls["time to reap"] = reap_s if reap_s is not None else float("nan")
        gone = None
        while time.monotonic() - t_kill < 90:
            apps = compute_apps()
            if victim.pid not in apps and len(apps) <= len(apps_before) - 1:
                gone = time.monotonic() - t_kill
                break
            time.sleep(0.2)
        answered = [(i, o[1]) for i, o in enumerate(outcomes) if o and o[0] == "ok"]
        failed = [(i, o[1], o[2]) for i, o in enumerate(outcomes) if o and o[0] == "error"]
        log(f"phase 4n (4): SIGKILL of host pid {victim.pid} {kill_after:.2f} s into a "
            f"burst of {len(requests)}: reaped after "
            f"{'not reaped' if reap_s is None else f'{reap_s:.2f} s'} (health timeout "
            f"{NETWORK_HEALTH_TIMEOUT_MS / 1e3:.1f} s); {len(answered)} answered, "
            f"{len(failed)} failed ({sorted({f[1] for f in failed})}), {len(hung)} hung; "
            f"compute apps {len(apps_before)} -> "
            f"{'unchanged' if gone is None else f'{len(apps_before) - 1} after {gone:.1f} s'}")
        if reap_s is None or reap_s > NETWORK_HEALTH_TIMEOUT_MS / 1e3 + 2.0:
            fail(f"phase 4n (4): the killed host was not reaped within the health timeout "
                 f"({reap_s})")
        if hung:
            fail(f"phase 4n (4): requests {hung} neither answered nor failed")
        if any(f[1] not in NETWORK_TYPED_ERRORS for f in failed):
            fail(f"phase 4n (4): untyped failures {failed}")
        if any(toks != want[i] for i, toks in answered):
            fail("phase 4n (4): an answered request's tokens differ from the direct engine's")
        if not answered:
            fail("phase 4n (4): the surviving replica answered nothing")
        if gone is None:
            fail(f"phase 4n (4): the killed host pid {victim.pid} still holds the card "
                 f"({compute_apps()})")

        # the controller replaces the killed host's replica on the survivor;
        # (5) waits for it to be built: a graph capture in that process
        # refuses other CUDA work beside it (ROADMAP C17)
        from ray_tpu_torch.core.control_plane import ActorState
        from ray_tpu_torch.serve.controller import get_or_create_controller

        survivor = procs[1 - victim_i].pid
        t0 = time.monotonic()
        while time.monotonic() - t0 < FLEET_WAIT_S:
            listed, _ = rt.get(get_or_create_controller().get_replicas.remote(
                handle.deployment_name), timeout=60)
            infos = [head.control_plane.get_actor(r._actor_id) for r in listed]
            if len(listed) == 2 and all(
                    i is not None and i.state is not ActorState.DEAD
                    and i.node_id == hosts[1 - victim_i] for i in infos):
                break
            time.sleep(0.2)
        else:
            fail(f"phase 4n (4): the killed host's replica was not replaced on the survivor "
                 f"within {FLEET_WAIT_S} s")
        wait_ready(handle.deployment_name, 2, t0, label="phase 4n (4)")
        walls["replacement ready"] = time.monotonic() - t0
        log(f"phase 4n (4): the controller's replacement replica ready on the survivor (pid "
            f"{survivor}) {walls['replacement ready']:.1f}s after the reap")

        # (5) the dispatch plane and the back-channel on the surviving host
        rng = np.random.default_rng(5)
        x_np = rng.standard_normal((8, cfg.d_model), dtype=np.float32)
        w_np = (1.0 + 0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)
        k1, back_channel = network_tasks(dev)
        t0 = time.monotonic()
        y, k1_launches, k1_pid = rt.get(rt.remote(**NETWORK_TASK)(k1).remote(
            x_np, w_np, cfg.norm_eps), timeout=300)
        walls["K1 round trip"] = time.monotonic() - t0
        plain = norm.rms_norm(torch.from_numpy(x_np).to(torch.bfloat16),
                              torch.from_numpy(w_np).to(torch.bfloat16), cfg.norm_eps)
        atol, rtol = TOL[("rms_norm", torch.bfloat16)]
        err = (y.float() - plain.float()).abs().max().item()
        ok = torch.allclose(y.float(), plain.float(), atol=atol, rtol=rtol)
        log(f"phase 4n (5): K1 on host pid {k1_pid} (the survivor {survivor}) in "
            f"{walls['K1 round trip']:.3f}s round trip: {k1_launches} launch there, the "
            f"result back on the head's {y.device} as {y.dtype}, max |kernel - plain| {err:.3e} "
            f"(tolerance {atol} + {rtol} x |plain|)")
        if k1_pid != survivor:
            fail(f"phase 4n (5): the K1 task ran on pid {k1_pid}, not the surviving host")
        if NETWORK_DEVICE is None and k1_launches != 1:
            fail(f"phase 4n (5): the K1 task launched K1 {k1_launches} times, not once")
        if y.device.type != "cpu":
            fail(f"phase 4n (5): a tensor from the card crossed the hop onto {y.device}")
        if not ok:
            fail(f"phase 4n (5): K1 on the joined host disagrees with the plain rms_norm "
                 f"({err:.3e})")
        launches = dict(head_launches, rms_norm=head_launches["rms_norm"] + k1_launches)
        t0 = time.monotonic()
        toks, bc_pid = rt.get(rt.remote(**NETWORK_TASK)(back_channel).remote(
            handle.deployment_name, requests[:2]), timeout=900)
        walls["back-channel call"] = time.monotonic() - t0
        log(f"phase 4n (5): a task on host pid {bc_pid} called the deployment's handle through "
            f"the back-channel in {walls['back-channel call']:.2f}s: tokens bit-equal to (1): "
            f"{toks == want[:2]}")
        if bc_pid != survivor or toks != want[:2]:
            fail(f"phase 4n (5): the back-channel call (pid {bc_pid}) gave {toks}")
    except SystemExit:
        for f in host_logs:  # what the hosts said, for the failure's reader
            with open(f.name, errors="replace") as fh:
                log(f"phase 4n: {f.name} ends:\n" + "".join(fh.readlines()[-40:]))
        raise
    finally:
        # (6) clean-up: serve and the runtime end, the hosts exit, the card
        # holds no app of the phase
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
        t_end = time.monotonic()
        left = []
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                left.append(p.pid)
                p.kill()
                p.wait(timeout=30)
    apps = compute_apps()
    while len(apps) > len(apps0) and time.monotonic() - t_end < 30:
        time.sleep(0.2)
        apps = compute_apps()
    log(f"phase 4n (6): serve.shutdown() and shutdown(): the hosts exited "
        f"{'cleanly' if not left else f'only when killed ({left})'}; compute apps "
        f"{len(apps0)} before the phase, {len(apps)} after")
    if left or len(apps) > len(apps0):
        fail(f"phase 4n (6): a host or a compute app outlived the phase ({left}, {apps})")
    walls["phase"] = time.monotonic() - t_phase
    log("phase 4n walls: " + "; ".join(
        f"{k} {v:.2f}" + ("" if k.endswith("(ms)") else " s") for k, v in walls.items()))
    return {"launches": launches, "walls": walls}


def network_only(card: str) -> None:
    """`--network`: phase 4n alone (no result line)."""
    network_path(card)


def observe_only(card: str) -> None:
    """`--observe`: phase 4o alone (no result line)."""
    observe_path(card)


PHASE_WALLS: list = []  # (label, seconds) of each phase of the default run
T_START = time.monotonic()


def timed(label: str, fn, *args):
    """fn(*args), its wall appended to PHASE_WALLS under `label`."""
    t0 = time.monotonic()
    out = fn(*args)
    PHASE_WALLS.append((label, time.monotonic() - t0))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each path, serve a burst again / take one more "
                         "training step under torch.profiler")
    ap.add_argument("--ab", metavar="CSRC",
                    help="only build and check the kernels, then time K4-K7 with this "
                         "checkout's kernels and with those built from CSRC (a changed copy "
                         "of ray_tpu_torch/csrc), in turns; prints no result line")
    ap.add_argument("--moe-dynamics", action="store_true",
                    help="only build the kernels, then train moe-1b as phase 6 does under "
                         "variants of its recipe and path, printing every step's metrics; "
                         "prints no result line")
    ap.add_argument("--readback-ab", action="store_true",
                    help="only build the kernels, then serve phase 3's burst with the engine's "
                         "readbacks into pinned and into pageable memory, in turns; prints no "
                         "result line")
    ap.add_argument("--runtime", action="store_true",
                    help="only build the kernels, serve phase 3's burst, then run phase 3r "
                         "(the task/actor runtime on its tensors); prints no result line")
    ap.add_argument("--deploy", action="store_true",
                    help="only build the kernels, serve phase 3's burst, then run phase 3d "
                         "(the serve runtime on its tensors); prints no result line")
    ap.add_argument("--disagg", action="store_true",
                    help="only build the kernels, serve phase 3's burst, then run phase 3g "
                         "(disaggregated prefill/decode serving on its tensors); prints no "
                         "result line")
    ap.add_argument("--fleet", action="store_true",
                    help="only build the kernels, serve phase 3's burst, then run phase 3f "
                         "(the health plane and the serve fleet on its tensors); prints no "
                         "result line")
    ap.add_argument("--build-profile", action="store_true",
                    help="with --fleet: sample every thread's stack while phase 3f's replicas "
                         "build, and print where the threads were busy")
    ap.add_argument("--pretrain", action="store_true",
                    help="only build the kernels, then run phase 4p (pretrain -> checkpoint "
                         "-> serve at llama-2b); prints no result line")
    ap.add_argument("--tune", action="store_true",
                    help="only build the kernels, then run phase 4t (a Tuner of llama-2b "
                         "trials sharing the card, reading from one ingest service); prints "
                         "no result line")
    ap.add_argument("--procs", action="store_true",
                    help="only build the kernels, then run phase 4i (llama-2b pretraining fed "
                         "by worker processes, the runtime at its defaults); prints no result "
                         "line")
    ap.add_argument("--rl", action="store_true",
                    help="only build the kernels, then run phase 4r (GRPO and the online RL "
                         "loop at llama-600m, PPO with the learner on the card); prints no "
                         "result line")
    ap.add_argument("--network", action="store_true",
                    help="only build the kernels, then run phase 4n (llama3-8b replicas on two "
                         "joined hosts: served, one host killed mid-burst, K1 and the "
                         "back-channel on the survivor); prints no result line")
    ap.add_argument("--observe", action="store_true",
                    help="only build the kernels, then run phase 4o (observability and tooling "
                         "around a named llama3-8b server: device trace, sampling profile, "
                         "stack dump, device memory, health payload, snapshot and resume, a "
                         "job, microbenchmarks, the sanitizer and a postmortem); prints no "
                         "result line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import dispatch  # fails where the package is absent

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    t0 = time.monotonic()
    dispatch.library()
    PHASE_WALLS.append(("1 kernels built", time.monotonic() - t0))
    log(f"phase 1: kernels built in {time.monotonic() - t0:.1f}s "
        f"(nvcc {dispatch.BUILD_INFO.get('seconds', 0.0):.1f}s)")
    with open(dispatch.BUILD_INFO["log"]) as f:
        build_log = f.read()
    for line in build_log.splitlines():
        if line.startswith("==") or "warning" in line.lower():
            log("  " + line.rstrip())
    for name, res in ptxas_report(build_log).items():
        log(f"  {name}: {res.get('registers', '?')} registers, spill stores "
            f"{res.get('spill_stores', '?')} B, spill loads {res.get('spill_loads', '?')} B")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cublas_workspace_sizes()  # probed before any other GEMM on a side stream
    if args.ab:
        ab_compare(args.ab, card)
        return
    if args.moe_dynamics:
        moe_dynamics(card)
        return
    if args.readback_ab:
        readback_ab(card)
        return
    if args.runtime:
        runtime_only(card)
        return
    if args.deploy:
        deploy_only(card)
        return
    if args.disagg:
        disagg_only(card)
        return
    if args.fleet:
        global BUILD_SAMPLER
        if args.build_profile:
            BUILD_SAMPLER = ThreadSampler()
        fleet_only(card)
        return
    if args.pretrain:
        pretrain_path(card)
        return
    if args.tune:
        tune_path(card)
        return
    if args.rl:
        rl_path(card)
        return
    if args.procs:
        procs_path(card)
        return
    if args.observe:
        observe_only(card)
        return
    if args.network:
        network_only(card)
        return
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tile_identity_checks(gen)
    figures = norm_checks(gen)
    figures.update(kernel_checks(gen))
    figures.update(training_kernel_checks(gen))
    PHASE_WALLS.append(("2 kernels against their plain versions", time.monotonic() - t0))
    served = timed("3 serving llama3-8b, with 3m 3w 3r 3d 3g 3f", serve_main_path, card,
                   args.profile)
    gc.collect()  # the server is shut down: free its pool, keep its weights
    torch.cuda.empty_cache()
    spec = timed("3s speculation", spec_main_path, card, args.profile, served)
    serve_launches, migrate_launches, live_launches, runtime_launches, deploy_launches = (
        served["launches"], served["migrate"], served["live"], served["runtime"],
        served["deploy"])
    disagg_launches, fleet_launches = served["disagg"], served["fleet"]
    del served
    gc.collect()  # free the weights
    torch.cuda.empty_cache()
    trained = timed("4 training llama-2b", train_main_path, card, args.profile)
    train2b = timed("4f train2b", train2b_path, card, trained, args.profile)
    pretrain = timed("4p pretrain, checkpoint, serve", pretrain_path, card)
    procs = timed("4i worker processes", procs_path, card)
    tuned = timed("4t tune", tune_path, card, train2b)
    rl_ran = timed("4r rl", rl_path, card)
    observed = timed("4o observability", observe_path, card)
    networked = timed("4n network", network_path, card)
    moe_served = timed("5 serving moe-1b", moe_serve_path, card, args.profile)
    moe_trained = timed("6 training moe-1b", moe_train_path, card, args.profile)
    kernels = []
    for name in dispatch.KERNELS:
        source, replaces = SOURCES[name]
        by_path = {"serve": serve_launches[name], "spec": spec["launches"][name],
                   "train": trained["launches"][name], "train2b": train2b["launches"][name],
                   "moe_serve": moe_served["launches"][name],
                   "moe_train": moe_trained["launches"][name],
                   "migrate": migrate_launches[name],
                   "moe_migrate": moe_served["migrate"][name],
                   "live": live_launches[name] + moe_served["live"][name],
                   "runtime": runtime_launches[name], "deploy": deploy_launches[name],
                   "disagg": disagg_launches[name], "fleet": fleet_launches[name],
                   "pretrain": pretrain["launches"][name], "procs": procs["launches"][name],
                   "tune": tuned["launches"][name],
                   "rl": rl_ran["launches"][name], "observe": observed["launches"][name],
                   "network": networked["launches"][name]}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        **figures[name]})
        if name == "flash_attention":  # the serving shape above; with lse at the training shape
            kernels[-1]["with_lse"] = figures["flash_attention_lse"]
        if name == "rms_norm":  # decode rows above; the training block here
            kernels[-1]["training_shape"] = figures["rms_norm_training"]
    log("phase walls, s (this run):")
    for label, seconds in PHASE_WALLS:
        log(f"  {label:<48} {seconds:9.1f}")
    log(f"  {'total since start':<48} {time.monotonic() - T_START:9.1f}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
