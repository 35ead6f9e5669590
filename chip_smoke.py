"""Smoke test of the PyTorch port on one NVIDIA H100: build the hand-written
kernels, hold each against its plain PyTorch version, drive Perceiver AR
generation, the serving engine (with its request journal and crash
recovery, and bf16 or int8 weights), the serving router over two engine
replicas (failover, breakers, shedding, recovery), in process and in worker
processes (a killed, a hung and a device-faulted worker), the router's fleet
operations (migration, rolling restart, deploy and rollback, autoscaling)
and training at the 455M
flagship's full width (under every remat policy and offloading too), train
the 30M recipe through the fit loop, run Perceiver AR's text and symbolic
audio faces (the 30.7M CLM recipe on the python-source corpus and the
GiantMIDI recipe, each through its pipeline), train
clm_8k sequence-parallel (ring attention over a {"seq": 4} mesh of the one
card), run Perceiver IO optical-flow inference (the 41M model on a
Sintel-sized frame pair) and training (the 41M model on two Sintel-sized
patches, and the convergence probe through the fit loop), run the Perceiver
IO image classifier (the 48.4M ImageNet model's inference in bf16 and float32, its
training with and without a frozen encoder, and the digits convergence
run), and check the card against the port's CPU run and the ring against
the plain path.

    python3 chip_smoke.py
    python3 chip_smoke.py --journal-child <dir>   # the serving_recovery phase's child, alone
    python3 chip_smoke.py --router-child <dir>/r{i}   # the serving_router phase's recovery child, alone
    python3 chip_smoke.py --train-child <dir>   # the train_resilient phase's child, alone

Phases (each prints JSON lines; any failure raises and the exit code is not 0):
  1. device         CUDA with compute capability (9, 0); the card's name and power limit
  2. build          one nvcc per perceiver_io_torch/csrc/*.cu, all started together:
                    seconds and ptxas lines per source; B1a and B1b wide's
                    and B1a float32's registers and spills by instantiation
                    (a spill fails the run) and the count of ptxas notes
                    that each source's wgmma were serialised
  3. kernel_check   each kernel vs its plain version at the main paths'
                    shapes: f32 max error 1e-4; bf16 and quantized pools 0.03 x
                    the RMS of the plain output; times, the least time the
                    card could take (bytes or operations) and a library call
                    as a yardstick. B2, B3 and B4 (split-K) also print each
                    call's split count and blocks (launched, and working:
                    the rest return at once) and must give the same bits
                    twice. B2 (decode attention) at the flagship's
                    and the 30M recipe's shapes; B3 (paged decode) in f32,
                    bf16 and int8 pools and B4 (ragged paged) in int4, bf16
                    and int8 pools, at the flagship cross-attention shape (8
                    slots, page 128, 65-page pool), the 30M decode shape and a
                    page size that does not divide the window, with wrapping
                    ring offsets, dead pages, latent-finish causal bounds and
                    live = 0 lanes (which must be exact zeros); B1a/B1b (flash
                    attention forward and backward, against the plain
                    version's autograd gradients; bf16 also gets one bf16
                    step of the element, see flash_limit; in bf16 the
                    forward runs csrc/flash_forward_mma.cu and B1b
                    csrc/flash_backward_mma.cu on the tensor cores, with P
                    in two bf16 terms where B1b reads the forward's output
                    and in one without gradients (held and timed too); in
                    float32 B1a runs csrc/flash_forward_f32.cu and B1b
                    csrc/flash_backward_f32.cu, each product as three TF32
                    products on the tensor cores) at the
                    flagship cross- and self-attention and the 30M
                    cross-attention (left-padded) shapes, pad keys' gradients
                    exact zeros, two backward runs bit-identical (in float32
                    the forward too), and at the flagship cross-attention
                    the float32 output's error against the float64 plain
                    version within F32_CLASS_FACTOR (4) x the plain float32
                    version's; B5
                    (ring_block_forward, ring attention's fully visible
                    blocks: B1a's entry, in bf16 with P in two terms) at
                    clm_8k's cross- and
                    self-attention blocks at {"seq": 4}, the flagship's
                    cross-attention block at {"seq": 2} and a block with
                    256-channel heads (csrc/flash_forward_wide.cu), the float32 output
                    and log-sum-exp within 1e-4 in both input types, an
                    all-padding row exact zeros and -inf; then
                    decode_host: B2, B3 and B4 at their head cases, the
                    host's microseconds a wrapper call takes beside the
                    card's ms a call, with and without the host's enqueue
                    time (decode_host_times); then B1a at the optical-flow
                    model's shapes, full mask (check_flow_flash_kernel): the
                    decoder's one 512-channel head, 182,528 pixel queries
                    over 2,048 latents (csrc/flash_forward_wide.cu in bf16,
                    which writes a bf16 output here), checked at 1 patch
                    and at 6 (patch by patch), each twice for the same
                    bits, and timed at 6 and at 1 (in float32, one patch a
                    call is the default-dtype pipeline's; there also the
                    float32-class check against float64), and the 24
                    self-attention layers' 8 x 64 over 2,048 x 2,048 at 6
                    patches; bf16 within 0.03 x the plain output's RMS plus
                    one bf16 step, f32 within 1e-4; the library call's
                    CUDA kernels named (its backend at D = 512); then the
                    wide bf16 forward beyond inference
                    (check_wide_forward_kernel): the flow train step's call
                    (2 patches, P in two terms, the float32 output and lse
                    within 1e-4 patch by patch) and D = 192 and 256 at a
                    left-padded causal shape with an odd query-tile count
                    (a spare block in the last cluster), one-term P within
                    flash_limit and two-term P within 1e-4, every launch
                    twice for the same bits; then B1b
                    at heads of 192-512 (check_wide_backward_kernel): the
                    flow decoder's 512-channel head, full mask, in bf16
                    (csrc/flash_backward_wide.cu) checked at 1 patch and
                    at the train step's 2 (patch by patch), timed at 2 with
                    each pass's device ms (delta, dK/dV, reduce, dQ), D =
                    192 and 256 in bf16 and f32 at a left-padded causal
                    shape (in f32 the forward too: o and lse within 1e-4,
                    two runs the same bits, timed), and D = 320 in bf16 at one whose query and key
                    tiles both leave a spare block in their last cluster;
                    dq, dk and dv against the plain backward within
                    flash_limit, pad keys' dk and dv exact zeros, two runs
                    the same bits;
                    the library call F.scaled_dot_product_attention forward
                    and backward timed with its kernels named, or its error;
                    every float32 forward's bound at 165 TFLOP/s (three
                    TF32 products) has its bound at the CUDA cores' 67
                    beside it; then B1b in float32 (check_f32_backward_kernel,
                    csrc/flash_backward_f32.cu) at every float32 backward
                    shape of the main paths (the flagship cross- and
                    self-attention, the 30M cross-attention, D 192 and 256
                    padded causal, the flow decoder's patch and the flow
                    self-attention): dq, dk and dv within 1e-4 of the plain
                    backward, pad keys' exact zeros, two runs the same bits,
                    at the flagship cross-attention and the flow decoder's
                    patch the gradients' error from float64 within
                    F32_CLASS_FACTOR x the plain float32 version's; the
                    kernel, the plain backward and the library's backward
                    timed (its kernels named), the bound at both float32
                    rates, ms by pass at those two shapes; then B1a at the
                    image classifier's latent self-attention
                    (check_classifier_flash_kernel: 32 x 8 x 512 x 512 x
                    128, full mask, no gradients) in bf16 and float32:
                    within flash_limit (float32 also float32-class), two
                    runs the same bits, timed with the bound and the
                    library call
  4. main_path      flagship generation in bf16 at batch 8 through generate():
                    greedy, rolling window, chunked, left-padded, each
                    MAIN_PATH_REPEATS times; prefill and the decode loop are timed apart inside
                    each call; the B2 counter must equal (1 + layers) x decode
                    iterations
  5. serving        the flagship engine in bf16, 8 slots, a seeded stream of 32
                    requests (prompts 64-1024, 16-128 new tokens, half
                    sampled) in four pool modes (dense, paged fp, int8, int4),
                    and paged_chunked_prefix: page 128, chunks of 256, the
                    prefix cache, 2 prompts in flight, over chat_stream (32
                    requests on four shared 256-token system prefixes,
                    768-896 tokens in all), SERVING_REPEATS runs each: decode
                    tokens/s, ms per tick, TTFT and peak pages, ticks, graph
                    replays and captures, and for the chunked mode prefix
                    hits, shared pages in use and chunks (both > 0); each
                    tick's decode is one CUDA graph, captured once per
                    engine, whose every replay launches B2 once per layer
                    plus one cross-attention kernel (B2, B3 or B4); greedy
                    tokens identical across repeats and to an eager engine
                    (cuda_graph=False) over the stream's first 8 requests,
                    whose first decoding tick's logits lie within 0.03 x
                    their RMS
     serving_lifecycle  the same model and stream in dense, paged_fp and
                    paged_int4, paged pools cut to 41 pages (five full
                    windows): requests 0-23 at class 0 at once, 24-31 at
                    class 1 one every 4 ticks from tick 8; preemptions > 0,
                    a replay each, every request finished with its tokens
                    (greedy and sampled) identical to the uncontended run
                    (all at class 0, the default pool), pages back to 0, one
                    capture, a replay a decode tick, exact B2-B4 launches,
                    ms a tick, TTFT and queue wait by class; then in
                    paged_fp a deadline run (0.5 s on requests 4-7, a 1.0 s
                    stall at tick 10: TIMED_OUT with a prefix of their
                    tokens), a quarantine run (NaN on a sampled request's
                    slot at tick 12: FAILED with a prefix, the pool finite)
                    and a drain run (drain() after tick 12: the
                    never-admitted backlog and later submits rejected, the
                    rest identical); first, whether a chunk projection's
                    rows depend on its lane count, and the ms of one lane,
                    of the engine's fixed eight and of eight one-lane calls
     serving_journal  the same model and stream in dense, paged_fp and
                    paged_int4 with the write-ahead journal (fsync "accept")
                    and the metrics' JSONL stream, against the journal off:
                    identical tokens; the stream read back with
                    load_metrics_jsonl, its submits equal to its terminal
                    events and to finished + rejected + timed out + failed,
                    its last snapshot equal to metrics.snapshot() in every
                    counter; ms a tick and TTFT with and without, the
                    journal's records, segments, bytes and fsyncs
     serving_recovery  a child process (python3 chip_smoke.py
                    --journal-child <dir>, which reuses the built kernels)
                    serves the stream in paged_fp with the journal, printing
                    its parameters' checksum and a line a tick; SIGKILL after
                    tick 40 with greedy and sampled requests in flight; this
                    process, on the same seeded weights (checksum), runs
                    ServingEngine.recover on the card and drains: every
                    request's tokens equal the uninterrupted run's, one
                    capture, exact launches; sessions, in flight, replayed
                    tokens, truncation, the recovery event, recover ms and
                    ticks to drain
     serving_router  the same model and stream through ServingRouter, two
                    in-process replicas of 8 slots sharing the model, in
                    dense, paged_fp and paged_int4, against a single 8-slot
                    engine timed the same way (ms a tick and tokens/s on the
                    host clock, TTFT p50/p95): every request's tokens equal
                    the single engine's, one capture a replica, exact
                    B2-B4 launches; replica 1 crashed at router tick 40:
                    the same tokens (greedy and sampled), the failovers and
                    their replayed tokens, the breaker open at 40, half-open
                    and closed at 44, ticks to drain against the fault-free
                    run; in paged_fp also an infeasible deadline shed and a
                    feasible one finished, serving.nan on replica 1 at ticks
                    40 and 41 (nan_failures_to_open 2: the poisoned requests
                    FAILED with a prefix of their tokens, the breaker open
                    at 41), replica.stall of replica 0, 3 s at ticks 40 and
                    41 against a 2 s threshold (open at 41), and a child (python3
                    chip_smoke.py --router-child <dir>/r{i}) serving through
                    a journaled router, SIGKILLed after tick 40, whose
                    journals this process recovers with
                    ServingRouter.recover and drains: every request's
                    tokens equal the single engine's
     serving_router_process  the same model and stream in paged_fp through
                    ServingRouter(replica_mode="process"): two replicas of
                    8 slots, each in a worker process that builds the model
                    from its recipe and captures its own decode graph. (a)
                    fault-free after a warm-up: tokens equal the single
                    engine's; ms a tick, tokens/s and TTFT against the
                    single engine's and the in-process router's; RPCs and
                    bytes a tick, RPC p50/p95 ms, each worker's peak memory,
                    the fleet's construction s, one capture a worker; (b)
                    SIGKILL of worker 1 at tick 40 on a journaled fleet
                    (transport.worker.kill): one respawn through its journal,
                    no failover, no breaker transition, the same tokens; (c)
                    SIGSTOP of worker 0 at tick 40 (transport.worker.hang):
                    two 5 s timeouts, the worker killed and reaped, a
                    breaker strike, failover by replay, the same tokens; (d)
                    a device-side assert in worker 1 at tick 40
                    (transport.worker.device_fault, armed for that tick):
                    the CUDA error comes back, failover, worker 1 exits and
                    is respawned through its journal at tick 44 while worker
                    0 serves on, the same tokens, every process still
                    launches kernels; (e) a rolling restart of (b)'s fleet
                    after tick 40 over the stream's first 16 requests: each
                    worker replaced by a fresh one through its journal, the
                    rebuild tick's s and each new worker's startup by part,
                    no failover, no breaker transition, the same tokens.
                    The runs go (a), (c), (d), (b), (e): (a)'s fleet starts
                    while serving_router runs, (d)'s while (c) runs, (b)'s
                    while (d) runs; each fleet's spare worker takes its
                    probe, respawns and recycles; each worker warms its
                    admission paths in its init (worker.warm_up), and (a)
                    prints the warm-up's slowest RPCs by op.
                    Each worker's B2/B3 launches equal its
                    replays times a replay's, and count in the kernels line
     serving_router_fleet  the fleet operations, the same model and stream
                    through two in-process replicas of 8 slots: (a) paged_fp,
                    after tick 40 every live session of replica 0 migrated
                    to replica 1 and every other one back: the same tokens,
                    no failover, a migrate event a move; (b) paged_fp,
                    journaled: a rolling restart after tick 40 while half the
                    stream arrives a request a tick: the rebuild ticks' ms,
                    sessions moved and lost (0), the inter-token gaps over
                    the restart against those before it; (c) paged_fp:
                    version 1 (the flagship from seed 1) deployed at
                    fraction 0.5 after tick 40, half the stream after it:
                    each request's tokens are the single engine's of its
                    pinned version (version 0's replica keeps its weights),
                    then rollback, then a full rollout promoted to the
                    primary; the flips by tick and the memory allocated
                    with one and two versions live; (d) paged_int4 from one
                    replica (at most two): a burst scales up, the idle tail
                    down, none lost, B4 launched. Every run: one capture for
                    each engine built, exact B2-B4 launches
     weight_serving  the flagship with float32 parameters and bf16 compute
                    in paged_fp with the prefix cache, weights as stored, in
                    bf16 and in int8: served and float bytes equal to their
                    count from the shapes, memory allocated after
                    construction and at its peak, the decode graph's pool,
                    ms a tick, tokens/s, greedy agreement with the float
                    weights; then set_params to another seed's parameters:
                    one capture still, the prefix cache empty, 8 requests'
                    tokens equal to a fresh engine's on those parameters.
                    Journal directories live under a temporary directory.
     telemetry      (a) the same model, 8 slots, paged_int4, the stream's
                    first 16 requests through a telemetry-on engine (its
                    Chrome trace written to a path) and a telemetry-off
                    one, in turns, twice: greedy tokens identical, one
                    capture each; the trace valid with one async begin and
                    one end a request; serving.tick spans = the run's ticks
                    and sample_sync spans = its harvests; the compile block
                    decode_step 1 against budget 1, nothing unexpected; the
                    run's host syncs (torch.cuda.set_sync_debug_mode "warn")
                    equal on and off; ms a tick on and off and the phase
                    table of a tick; (b) a two-replica in-process router in
                    paged_fp with telemetry on over the same 16 requests:
                    both replicas' span namespaces, a merged compile report
                    of 2 entries, nothing unexpected; (c) after train, the
                    flagship from its seeded weights through Trainer.fit for
                    12 steps (log_every 4) with telemetry and profile_dir
                    (profile_start_step 3, 3 steps) and again with both
                    off: the losses the same bits, train.step_dispatch 12
                    and train.log_sync 3 spans, the torch.profiler trace
                    names B1's kernels (flash_fwd_mma_kernel,
                    flash_bwd_*), nothing unexpected; the step's phase
                    table and the trace's top kernels by device time
  6. train_resilient  the flagship (one model, built once for this and
                    train) through run_fit / Trainer.fit with prefetch_depth
                    2 and lineage saves every 4 steps through the async
                    writer: 12 steps twice (the same bits, L); a child
                    (--train-child, started beside them) SIGKILLed while
                    its step-8 write is in flight, ``last`` torn and
                    ``last.prev`` valid on disk, run_fit(resume=True) from
                    ``last.prev`` equal to L[4:12], its final save
                    corrupted and fallen back past; a SIGTERM after step 6
                    (preempted, the final save at 6, handler restored, no
                    thread left) resumed equal to L[6:12]; a slow loader
                    at prefetch depth 2 and 0; bytes a generation,
                    the submit's ms, write, checksum, verify and restore
                    seconds, ms a step with a write in flight, pinned bytes,
                    peak memory, free disk; exact B1 counts
     train          the flagship train step (20 layers, bf16 over f32
                    parameters, batch 16, AdamW with clipping, activation
                    checkpointing with the dots policy): REPEATS windows of
                    TRAIN_STEPS steps, ms/step, latent tokens/s, MFU, peak
                    memory; B1b = 21 x steps, B1a = 21 x steps + 20 x steps
                    (the checkpointed layers' recomputes); the loss must fall
     train_30m      the 30M recipe through run_fit / Trainer.fit on the
                    Markov data (gather prefix dropout 0.5): 10 steps and one
                    eval, whose loss must be finite; exact B1 counts
     perceiver_ar_faces  (a) remat: the flagship from its seeded weights at
                    batch 16 under no checkpointing, None, the six JAX
                    policy names and offloading (with None and with
                    dots_with_no_batch_dims_saveable): a warm-up and 2
                    timed forward+backward steps each, ms a step, peak
                    memory, B1a/B1b a step, offloading's pinned bytes and
                    bytes each way; the first loss the same bits everywhere,
                    gradients 1e-3 x RMS, aliases = targets, offloading's
                    peak below the dots policy's by half its bytes; (b)
                    text_clm: CausalLanguageModel at the 30.7M recipe with
                    offloading, 10 run_fit steps and one eval on the
                    recipe's TextDataModule over the python-source corpus,
                    then TextGenerationPipeline's engine (8 prompts, equal
                    to generate() on the canonical padding) and its direct
                    path; (c) symbolic_audio: SymbolicAudioModel at the
                    GiantMIDI recipe from a seeded .mid through
                    SymbolicAudioPipeline (equal to generate(), the written
                    file re-read), then a batch-8 step of
                    SymbolicAudioDataModule under the dots policy and
                    offloading (losses the same bits, offloading's peak
                    lower); B1a, B1b and B2 launched; the phase's seconds
     train_sp       clm_8k (sequence 8192, 1024 latents, 8 layers, gather
                    prefix dropout 0.5, dots checkpointing) at batch 4 with
                    sequence_parallel_axis="seq" under {"seq": 4} on the one
                    card: REPEATS windows of TRAIN_STEPS steps; B5 = (12 +
                    8 x 2 x 6) x steps (see ring_schedule), B1 never; the
                    loss must fall
     sp_lr_check    the same model, batch and state through the ring and
                    through the plain B1 path, SP_CHECK_STEPS steps each at
                    bench.py's learning rate and at SP_LR: losses step by
                    step within 2e-2 relative, and both falling at SP_LR
     optical_flow   OpticalFlowPipeline over official_41m_config() in bf16 on a
                    seeded 436 x 1024 synthetic frame pair (make_flow_pair:
                    6 patches, micro_batch_size=6): REPEATS model forwards
                    (ms, synced) and REPEATS pipeline calls (frame pairs/s),
                    medians and spreads, and the peak memory; B1a exactly 24
                    launches a forward at D = 64 and 1 at D = 512; the flow
                    finite, of shape (436, 1024, 2); then the same model at
                    its default dtype (float32) one patch a call, as the
                    pipeline's default micro-batch: ms a pair and a patch,
                    B1a in float32 only (csrc/flash_forward_f32.cu), 24
                    launches a patch at D = 64 and 1 at D = 512
     train_flow     the same model with activation checkpointing, AdamW at
                    1e-3 with clipping at 1.0, through scripts/convergence.py's
                    flow train step on a micro-batch of 2 seeded 368 x 496
                    patches: 3 warm-up and 5 timed steps (ms a step, patches/s,
                    peak memory); B1a and B1b by head width exact (D 512 once
                    a step each, twice for B1a with the decoder checkpointed,
                    D 64 twice a self-attention layer for B1a and once for
                    B1b); the loss finite and falling; then the
                    same in the model's default dtype (float32) on one
                    patch: B1a and B1b in float32 only, by width and dtype
                    exact
  7. card_vs_cpu    (generation, serving, chunked and train run while
                    train_resilient's child starts, between its (a) and (b))
                    flagship at batch 1 in f32: logits within 1e-3 of the CPU
                    run, greedy tokens identical; then the engine at flagship
                    width with 2 layers in f32 (TF32 off) in paged fp, int8
                    and int4 pools: identical tokens, a tick's logits from
                    the same state within 1e-3, and the first tick's within
                    1e-3 in fp and int8 pools (see card_vs_cpu_serving);
                    the chunked and prefix path (paged_chunked_prefix's
                    options, 4 slots, 8 requests): identical tokens, equal
                    prefix hits and chunks, every tick's logits within 1e-3;
                    then training at flagship width with 2 layers in f32:
                    loss within 1e-5 relative, gradients within 1e-3 x their
                    RMS, 3 AdamW steps' losses within 1e-4 relative; the
                    same for the clm_8k ring with 2 layers (card vs CPU,
                    both under {"seq": 4}), and card vs card: the ring
                    against the same model without the seq axis (B1);
                    then OpticalFlow at full width with 2 self-attention
                    layers on a 64 x 96 image in f32 (TF32 off): the flow
                    within 1e-3 x its RMS of the CPU's, B1a launched at D =
                    64 and D = 512 on the card; and its training at full
                    width with 2 layers and 128 latents on 16 x 16 patches
                    in f32: loss 1e-5 relative, gradients 1e-3 x RMS, 3
                    AdamW steps 1e-4, B1b launched at D = 64 and 512
  8. flow_convergence  scripts/convergence.py's run_optical_flow_epe on the
                    card, FLOW_CONVERGENCE_STEPS steps through Trainer.fit:
                    the pipeline's endpoint error on unseen pairs, the
                    zero-flow baseline and the wall seconds; it must be
                    ``met`` (EPE under half the baseline)
  9. image_classifier  vision_perceiver_fourier_config() (48,440,627
                    parameters, checked) on 32 seeded 224 x 224 x 3 images
                    (through ImageNetPreprocessor where PIL imports, else
                    seeded normalised floats, said so): one set of weights
                    in bf16 and in float32, REPEATS synced forwards each
                    (ms a forward, images/s, peak memory), B1a exactly 48
                    launches a forward at D = 128 in the input's type and
                    nothing else; a profiled forward each (device ms by
                    kind: B1a, products, the softmax, LayerNorm; the
                    masked softmax's own ms); bf16 against float32 top-1;
                    the card's float32 logits at batch 2 within 1e-3 of the
                    port's CPU run, the same top-1
     train_image_classifier  the same model in bf16 at dropout 0.1, batch
                    16: 3 steps of make_classifier_train_step (ms a step,
                    losses finite), then 3 with build_tx(freeze_encoder):
                    every encoder parameter bit-identical after them, the
                    decoder's changed; B1 never launches (attention
                    dropout keeps every call off the gate)
 10. digits_convergence  run_digits("glyphs") at DIGITS_STEPS (500) steps through
                    Trainer.fit: met (best val_acc >= 0.98), wall s, the
                    linear-probe baseline or null with its reason
 11. training_scripts  the training CLIs through their main(argv, device):
                    (a) scripts/text/clm.py at its defaults (the 30.7M
                    recipe, bf16) on the python-source corpus, constant
                    schedule: SCRIPTS_STOP_STEP + 2 steps uninterrupted, a
                    run stopped at SCRIPTS_STOP_STEP and resumed with
                    --resume (its losses the uninterrupted run's bits), an
                    eval and its sample each full run; B1a/B1b at D 64 in
                    bf16 and B2 (the sample) launched, MFU printed; (b)
                    scripts/audio/symbolic.py at its defaults (the 134M
                    GiantMIDI recipe) for 2 steps on seeded .mid files:
                    finite losses, peak memory; (c) run_clm("markov") on the
                    gpu profile for SCRIPTS_MARKOV_STEPS steps: the best
                    validation CE below the corpus's order-1 entropy
                    H(X_t | X_{t-1}), met and the gap printed
Each main path runs with every launch counter set to 0 just before it and
read just after; a kernel of the path that was never launched fails the run.
The last three lines are the card (nvidia-smi), the kernel table and
{"ok": true, "device": ...}. Weights are random, from a seed.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
import tempfile
import statistics
import subprocess
import sys
import threading
import time
import warnings
from unittest import mock

import torch
import torch.nn.functional as F

import numpy as np

import perceiver_io_torch.models.core.perceiver_ar as tpar
import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.flash as fl
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
import perceiver_io_torch.training.checkpoint as ckpt
from perceiver_io_torch.data.audio.midi_processor import ControlChange, Note, decode_notes, encode_notes
from perceiver_io_torch.data.audio.smf import read_smf, write_smf
from perceiver_io_torch.data.audio.symbolic import SymbolicAudioDataModule
from perceiver_io_torch.data.loader import DataLoader
from perceiver_io_torch.data.text.common import Task, TextDataModule
from perceiver_io_torch.data.text.synthetic import MarkovByteSource, SyntheticTextDataModule, python_source_corpus
from perceiver_io_torch.data.text.tokenizer import ByteTokenizer
from perceiver_io_torch.data.vision.imagenet import ImageNetPreprocessor
from perceiver_io_torch.data.vision.synthetic import flow_patches, make_flow_pair
from perceiver_io_torch.generation.generate import GenerationConfig, generate
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig, clm_8k_config, flagship_455m_config
from perceiver_io_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_torch.models.core import offload
from perceiver_io_torch.models.core.modules import REMAT_POLICIES, remat_plan
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_torch.models.vision.image_classifier import ImageClassifier, vision_perceiver_fourier_config
from perceiver_io_torch.models.vision.optical_flow import OpticalFlow, official_41m_config
from perceiver_io_torch.obs import load_chrome_trace, validate_chrome_trace
from perceiver_io_torch.ops import cuda_build
from perceiver_io_torch.ops.position import apply_rope, frequency_position_encoding
from perceiver_io_torch.parallel.mesh import make_mesh, set_mesh
from perceiver_io_torch.pipelines import OpticalFlowPipeline, SymbolicAudioPipeline, TextGenerationPipeline
from perceiver_io_torch.scripts.common import OptimizerFlags, build_tx, run_fit
from perceiver_io_torch.scripts.convergence import make_flow_train_step, run_digits, run_optical_flow_epe
from perceiver_io_torch.reliability import FAULTS, RetryPolicy, armed
from perceiver_io_torch.serving import (BREAKER_CLOSED, RequestStatus, ServingEngine, ServingRouter, load_metrics_jsonl,
                                        read_journal, tree_bytes)
from perceiver_io_torch.serving.quant import jax_leaf
from perceiver_io_torch.training.fit import Trainer, TrainerConfig
from perceiver_io_torch.training.metrics import load_metrics_jsonl as load_train_metrics
from perceiver_io_torch.training.flops import PerceiverARFlops, detect_peak_flops
from perceiver_io_torch.training.losses import cross_entropy
from perceiver_io_torch.training.trainer import (TrainState, build_optimizer, make_causal_lm_eval_step,
                                                 make_causal_lm_train_step, make_classifier_train_step, trainable)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM: float32-class products on the tensor cores, three TF32 products
# each (495 TFLOP/s TF32 / 3); beside it float32 outside the tensor cores
F32_FLOP_PER_S = 495e12 / 3
F32_CUDA_CORE_FLOP_PER_S = 67e12
SEED = 0
DEVICE = "cuda"
REPEATS = 3  # windows of a train phase, forwards of a vision phase; medians and spreads are printed
MAIN_PATH_REPEATS = 2  # generate() calls per main-path run (two, not REPEATS: the card's time limit)
SERVING_REPEATS = 2  # engine runs per pool mode in serving() (two, not REPEATS: the card's time limit)
GRAPH_VS_EAGER_REQUESTS = 8  # serving()'s eager engine takes the stream's first 8 requests: one wave of 8 slots
# Kernel vs plain: float32 within an absolute 1e-4. In bfloat16 both sides sum
# in float32 and round the output to bfloat16 apart, so they may differ by one
# bfloat16 step (up to 2**-7 of a value); the limit is that fraction of the
# output's RMS, which these inputs (unit keys and values, softmax over hundreds
# of slots) put far below 1.
F32_ATOL = 1e-4
BF16_RMS_FRACTION = 0.03
T_START = time.perf_counter()


def emit(**record):
    record["t"] = round(time.perf_counter() - T_START, 3)
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
_FLUSH = None


SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock


TIME_MS_BUDGET = 250.0  # ms of timed calls a reading aims at: slower calls get fewer reps, never under 5


def time_ms(fn, reps=25, warmup=3, spin=False) -> float:
    """Median device time of ``fn`` in ms (CUDA events), with the 50 MB L2
    flushed before each run, as a decode step finds the caches. When the host
    takes longer to enqueue ``fn`` than the flush takes to run, the reading
    holds that difference too; with ``spin``, a spin kernel
    (``torch.cuda._sleep``) between the flush and the start event keeps the
    card busy meanwhile, so the reading is the card's alone. Calls slower
    than TIME_MS_BUDGET / reps take fewer reps (the plain versions and
    library calls at the flow shapes, 20-280 ms each), at least 5."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        fn()
    times = []
    while len(times) < reps:
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if len(times) == 1:
            reps = min(reps, max(5, int(TIME_MS_BUDGET / max(times[0], 1e-3))))
    return statistics.median(times)


# ------------------------------------------------------- phase 3: kernels
def decode_case(b, h, d, r, cap, n_q, dtype, pads, g):
    """Inputs of one decode-attention call as the model makes them: a full
    window, rows left-padded by ``pads``, slot angles from the shifted
    positions, queries pre-scaled."""
    dev = DEVICE
    shift = torch.tensor(pads, dtype=torch.int32, device=dev)[:, None]
    q = (torch.randn(b, h, n_q, d, generator=g, device=dev) * d**-0.5).to(dtype)
    k = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    ang = frequency_position_encoding((torch.arange(cap, device=dev)[None, :] - shift).clamp_min(0), r).contiguous()
    pad = torch.arange(cap, device=dev)[None, :] < shift
    q_pos = cap - 1
    live = (q_pos + 1 - shift[:, 0]).to(torch.int32)
    return q, k, v, ang, q_pos, pad, live


def byte_bound(b, h, d, r, cap, n_q, esize, pads):
    """Least bytes and operations the function needs for these inputs: the
    live slots' key and value rows, their angles and pad flags, the queries
    and the output, each moved once; per live slot and head, the rotation (3
    flops a rotated channel) and 4 * n_q * D flops of scores and value sum."""
    live_slots = sum(cap - p for p in pads)
    nbytes = live_slots * (2 * h * d * esize + r * 4 + 1) + 2 * b * h * n_q * d * esize + 2 * b * 4
    flops = live_slots * h * (3 * r + 4 * n_q * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k, v, ang, q_pos, pad, live):
    """``F.scaled_dot_product_attention`` over pre-rotated keys with the same
    visibility: a yardstick for the kernel, used nowhere in the port."""
    b, h, n_q, d = q.shape
    cap = k.shape[1]
    split = lambda t: t.view(b, cap, h, d).transpose(1, 2)
    kr = apply_rope(split(k).float(), ang).to(q.dtype).contiguous()
    vv = split(v).contiguous()
    slot = torch.arange(cap, device=q.device)
    at = q_pos - (n_q - 1) + torch.arange(n_q, device=q.device)
    lo = q_pos + 1 - live
    mask = (slot[None, None, :] <= at[None, :, None]) & (slot[None, None, :] >= lo[:, None, None]) & ~pad[:, None, :]
    mask = mask[:, None].contiguous()
    return lambda: F.scaled_dot_product_attention(q, kr, vv, attn_mask=mask, scale=1.0)


DECODE_SHAPES = {  # name: (batch, heads, head dim, rotary width, capacity)
    "flagship_cross_attention": (8, 10, 128, 128, 1024),
    "flagship_self_attention": (8, 10, 128, 128, 512),
    "clm_30m_decode": (8, 8, 64, 32, 4096),
    "symbolic_audio_cross_attention": (8, 8, 96, 96, 6144),  # the GiantMIDI recipe's heads of 96 (two 64-lane passes)
}
PADS8 = [0, 0, 3, 17, 100, 250, 0, 1]  # left pads of the 8 rows


def check_decode_kernel():
    g = torch.Generator(DEVICE).manual_seed(SEED)
    results = {}
    for name, (b, h, d, r, cap) in DECODE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for n_q in (1, 8):
                args = decode_case(b, h, d, r, cap, n_q, dtype, PADS8, g)
                got = dk.fused_decode_attention(*args)
                again = dk.fused_decode_attention(*args)
                want = dk.fused_decode_attention_reference(*args).float()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                rms = want.pow(2).mean().sqrt().item()
                atol = F32_ATOL if dtype == torch.float32 else BF16_RMS_FRACTION * rms
                if not err <= atol:
                    raise AssertionError(f"{name} {dtype} n_q={n_q}: kernel vs plain max error {err} > {atol}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {dtype} n_q={n_q}: two runs differ")
                bound, bound_by = byte_bound(b, h, d, r, cap, n_q, torch.finfo(dtype).bits // 8, PADS8)
                splits = dk.decode_splits(b, h, cap, dk.num_sms(args[0].device))  # q_pos is an int, live a tensor
                _, _, _, _, q_pos, pad, live = args
                working = h * sum(len(dk.decode_split_rows(q_pos, lv, cap, pad_row, splits))
                                  for lv, pad_row in zip(live.tolist(), pad.tolist()))
                rec = dict(
                    shape=name, dtype=str(dtype).removeprefix("torch."), n_q=n_q, max_abs_err=err, atol=atol,
                    output_rms=rms, bit_identical=True, splits=splits, blocks_launched=b * h * splits,
                    blocks_working=working,
                    ms=time_ms(lambda: dk.fused_decode_attention(*args)),
                    plain_ms=time_ms(lambda: dk.fused_decode_attention_reference(*args)),
                    library_ms=time_ms(library_call(*args)), bound_ms=bound, bound_by=bound_by,
                )
                emit(phase="kernel_check", kernel="fused_decode_attention", **rec)
                results[(name, rec["dtype"], n_q)] = rec
    return results


# ------------------------------------------------ phase 3: paged kernels
POOL_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}
PAGED_SHAPES = {  # name: (slots, heads, head dim, rotary width, window, page size)
    "flagship_cross_attention": (8, 10, 128, 128, 1024, 128),
    "clm_30m_decode": (8, 8, 64, 32, 4096, 128),
    "flagship_page_100": (8, 10, 128, 128, 1024, 100),  # the page size does not divide the window
}


def paged_case(w, h, d, r, window, ps, pool, q_dtype, g):
    """A pool of w * P + 1 pages (each row its own shuffled pages, page 0 the
    trash page), float32 angles of the ring's logical positions, scaled
    queries; quantized pools are written through ``write_pages``."""
    dev = g.device
    p = -(-window // ps)
    n_pages = w * p + 1
    q = (torch.randn(w, h, 1, d, generator=g, device=dev) * d**-0.5).to(q_dtype)
    kf, vf = (torch.randn(n_pages, ps, h * d, generator=g, device=dev) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=g, device=dev)[: w * p] + 1).reshape(w, p).to(torch.int32)
    ang = frequency_position_encoding(torch.arange(p * ps, device=dev)[None, :].expand(w, -1) % window, r)
    if pool in ("f32", "bf16"):
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        return q, kf.to(dt), vf.to(dt), table, ang, {}, 8
    qbits = 4 if pool == "int4" else 8
    cache = pk.PagedKVCache(*[torch.zeros(n_pages, ps, h * d // (8 // qbits), device=dev,
                                          dtype=torch.uint8 if qbits == 4 else torch.int8) for _ in range(2)],
                            table, torch.zeros(w, dtype=torch.int32, device=dev), window,
                            torch.zeros(n_pages, h, device=dev), torch.zeros(n_pages, h, device=dev), num_heads=h,
                            qbits=qbits)
    cache.write_pages(torch.arange(n_pages, device=dev), kf, vf)
    return q, cache.kp, cache.vp, table, ang, dict(k_scale=cache.k_scale, v_scale=cache.v_scale), qbits


def paged_bound(h, d, r, ps, window, pool, q, start, live):
    """Least time for these inputs: bytes (each live row's key and value codes
    and its angles, each live page's two per-head scales on quantized pools,
    q and out, each read or written once) over 3.35 TB/s, or operations (per
    live row and head: dequantize, 3 flops a rotated channel, a dot and an
    axpy of D) over 67 TFLOP/s float32, whichever is larger."""
    start, live = start.tolist(), live.tolist()
    rows = sum(live)
    pages = 0
    for s0, lv in zip(start, live):
        live_pages = {((s0 - lv + j) % window) // ps for j in range(lv)}
        pages += len(live_pages)
    esize = torch.finfo(q.dtype).bits // 8
    nbytes = rows * (2 * h * d * POOL_BYTES[pool] + 4 * r) + 2 * q.numel() * esize
    if pool in ("int8", "int4"):
        nbytes += pages * 2 * h * 4
    flops = rows * h * (3 * r + 6 * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_library_call(q, kp, vp, table, start, live, ang, window, scales, qbits):
    """``F.scaled_dot_product_attention`` over keys already gathered,
    dequantized and rotated, with the same visibility: a yardstick for the
    kernel that excludes the gather, used nowhere in the port."""
    w, h, _, d = q.shape
    cache = pk.PagedKVCache(kp, vp, table, start, window, scales.get("k_scale"), scales.get("v_scale"),
                            num_heads=h, qbits=qbits)
    k, v = cache.gather_dense()
    n = k.shape[1]
    split = lambda t: t.reshape(w, n, h, d).transpose(1, 2)
    kr = apply_rope(split(k).float(), ang).to(q.dtype).contiguous()
    vv = split(v).to(q.dtype).contiguous()
    mask = pk.paged_visibility(start, live, window, n)[:, None, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(q, kr, vv, attn_mask=mask, scale=1.0)


def paged_rows(window):
    """The 8 rows of a paged kernel check: B3's (start, live), full windows
    at ring offsets that wrap and partial lives that leave dead pages; B4's
    (start, live, causal bound), decode rows, the finish of a 900-token
    prompt over 512 latents (bounds window - 512 + j) and two live = 0
    lanes."""
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=DEVICE)
    n, latents = 900, 512
    return (t([0, 517, window - 1, 333, 129, 64, 1000 % window, 5]),
            t([window, window, 700, 300, 129, 1, window - 24, 512]),
            t([77, window - 3, n, n, n, n, 0, 9]), t([window, 600, n, n, n, n, 0, 0]),
            t([window - 1, window - 1] + [window - latents + j for j in (0, 1, 255, 511)] + [window - 1, window - 1]))


def check_paged_kernels():
    """B3 and B4 against their plain versions; returns the records."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 3)
    records = []
    for name, (w, h, d, r, window, ps) in PAGED_SHAPES.items():
        b3_start, b3_live, b4_start, b4_live, b4_cb = paged_rows(window)
        cases = [("fused_paged_decode_attention", pool, q_dtype) for pool, q_dtype in
                 (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.bfloat16))]
        cases += [("fused_ragged_paged_attention", pool, torch.bfloat16) for pool in ("int4", "bf16", "int8")]
        for kernel, pool, q_dtype in cases:
            q, kp, vp, table, ang, scales, qbits = paged_case(w, h, d, r, window, ps, pool, q_dtype, g)
            if kernel == "fused_paged_decode_attention":
                args = (q, kp, vp, table, b3_start, b3_live, ang, window)
                launch = lambda: pk.fused_paged_decode_attention(*args, **scales)
                plain = lambda: pk.fused_paged_decode_attention_reference(*args, **scales)
                eff_start, eff_live = b3_start, b3_live
            else:
                args = (q, kp, vp, table, b4_start, b4_live, b4_cb, ang, window)
                launch = lambda: rk.fused_ragged_paged_attention(*args, qbits=qbits, **scales)
                plain = lambda: rk.fused_ragged_paged_attention_reference(*args, qbits=qbits, **scales)
                eff_start, eff_live = rk.fold_causal_bound(b4_start, b4_live, b4_cb, window)
            got = launch()
            again = launch()
            want = plain().float()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            rms = want.pow(2).mean().sqrt().item()
            atol = F32_ATOL if pool == "f32" else BF16_RMS_FRACTION * rms
            if not err <= atol:
                raise AssertionError(f"{kernel} {name} {pool}: kernel vs plain max error {err} > {atol}")
            zero_lanes = eff_live == 0
            if zero_lanes.any() and not (got[zero_lanes] == 0).all():
                raise AssertionError(f"{kernel} {name} {pool}: live = 0 lanes are not exact zeros")
            if not torch.equal(got, again):
                raise AssertionError(f"{kernel} {name} {pool}: two runs differ")
            bound, bound_by = paged_bound(h, d, r, ps, window, pool, q, eff_start, eff_live)
            splits = pk.paged_splits(w, h, window, ps, dk.num_sms(q.device))
            working = h * sum(len(pk.paged_split_rows(s0, lv, window, ps, splits))
                              for s0, lv in zip(eff_start.tolist(), eff_live.tolist()))
            rec = dict(kernel=kernel, shape=name, pool=pool, q_dtype=str(q_dtype).removeprefix("torch."),
                       page_size=ps, window=window, max_abs_err=err, atol=atol, output_rms=rms,
                       zero_lanes=int(zero_lanes.sum()), bit_identical=True, splits=splits,
                       blocks_launched=w * h * splits, blocks_working=working,
                       ms=time_ms(launch), plain_ms=time_ms(plain),
                       library_ms=time_ms(paged_library_call(q, kp, vp, table, eff_start, eff_live, ang, window,
                                                             scales, qbits)),
                       bound_ms=bound, bound_by=bound_by)
            emit(phase="kernel_check", **rec)
            records.append(rec)
    return records


def host_us(fn, calls=100, repeats=10) -> float:
    """Host microseconds one call of ``fn`` takes (the wrapper's Python, the
    ctypes call, the launch): ``calls`` calls queued back to back with no
    sync between them, on the host clock; the least of ``repeats``, since
    the host's cores are shared."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(times)


def decode_host_times():
    """B2, B3 and B4 at their head cases (B2 at its three shapes in bf16,
    n_q 1 and 8; B3 over a bf16 pool and B4 over an int4 pool at the flagship
    cross-attention shape): the host's microseconds a wrapper call takes
    (``host_us``) beside the card's ms a call and the library call's, timed
    as kernel_check times them (``ms``, ``library_ms``) and with the host's
    enqueue time kept out (``spin_ms``, ``library_spin_ms``); one JSON line a
    case. It calls only the wrappers' public
    functions, so it times another checkout's package the same way: from that
    checkout's root, load this file by its path
    (``importlib.util.spec_from_file_location``) and call this function."""
    g = torch.Generator(DEVICE).manual_seed(SEED)
    cases = {}
    for name, (b, h, d, r, cap) in DECODE_SHAPES.items():
        for n_q in (1, 8):
            args = decode_case(b, h, d, r, cap, n_q, torch.bfloat16, PADS8, g)
            cases[f"B2 {name} n_q={n_q}"] = (lambda a=args: dk.fused_decode_attention(*a), library_call(*args))
    w, h, d, r, window, ps = PAGED_SHAPES["flagship_cross_attention"]
    b3_start, b3_live, b4_start, b4_live, b4_cb = paged_rows(window)
    for kernel, pool in (("B3", "bf16"), ("B4", "int4")):
        q, kp, vp, table, ang, scales, qbits = paged_case(w, h, d, r, window, ps, pool, torch.bfloat16, g)
        if kernel == "B3":
            a = (q, kp, vp, table, b3_start, b3_live, ang, window)
            run = lambda a=a, s=scales: pk.fused_paged_decode_attention(*a, **s)
            st, lv = b3_start, b3_live
        else:
            a = (q, kp, vp, table, b4_start, b4_live, b4_cb, ang, window)
            run = lambda a=a, s=scales: rk.fused_ragged_paged_attention(*a, qbits=4, **s)
            st, lv = rk.fold_causal_bound(b4_start, b4_live, b4_cb, window)
        cases[f"{kernel} {pool} flagship_cross_attention"] = (
            run, paged_library_call(q, kp, vp, table, st, lv, ang, window, scales, qbits))
    card = card_line()
    for name, (run, library) in cases.items():
        emit(phase="decode_host", case=name, host_us=host_us(run), ms=time_ms(run), spin_ms=time_ms(run, spin=True),
             library_ms=time_ms(library), library_spin_ms=time_ms(library, spin=True), card=card)

# ------------------------------------------------ phase 3: flash kernels
FLASH_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None)
    "flagship_cross_attention": (16, 10, 512, 1024, 128, None),
    "flagship_self_attention": (16, 10, 512, 512, 128, None),
    # the 30M recipe after the gather (3,584 prefix tokens halved, then 512
    # latents), its rows left-padded inside the prefix
    "clm_30m_cross_attention": (8, 8, 512, 2304, 64, [0, 0, 7, 100, 300, 511, 1024, 1790]),
}
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores


def flash_limit(want, dtype):
    """Kernel vs plain: float32 within 1e-4 absolute. bfloat16 within 0.03 x
    the RMS of the plain tensor, as B2-B4 are held, plus one bfloat16 step of
    the element itself (2**-7 of it): the two sides round a float32 result
    to bfloat16 apart, and here the largest elements sit far above the RMS
    (a gradient's at 10-20x; a causal self-attention's first rows average
    one or a few values), so one step there alone can exceed 0.03 x the RMS.
    (The backward's delta = rowsum(dO * O) uses the float32 O, as autograd of
    the plain version does; taken from the bf16-rounded O, as the TPU kernel
    takes it, the flagship self-attention's dq moved by up to 4 bf16 steps.)
    Returns (atol, rtol)."""
    if dtype == torch.float32:
        return F32_ATOL, 0.0
    return BF16_RMS_FRACTION * want.float().pow(2).mean().sqrt().item(), 2.0**-7


def flash_case(b, h, nq, nk, d, pads, dtype, g):
    q = (torch.randn(b, h, nq, d, generator=g, device=DEVICE) * d**-0.5).to(dtype)
    k, v, do = (torch.randn(b, h, n, d, generator=g, device=DEVICE).to(dtype) for n in (nk, nk, nq))
    pad = None if pads is None else torch.arange(nk, device=DEVICE)[None, :] < torch.tensor(pads, device=DEVICE)[:, None]
    return q, k, v, pad, do


def flash_bounds(q, k, pad, esize):
    """Least times (ms, bound_by) of the forward and the backward for these
    inputs: 4 D flops a visible (query, key) pair forward and 10 D backward
    over the dense peak of the input type (bf16 tensor cores, or float32
    outside them), against the bytes each must move once: forward q, k, v
    in and o, lse out; backward q, k, v, o, dO, lse in and dq, dk, dv out."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    visible = fl._visibility(nq, nk, pad, True, q.device).expand(b, 1, nq, nk)
    pairs = int(visible.sum().item()) * h
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    rows_q, rows_k = b * h * nq, b * h * nk
    pad_bytes = 0 if pad is None else b * nk
    out = {}
    for name, flops, nbytes in (
            ("forward", 4 * d * pairs, (2 * rows_q + 2 * rows_k) * d * esize + rows_q * 4 + pad_bytes),
            ("backward", 10 * d * pairs, (4 * rows_q + 4 * rows_k) * d * esize + rows_q * 4 + pad_bytes)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out, pairs


def check_flash_kernel():
    """B1a (forward) and B1b (backward) against the plain version and its
    autograd gradients at the training path's shapes, causal, in float32 and
    bfloat16; pad keys' dK and dV must be exact zeros, and two backward runs
    on the same inputs the same bits (no atomics; in float32 the forward
    too), and at the flagship cross-attention the float32 output
    float32-class (f32_class_check). Times per call: the
    forward, the backward alone (from a saved forward) and both, for the
    kernel, the plain version and F.scaled_dot_product_attention with the
    same boolean mask (a yardstick, used nowhere in the port)."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 6)
    records = []
    for name, (b, h, nq, nk, d, pads) in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad, do = flash_case(b, h, nq, nk, d, pads, dtype, g)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            got = fl.splash_mha(*leaves, pad_mask=pad, causal=True)
            got_grads = torch.autograd.grad(got, leaves, do)
            ref_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            want = fl.flash_attention_reference(*ref_leaves, pad_mask=pad, causal=True)
            want_grads = torch.autograd.grad(want, ref_leaves, do, retain_graph=True)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in zip(("o", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
                atol, rtol = flash_limit(y, dtype)
                diff = (x.float() - y.float()).abs()
                errs[key] = diff.max().item()
                limits[key] = (atol, rtol)
                if not (diff <= atol + rtol * y.float().abs()).all():
                    raise AssertionError(f"flash {name} {dtype} {key}: kernel vs plain max error {errs[key]} "
                                         f"(atol {atol}, rtol {rtol})")
            f32_class = (f32_class_check(name, got.detach(), want.detach(), q, k, v, pad, True)
                         if dtype == torch.float32 and name == "flagship_cross_attention" else {})
            if dtype == torch.bfloat16:  # a forward without gradients: P in one bf16 term
                with torch.no_grad():
                    one = fl.splash_mha(q, k, v, pad_mask=pad, causal=True).float()
                atol, rtol = flash_limit(want, dtype)
                diff = (one - want.float()).abs()
                errs["o_one_term_p"], limits["o_one_term_p"] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * want.float().abs()).all():
                    raise AssertionError(f"flash {name} {dtype} o (one-term P): kernel vs plain max error "
                                         f"{errs['o_one_term_p']} (atol {atol}, rtol {rtol})")
                del one, diff
            # the same gradients from the kernels' own arithmetic in plain PyTorch
            fa2 = fl._backward_plain(q, k, v, pad, True, *fl._forward_plain(q, k, v, pad, True), do)
            errs_fa2 = {key: (x.float() - y.float()).abs().max().item()
                        for key, x, y in zip(("dq", "dk", "dv"), got_grads, fa2)}
            del fa2
            if pad is not None:
                at = pad[:, None, :, None].expand_as(got_grads[1])
                if not ((got_grads[1][at] == 0).all() and (got_grads[2][at] == 0).all()):
                    raise AssertionError(f"flash {name} {dtype}: pad keys' dK or dV are not exact zeros")

            # saved forward for the backward-alone timings
            o, lse = fl._launch_forward(q, k, v, pad, True)
            if dtype == torch.float32 and not all(map(torch.equal, (o, lse), fl._launch_forward(q, k, v, pad, True))):
                raise AssertionError(f"flash {name} {dtype}: two forward runs on the same inputs differ")
            first, second = (fl._launch_backward(q, k, v, pad, True, o, lse, do) for _ in range(2))
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"flash {name} {dtype}: two backward runs on the same inputs differ")
            del first, second
            mask = fl._visibility(nq, nk, pad, True, q.device).contiguous()
            lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)

            def both(fn, ls):
                return lambda: torch.autograd.grad(fn(*ls), ls, do)

            def library(*ts):
                return F.scaled_dot_product_attention(*ts, attn_mask=mask, scale=1.0)

            times = dict(
                ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, True)),  # bf16: P in two terms, as in training
                backward_ms=time_ms(lambda: fl._launch_backward(q, k, v, pad, True, o, lse, do)),
                forward_backward_ms=time_ms(both(lambda *ts: fl.splash_mha(*ts, pad_mask=pad, causal=True), leaves)),
                plain_ms=time_ms(lambda: fl.flash_attention_reference(q, k, v, pad, True)),
                plain_backward_ms=time_ms(lambda: torch.autograd.grad(want, ref_leaves, do, retain_graph=True)),
                plain_forward_backward_ms=time_ms(both(
                    lambda *ts: fl.flash_attention_reference(*ts, pad_mask=pad, causal=True), ref_leaves)),
                library_ms=time_ms(lambda: library(q, k, v)),
                library_backward_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)),
                library_forward_backward_ms=time_ms(both(library, lib_leaves)),
            )
            if dtype == torch.bfloat16:
                times["one_term_p_ms"] = time_ms(lambda: fl._launch_forward(q, k, v, pad, True, split_p=False))
            bounds, pairs = flash_bounds(q, k, pad, torch.finfo(dtype).bits // 8)
            rec = dict(kernel="splash_mha", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b, heads=h,
                       queries=nq, keys=nk, head_dim=d, visible_pairs=pairs, max_abs_err=errs, limits=limits,
                       grad_err_vs_plain_fa2_arithmetic=errs_fa2, backward_bit_identical=True,
                       bound_ms=bounds["forward"][0], bound_by=bounds["forward"][1],
                       backward_bound_ms=bounds["backward"][0], backward_bound_by=bounds["backward"][1], **times,
                       **f32_class)
            if dtype == torch.float32:
                rec["bound_ms_cuda_cores"] = cuda_core_bound_ms(bounds["forward"][0], 4 * d * pairs)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del leaves, ref_leaves, lib_leaves, got_grads, want_grads, want, lib_out
            torch.cuda.empty_cache()
    return records


# ------------------------------------- phase 3: B1a at the optical-flow shapes
FLOW_FLASH_SHAPES = {  # name: (batch, heads, queries, keys, head dim); full mask, no padding
    # official_41m_config's decoder at bench.py's six patches: the 182,528
    # pixels of a 368 x 496 patch over the 2,048 latents, one head of 512
    "flow_decoder_cross_attention": (6, 1, 182_528, 2048, 512),
    "flow_self_attention": (6, 8, 2048, 2048, 64),  # each of its 24 self-attention layers
}


def full_mask_bound(b, h, nq, nk, d, esize, backward=False, inference=False):
    """Least time (ms, bound_by) of one full-mask forward (or backward): 4 D
    (10 D) flops a (query, key) pair over the dense peak of the input type,
    against the bytes moved once: q, k and v in, the float32 output and
    log-sum-exp out (backward: q, k, v and dO in, the float32 output and
    log-sum-exp in, dq, dk and dv out; ``inference``: a forward whose one
    output is o in the input type)."""
    flops = (10 if backward else 4) * d * b * h * nq * nk
    rows = (3 * b * h * nq + 4 * b * h * nk) if backward else (b * h * nq + 2 * b * h * nk)
    nbytes = rows * d * esize + (b * h * nq * d * esize if inference else b * h * nq * (d + 1) * 4)
    peak = BF16_FLOP_PER_S if esize == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_kernel_names(fn, top=4):
    """The names of the CUDA kernels one call of ``fn`` spends most time in
    (torch.profiler): which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.key[:120] for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]]


def check_flow_flash_kernel():
    """B1a at the optical-flow model's attention shapes, full mask, as the
    inference path calls it (no gradients: in bf16 P in one bf16 term),
    against its plain version: bf16 within 0.03 x the plain output's RMS
    plus one bf16 step of the element (flash_limit), f32 within 1e-4. The
    decoder's shape is checked at 1 patch and at the main path's 6 patches:
    the six-patch launch is held patch by patch against the plain version of
    each patch (its float32 scores of six patches at once are 9 GB a copy);
    in float32 its patch is also held to float32-class accuracy
    (f32_class_check). It is timed at 6 and at 1 (in float32 the
    default-dtype pipeline's call): the kernel and the library call at 6
    patches and at 1, the plain version at 1 and over the 6 patches one
    patch a call. F.scaled_dot_product_attention is the library yardstick,
    used nowhere in the port; the kernels it launched are named (PyTorch's
    flash backend takes heads up to 256 channels). Float32 bounds have their
    CUDA-core bound beside them."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 10)
    records = []
    for name, (b, h, nq, nk, d) in FLOW_FLASH_SHAPES.items():
        decoder = name == "flow_decoder_cross_attention"
        for dtype in (torch.float32, torch.bfloat16):
            nb = 1 if decoder else b
            q, k, v, _, _ = flash_case(nb, h, nq, nk, d, None, dtype, g)
            with torch.no_grad():
                got, again = fl.splash_mha(q, k, v), fl.splash_mha(q, k, v)
            want = fl.flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash {name} {dtype}: two runs on the same inputs differ")
            if got.dtype != dtype:
                raise AssertionError(f"flash {name} {dtype}: the forward without gradients returned {got.dtype}")
            del again
            atol, rtol = flash_limit(want, dtype)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if not (diff <= atol + rtol * want.float().abs()).all():
                raise AssertionError(f"flash {name} {dtype}: kernel vs plain max error {err} (atol {atol}, "
                                     f"rtol {rtol})")
            del diff
            f32_class = (f32_class_check(name, got, want, q, k, v, None, False)
                         if decoder and dtype == torch.float32 else {})
            del got, want
            esize = torch.finfo(dtype).bits // 8
            rec = dict(kernel="splash_mha", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       checked_batch=nb, heads=h, queries=nq, keys=nk, head_dim=d, mask="full",
                       max_abs_err=err, limits=(atol, rtol), bit_identical=True,
                       ms_checked_batch=time_ms(lambda: fl._launch_forward(q, k, v, None, False, split_p=False)),
                       plain_ms_checked_batch=time_ms(lambda: fl.flash_attention_reference(q, k, v), reps=5),
                       library_ms_checked_batch=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)),
                       **f32_class)
            if decoder:  # six patches
                patches = [flash_case(1, h, nq, nk, d, None, dtype, g)[:3] for _ in range(b)]
                q6, k6, v6 = (torch.cat(ts) for ts in zip(*patches))
                o6 = fl._launch_forward(q6, k6, v6, None, False, split_p=False)[0]
                if o6.dtype != dtype or not torch.equal(
                        o6, fl._launch_forward(q6, k6, v6, None, False, split_p=False)[0]):
                    raise AssertionError(f"flash {name} {dtype} at {b} patches: not a {dtype} output, or two runs "
                                         "differ")
                errs6 = []
                for i, patch in enumerate(patches):
                    want = fl.flash_attention_reference(*patch)
                    atol6, rtol6 = flash_limit(want, dtype)
                    diff = (o6[i:i + 1].float() - want.float()).abs()
                    errs6.append(diff.max().item())
                    if not (diff <= atol6 + rtol6 * want.float().abs()).all():
                        raise AssertionError(f"flash {name} {dtype} at {b} patches: patch {i} kernel vs plain "
                                             f"max error {errs6[-1]} (atol {atol6}, rtol {rtol6})")
                    del want, diff
                del o6
                rec.update(max_abs_err=max(err, *errs6), max_abs_err_checked_batch=err, max_abs_err_by_patch=errs6)
                rec.update(
                    ms=time_ms(lambda: fl._launch_forward(q6, k6, v6, None, False, split_p=False), reps=10),
                    plain_ms=time_ms(lambda: [fl.flash_attention_reference(*t) for t in patches], reps=3),
                    plain_ms_note="the six patches one patch a call",
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(q6, k6, v6, scale=1.0), reps=10),
                    library_kernels=cuda_kernel_names(lambda: F.scaled_dot_product_attention(q6, k6, v6,
                                                                                             scale=1.0)))
                del patches, q6, k6, v6
            else:
                rec.update(ms=rec["ms_checked_batch"], plain_ms=rec["plain_ms_checked_batch"],
                           library_ms=rec["library_ms_checked_batch"],
                           library_kernels=cuda_kernel_names(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                                                    scale=1.0)))
            rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, esize)
            rec["bound_ms_checked_batch"], rec["bound_by_checked_batch"] = full_mask_bound(nb, h, nq, nk, d, esize)
            if dtype == torch.float32:
                for key, batch in (("bound_ms", b), ("bound_ms_checked_batch", nb)):
                    rec[f"{key}_cuda_cores"] = cuda_core_bound_ms(rec[key], 4 * d * batch * h * nq * nk)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v
            torch.cuda.empty_cache()
    return records


# ------------------------- phase 3: B1a wide (csrc/flash_forward_wide.cu) beyond inference
WIDE_FORWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    # official_41m_config's decoder in the train step: B1a with two-term P
    # (B1b reads its float32 output) at 2 patches, full mask
    "flow_decoder_train_step": (2, 1, 182_528, 2048, 512, None, False),
    # 1,050 queries: 16 full 64-query tiles and a partial one, so the last
    # two-block cluster holds a spare block; left-padded keys, causal
    "wide_192_padded_causal": (2, 2, 1050, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1050, 768, 256, [0, 300], True),
}


def check_wide_forward_kernel():
    """B1a's wide bf16 kernel (csrc/flash_forward_wide.cu) where the flow
    inference check does not reach: the flow train step's call (2 patches,
    P in two terms, float32 o), held patch by patch, and D 192 and 256,
    padded and causal, at an odd query-tile count, with P in one term (the
    bf16 output within flash_limit) and in two (the float32 output and lse
    within F32_ATOL); every launch run twice for the same bits. Times per
    call (L2 flushed), the bound, the plain version and the library call
    F.scaled_dot_product_attention (with the same mask, returning the output
    only)."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 12)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in WIDE_FORWARD_SHAPES.items():
        decoder = name == "flow_decoder_train_step"
        q, k, v, pad, _ = flash_case(b, h, nq, nk, d, pads, torch.bfloat16, g)
        mask = None if pad is None and not causal else fl._visibility(nq, nk, pad, causal, q.device).contiguous()
        rec = dict(kernel="splash_mha", shape=name, dtype="bfloat16", batch=b, heads=h, queries=nq, keys=nk,
                   head_dim=d, causal=causal, query_tiles=-(-nq // 64), bit_identical=True, launches_per_call=1)
        errs = {}
        for split_p in ((True,) if decoder else (False, True)):
            key = "two_term_p" if split_p else "one_term_p"
            first, second = (fl._launch_forward(q, k, v, pad, causal, split_p=split_p) for _ in range(2))
            torch.cuda.synchronize()
            if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
                raise AssertionError(f"wide forward {name} ({key}): two runs on the same inputs differ")
            want_dtype = torch.float32 if split_p else torch.bfloat16
            if first[0].dtype != want_dtype:
                raise AssertionError(f"wide forward {name} ({key}): o is {first[0].dtype}, not {want_dtype}")
            del second
            for i in range(b if decoder else 1):  # the decoder patch by patch, as the plain version's scores are large
                at = slice(i, i + 1) if decoder else slice(None)
                want_o, want_lse = fl._forward_plain(q[at], k[at], v[at], None if pad is None else pad[at], causal)
                pairs = [("lse", first[1][at], want_lse)]
                pairs.append(("o", first[0][at], want_o) if split_p else ("o", first[0][at], want_o.bfloat16()))
                for part, x, y in pairs:
                    atol, rtol = (F32_ATOL, 0.0) if split_p else flash_limit(y, torch.bfloat16)
                    finite = torch.isfinite(y)
                    if not torch.equal(torch.isfinite(x), finite):
                        raise AssertionError(f"wide forward {name} ({key}) {part}: finite entries differ")
                    diff = (x[finite].float() - y[finite].float()).abs()
                    err = diff.max().item() if diff.numel() else 0.0
                    errs[f"{part}_{key}"] = max(errs.get(f"{part}_{key}", 0.0), err)
                    if not (diff <= atol + rtol * y[finite].float().abs()).all():
                        raise AssertionError(f"wide forward {name} ({key}) {part}: kernel vs plain max error {err} "
                                             f"(atol {atol}, rtol {rtol})")
                del want_o, want_lse, pairs
            del first
        rec["max_abs_err"] = errs
        if decoder:
            rec.update(ms=time_ms(lambda: fl._launch_forward(q, k, v, None, False, split_p=True), reps=10),
                       plain_ms=time_ms(lambda: [fl._forward_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], None, False)
                                                 for i in range(b)], reps=3),
                       plain_ms_note="the two patches one patch a call",
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), reps=10))
            rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, 2)
        else:
            (bounds, pairs) = flash_bounds(q, k, pad, 2)
            rec.update(ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal, split_p=False)),
                       two_term_p_ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal, split_p=True)),
                       plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, causal)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)),
                       visible_pairs=pairs, bound_ms=bounds["forward"][0], bound_by=bounds["forward"][1])
        emit(phase="kernel_check", **rec)
        records.append(rec)
        del q, k, v, pad, mask
        torch.cuda.empty_cache()
    return records


# ------------------------- phase 3: B1a in float32 (csrc/flash_forward_f32.cu)
# The float32-class limit: the float32 forward's error against the float64
# plain version at most this many times the plain float32 version's (TF32
# off). On an H100 the kernel read 0.44-0.93 x, its first build (one chain of
# the tensor cores' truncating sums over D and every key) 6.13-8.69 x, one
# TF32 term 250-2,000 x.
F32_CLASS_FACTOR = 4


def f32_class_check(name, got, want, q, k, v, pad, causal):
    """The float32-class check of a float32 forward's output ``got`` (the
    plain float32 version's is ``want``): its error against the float64
    plain version within F32_CLASS_FACTOR x the plain float32 version's.
    Returns the record's fields."""
    ref = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)[0]
    err_kernel = (got.double() - ref).abs().max().item()
    err_plain = (want.double() - ref).abs().max().item()
    del ref
    if not err_kernel <= F32_CLASS_FACTOR * err_plain:
        raise AssertionError(f"f32 forward {name}: error vs float64 {err_kernel} is more than {F32_CLASS_FACTOR} x "
                             f"the plain float32 version's {err_plain}")
    return dict(err_vs_float64=err_kernel, plain_f32_err_vs_float64=err_plain,
                err_ratio=err_kernel / max(err_plain, 1e-30), err_ratio_limit=F32_CLASS_FACTOR)


def cuda_core_bound_ms(bound_ms, flops):
    """A float32 bound at the CUDA cores' rate, printed beside the tensor
    cores' ``bound_ms``: the larger of its bytes time and ``flops`` over
    F32_CUDA_CORE_FLOP_PER_S."""
    return max(bound_ms, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3)


# ------------------------------- phase 3: B1b at the optical-flow decoder's head
WIDE_BACKWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    # official_41m_config's decoder in the train step: 182,528 pixels over
    # 2,048 latents, one head of 512, full mask; checked at 1 patch, timed at 2
    "flow_decoder_cross_attention": (2, 1, 182_528, 2048, 512, None, False),
    "wide_192_padded_causal": (2, 2, 1024, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1024, 768, 256, [0, 300], True),
    # 1,050 queries: 17 of the dQ pass's 64-query tiles, so its last cluster
    # holds a spare block; 720 keys: 23 of the dK/dV pass's 32-key blocks, the
    # last ragged, and a spare block there too; bf16 only
    "wide_320_padded_causal_ragged": (2, 2, 1050, 720, 320, [0, 300], True),
}
# the wide backward's passes, by a fragment of each kernel's name
WIDE_BACKWARD_PASSES = {"flash_bwd_delta_kernel": "delta", "flash_bwd_wide_dkdv_kernel": "dkdv",
                        "flash_bwd_wide_reduce_kernel": "reduce", "flash_bwd_wide_dq_kernel": "dq"}


def wide_backward_pass_ms(fn, calls=3, passes=None):
    """Device ms of each pass of one backward call (torch.profiler, median
    over ``calls`` calls), by ``passes`` (a fragment of each kernel's name:
    the pass; default the wide bf16 backward's delta, dK/dV, the split
    reduce, dQ)."""
    passes = WIDE_BACKWARD_PASSES if passes is None else passes
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {name: [] for name in passes.values()}
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for fragment, name in passes.items():
                    if fragment in e.key:
                        times[name].append(e.self_device_time_total / 1e3)
    return {name: statistics.median(ts) for name, ts in times.items() if ts}


def check_wide_backward_kernel():
    """B1b at heads of 192-512 channels (bf16: csrc/flash_backward_wide.cu;
    f32: csrc/flash_backward_f32.cu) against its plain version
    (the same (o, lse) from B1a's plain version into both): dq, dk and dv
    within flash_limit, pad keys' dk and dv exact zeros, two runs the same
    bits. The flow decoder's shape in bf16, full mask: checked at 1 patch
    and at the train step's 2 patches (that launch held patch by patch
    against the plain version of each patch, and run twice for the same
    bits), timed at 2 (kernel, the plain backward as two one-patch calls,
    and the library yardstick F.scaled_dot_product_attention: its backward
    from a saved forward, and forward + backward, with the CUDA kernels it
    ran named, or the error it raised, and each pass's device ms); D 192 and
    256 in bf16 and f32 at a left-padded causal shape (in f32 B1a's forward
    too: o and lse within F32_ATOL of the plain version, rows that see no
    key exact zeros, two runs the same bits, timed beside the plain version,
    the library call and its bound at both float32 rates); D 320 in bf16 at
    a left-padded causal shape whose query and key tiles both leave a spare
    block in their last cluster. Times per call, L2 flushed."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 11)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in WIDE_BACKWARD_SHAPES.items():
        decoder = name == "flow_decoder_cross_attention"
        bf16_only = decoder or name.endswith("_ragged")
        for dtype in (torch.bfloat16,) if bf16_only else (torch.float32, torch.bfloat16):
            nb = 1 if decoder else b
            q, k, v, pad, do = flash_case(nb, h, nq, nk, d, pads, dtype, g)
            o, lse = fl._forward_plain(q, k, v, pad, causal)
            want = fl._backward_plain(q, k, v, pad, causal, o, lse, do)
            first = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
            second = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in zip(("dq", "dk", "dv"), first, want):
                atol, rtol = flash_limit(y, dtype)
                diff = (x.float() - y.float()).abs()
                errs[key], limits[key] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * y.float().abs()).all():
                    raise AssertionError(f"wide backward {name} {dtype} {key}: kernel vs plain max error "
                                         f"{errs[key]} (atol {atol}, rtol {rtol})")
            if pad is not None:
                at = pad[:, None, :, None].expand_as(first[1])
                if not ((first[1][at] == 0).all() and (first[2][at] == 0).all()):
                    raise AssertionError(f"wide backward {name} {dtype}: pad keys' dK or dV are not exact zeros")
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"wide backward {name} {dtype}: two runs on the same inputs differ")
            del want, first, second
            esize = torch.finfo(dtype).bits // 8
            rec = dict(kernel="splash_mha_backward", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       checked_batch=nb, heads=h, queries=nq, keys=nk, head_dim=d, causal=causal,
                       max_abs_err=errs, limits=limits, backward_bit_identical=True)
            if decoder:  # the train step's two patches, held patch by patch against the plain version
                patches = [(q, k, v, do)]
                for _ in range(b - 1):
                    pq, pk, pv, _, pdo = flash_case(1, h, nq, nk, d, None, dtype, g)
                    patches.append((pq, pk, pv, pdo))
                q2, k2, v2, do2 = (torch.cat(ts) for ts in zip(*patches))
                o2, lse2 = fl._launch_forward(q2, k2, v2, None, False)
                per_patch = [(pq, pk, pv, o2[i:i + 1], lse2[i:i + 1], pdo)
                             for i, (pq, pk, pv, pdo) in enumerate(patches)]
                first = fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2)
                second = fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(first, second)):
                    raise AssertionError(f"wide backward {name} {dtype} at {b} patches: two runs differ")
                del second
                errs2 = []
                for i, args in enumerate(per_patch):
                    want = fl._backward_plain(*args[:3], None, False, *args[3:])
                    errs2.append({})
                    for key, x, y in zip(("dq", "dk", "dv"), first, want):
                        atol2, rtol2 = flash_limit(y, dtype)
                        diff = (x[i:i + 1].float() - y.float()).abs()
                        errs2[-1][key] = diff.max().item()
                        if not (diff <= atol2 + rtol2 * y.float().abs()).all():
                            raise AssertionError(f"wide backward {name} {dtype} at {b} patches: patch {i} {key} "
                                                 f"kernel vs plain max error {errs2[-1][key]} (atol {atol2}, "
                                                 f"rtol {rtol2})")
                        del diff
                    del want
                del first
                rec.update(max_abs_err={key: max(errs[key], *(e[key] for e in errs2)) for key in errs},
                           max_abs_err_checked_batch=errs, max_abs_err_by_patch=errs2)
                rec.update(
                    splits=fl.wide_backward_splits(b * h, nq, nk, d,
                                                   torch.cuda.get_device_properties(0).multi_processor_count),
                    ms=time_ms(lambda: fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2), reps=10),
                    ms_by_pass=wide_backward_pass_ms(lambda: fl._launch_backward(q2, k2, v2, None, False, o2, lse2,
                                                                                 do2)),
                    ms_checked_batch=time_ms(lambda: fl._launch_backward(q, k, v, None, False, o, lse, do), reps=10),
                    plain_ms=time_ms(lambda: [fl._backward_plain(pq, pk, pv, None, False, po, pl, pdo)
                                              for pq, pk, pv, po, pl, pdo in per_patch], reps=3),
                    plain_ms_note="the two patches one patch a call")
                leaves = [t.detach().clone().requires_grad_() for t in (q2, k2, v2)]
                fb = lambda: torch.autograd.grad(fl.splash_mha(*leaves), leaves, do2)
                rec["forward_backward_ms"] = time_ms(fb, reps=5)
                try:
                    lib_leaves = [t.detach().clone().requires_grad_() for t in (q2, k2, v2)]
                    lib_out = F.scaled_dot_product_attention(*lib_leaves, scale=1.0)
                    lib_fb = lambda: torch.autograd.grad(F.scaled_dot_product_attention(*lib_leaves, scale=1.0),
                                                         lib_leaves, do2)
                    rec.update(
                        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do2, retain_graph=True),
                                           reps=5),
                        library_forward_backward_ms=time_ms(lib_fb, reps=5),
                        library_kernels=cuda_kernel_names(lib_fb, top=6))
                    del lib_out, lib_leaves
                except RuntimeError as err:  # no backend of F.scaled_dot_product_attention takes this shape
                    rec.update(library_ms=None, library_error=str(err)[:300])
                del patches, per_patch, q2, k2, v2, do2, o2, lse2, leaves
                rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, esize, backward=True)
                rec["bound_ms_checked_batch"] = full_mask_bound(nb, h, nq, nk, d, esize, backward=True)[0]
            else:  # causal: flash_bounds counts the visible pairs
                bounds, pairs = flash_bounds(q, k, pad, esize)
                mask = fl._visibility(nq, nk, pad, causal, q.device).contiguous()
                lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)
                rec.update(ms=time_ms(lambda: fl._launch_backward(q, k, v, pad, causal, o, lse, do)),
                           plain_ms=time_ms(lambda: fl._backward_plain(q, k, v, pad, causal, o, lse, do)),
                           library_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)),
                           library_note="backward from a saved forward",
                           visible_pairs=pairs, bound_ms=bounds["backward"][0], bound_by=bounds["backward"][1],
                           ops_ms_cuda_cores=10 * d * pairs / F32_CUDA_CORE_FLOP_PER_S * 1e3
                           if dtype == torch.float32 else None)
                if dtype == torch.float32:  # B1a's float32 forward on the same inputs
                    fo, flse = fl._launch_forward(q, k, v, pad, causal)
                    again = fl._launch_forward(q, k, v, pad, causal)
                    finite = torch.isfinite(lse)
                    if not (torch.equal(fo, again[0]) and torch.equal(flse, again[1])
                            and torch.equal(torch.isfinite(flse), finite) and (fo[~finite] == 0).all()):
                        raise AssertionError(f"f32 forward {name}: two runs differ, or its rows that see no key are "
                                             "not zeros and -inf")
                    ferrs = {"o": (fo - o).abs().max().item(),
                             "lse": (flse[finite] - lse[finite]).abs().max().item()}
                    if not max(ferrs.values()) <= F32_ATOL:
                        raise AssertionError(f"f32 forward {name}: kernel vs plain max error {ferrs} (atol {F32_ATOL})")
                    del fo, flse, again
                    rec.update(forward_max_abs_err=ferrs, forward_bit_identical=True,
                               forward_ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal)),
                               forward_plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, causal)),
                               forward_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                                   q, k, v, attn_mask=mask, scale=1.0)),
                               forward_bound_ms=bounds["forward"][0], forward_bound_by=bounds["forward"][1],
                               forward_bound_ms_cuda_cores=cuda_core_bound_ms(bounds["forward"][0], 4 * d * pairs))
                del mask, lib_leaves, lib_out
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return records


# -------------------------------- phase 3: B1b in float32 (csrc/flash_backward_f32.cu)
F32_BACKWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    "flagship_cross_attention": (16, 10, 512, 1024, 128, None, True),
    "flagship_self_attention": (16, 10, 512, 512, 128, None, True),
    "clm_30m_cross_attention": (8, 8, 512, 2304, 64, [0, 0, 7, 100, 300, 511, 1024, 1790], True),
    "wide_192_padded_causal": (2, 2, 1024, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1024, 768, 256, [0, 300], True),
    # the default-dtype (float32) flow train step's decoder call: one patch
    # of 182,528 pixel queries over 2,048 latents, one head of 512, full mask
    "flow_decoder_cross_attention": (1, 1, 182_528, 2048, 512, None, False),
    "flow_self_attention": (6, 8, 2048, 2048, 64, None, False),  # each of its 24 self-attention layers
}
F32_GRAD_CLASS_SHAPES = ("flagship_cross_attention", "flow_decoder_cross_attention")
# the float32 backward's passes, by a fragment of each kernel's name
F32_BACKWARD_PASSES = {"flash_bwd_f32_delta_kernel": "delta", "flash_bwd_f32_split_kernel": "split",
                       "flash_bwd_f32_dkdv_kernel": "dkdv", "flash_bwd_f32_reduce_kernel": "reduce",
                       "flash_bwd_f32_dq_kernel": "dq"}


def f32_grad_class_check(name, got, want, q, k, v, pad, causal, do):
    """The float32-class check of a float32 backward's gradients ``got``
    (the plain float32 backward's are ``want``): each of dq, dk and dv within
    F32_CLASS_FACTOR x the plain float32 version's error against the plain
    backward in float64 (from its own float64 forward). Returns the record's
    fields."""
    o64, lse64 = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)
    ref = fl._backward_plain(q.double(), k.double(), v.double(), pad, causal, o64, lse64, do.double())
    del o64, lse64
    out = {}
    for key, x, y, r in zip(("dq", "dk", "dv"), got, want, ref):
        e_kernel, e_plain = (x.double() - r).abs().max().item(), (y.double() - r).abs().max().item()
        out[key] = dict(err_vs_float64=e_kernel, plain_f32_err_vs_float64=e_plain,
                        err_ratio=e_kernel / max(e_plain, 1e-30))
    del ref
    torch.cuda.empty_cache()
    if not all(r["err_ratio"] <= F32_CLASS_FACTOR for r in out.values()):
        raise AssertionError(f"f32 backward {name}: error vs float64 more than {F32_CLASS_FACTOR} x the plain float32 "
                             f"version's: {out}")
    return dict(grad_err_vs_float64=out, err_ratio_limit=F32_CLASS_FACTOR)


def check_f32_backward_kernel():
    """B1b in float32 (csrc/flash_backward_f32.cu: five products, each as
    three TF32 products on wgmma fed by TMA) at every float32 backward shape
    of the main paths: the flagship cross- and self-attention, the 30M
    cross-attention (left-padded), D 192 and 256 padded causal, the
    default-dtype flow train step's decoder call (one patch, full mask) and
    its self-attention. From the plain forward's (o, lse): dq, dk and dv
    within F32_ATOL of the plain backward, pad keys' dk and dv exact zeros,
    two runs the same bits; at F32_GRAD_CLASS_SHAPES the gradients'
    error from the float64 plain backward within F32_CLASS_FACTOR x the
    plain float32 version's. Times per call, L2 flushed: the kernel, the
    plain backward, the library's backward from a saved forward
    (F.scaled_dot_product_attention with the same boolean mask, a yardstick
    used nowhere in the port; its CUDA kernels named, or its error), the
    bound at 165 TFLOP/s (three TF32 products) and at the CUDA cores' 67,
    and at the flow decoder and the flagship cross-attention each pass's
    device ms. Only ops/flash.py's _launch_backward, _forward_plain and
    _backward_plain are called, so a checkout of another tree's package can
    be read by the same checks."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 15)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in F32_BACKWARD_SHAPES.items():
        q, k, v, pad, do = flash_case(b, h, nq, nk, d, pads, torch.float32, g)
        o, lse = fl._forward_plain(q, k, v, pad, causal)
        want = fl._backward_plain(q, k, v, pad, causal, o, lse, do)
        first = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        second = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        torch.cuda.synchronize()
        errs = {key: (x - y).abs().max().item() for key, x, y in zip(("dq", "dk", "dv"), first, want)}
        if not max(errs.values()) <= F32_ATOL:
            raise AssertionError(f"f32 backward {name}: kernel vs plain max error {errs} (atol {F32_ATOL})")
        if pad is not None:
            at = pad[:, None, :, None].expand_as(first[1])
            if not ((first[1][at] == 0).all() and (first[2][at] == 0).all()):
                raise AssertionError(f"f32 backward {name}: pad keys' dK or dV are not exact zeros")
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"f32 backward {name}: two runs on the same inputs differ")
        rec = dict(kernel="splash_mha_backward", shape=name, dtype="float32", batch=b, heads=h, queries=nq, keys=nk,
                   head_dim=d, causal=causal, max_abs_err=errs, limit=F32_ATOL, backward_bit_identical=True,
                   pad_grads_exact_zero=pad is not None)
        if name in F32_GRAD_CLASS_SHAPES:
            rec.update(f32_grad_class_check(name, first, want, q, k, v, pad, causal, do))
        del first, second, want
        torch.cuda.empty_cache()
        if causal or pad is not None:
            bounds, pairs = flash_bounds(q, k, pad, 4)
            bound, bound_by = bounds["backward"]
        else:
            pairs = b * h * nq * nk
            bound, bound_by = full_mask_bound(b, h, nq, nk, d, 4, backward=True)
        flow = nq > 100_000
        call = lambda: fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        rec.update(visible_pairs=pairs, bound_ms=bound, bound_by=bound_by,
                   bound_ms_cuda_cores=cuda_core_bound_ms(bound, 10 * d * pairs),
                   ms=time_ms(call, reps=10 if flow else 25),
                   plain_ms=time_ms(lambda: fl._backward_plain(q, k, v, pad, causal, o, lse, do), reps=3 if flow else 10))
        if name in F32_GRAD_CLASS_SHAPES:
            rec["ms_by_pass"] = wide_backward_pass_ms(call, passes=F32_BACKWARD_PASSES)
        mask = fl._visibility(nq, nk, pad, causal, q.device).contiguous() if causal or pad is not None else None
        try:
            lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)
            lib_backward = lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)
            rec.update(library_ms=time_ms(lib_backward, reps=5 if flow else 25),
                       library_note="backward from a saved forward",
                       library_kernels=cuda_kernel_names(lib_backward, top=4))
            del lib_out, lib_leaves
        except RuntimeError as err:  # no backend of F.scaled_dot_product_attention takes this shape
            rec.update(library_ms=None, library_error=str(err)[:300])
        emit(phase="kernel_check", **rec)
        records.append(rec)
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return records


# --------------------------------------------- phase 3: ring-block kernel
RING_BLOCK_SHAPES = {  # name: (batch, heads, queries, keys, head dim, leading padding keys per row or None)
    # clm_8k's cross-attention at {"seq": 4}: 256 latents over 1,152 of the
    # 4,608 keys the gather keeps; row 2's block is all padding
    "clm_8k_cross_block": (4, 8, 256, 1152, 64, [0, 300, 1152, 17]),
    "clm_8k_self_block": (4, 8, 256, 256, 64, None),  # its self-attention at {"seq": 4}
    "flagship_seq2_block": (16, 10, 256, 512, 128, None),  # the 455M flagship's cross-attention at {"seq": 2}
    # a ring block at a wide head (csrc/flash_forward_wide.cu, two-term P):
    # clm_8k's cross-attention block with 256-channel heads; row 2 all padding
    "wide_256_block": (4, 4, 256, 1152, 256, [0, 300, 1152, 17]),
}


def ring_block_bound(q, k, pad, esize):
    """Least time (ms, bound_by) of one ring block for these inputs: 4 D
    flops a visible (query, key) pair (every non-padding key of the row)
    over the dense peak of the input type, against the bytes moved once: q,
    the k and v of the non-padding keys (a padding key's are never needed)
    and the pad flags in, the float32 output and log-sum-exp out."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    keys = b * nk - (0 if pad is None else int(pad.sum().item()))
    pairs = keys * nq * h
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    nbytes = (b * h * nq * d + 2 * h * keys * d) * esize + (0 if pad is None else b * nk) + b * h * nq * (d + 1) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 4 * d * pairs / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), pairs


def check_ring_block_kernel():
    """B5 (``ring_block_forward``: B1a's entry with no causal mask) against
    its plain version at the ring's block shapes, float32 and bfloat16: the
    float32 output and log-sum-exp within F32_ATOL for both input types (both
    sides sum in float32 from the same inputs and round nothing to
    bfloat16, so no bfloat16 allowance applies); a row whose keys are
    all padding must give exact zeros and lse = -inf. Times per launch; the
    library yardstick is F.scaled_dot_product_attention with the same key
    mask, which returns the output only (no log-sum-exp) and NaN for an
    all-padding row."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 9)
    records = []
    for name, (b, h, nq, nk, d, pads) in RING_BLOCK_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(b, h, nq, d, generator=g, device=DEVICE) * d**-0.5).to(dtype)
            k, v = (torch.randn(b, h, nk, d, generator=g, device=DEVICE).to(dtype) for _ in range(2))
            pad = None if pads is None else (torch.arange(nk, device=DEVICE)[None, :]
                                             < torch.tensor(pads, device=DEVICE)[:, None])
            o, lse = fl.ring_block_forward(q, k, v, pad)
            want_o, want_lse = fl._forward_plain(q, k, v, pad, False)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in (("o", o, want_o), ("lse", lse, want_lse)):
                finite = torch.isfinite(y)
                if not torch.equal(torch.isfinite(x), finite):
                    raise AssertionError(f"ring block {name} {dtype} {key}: finite entries differ from the plain "
                                         "version")
                atol, rtol = F32_ATOL, 0.0
                diff = (x[finite] - y[finite]).abs()
                errs[key], limits[key] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * y[finite].abs()).all():
                    raise AssertionError(f"ring block {name} {dtype} {key}: kernel vs plain max error {errs[key]} "
                                         f"(atol {atol}, rtol {rtol})")
            blind = torch.zeros(b, dtype=torch.bool, device=DEVICE) if pad is None else pad.all(1)
            if not ((o[blind] == 0).all() and torch.isneginf(lse[blind]).all()):
                raise AssertionError(f"ring block {name} {dtype}: an all-padding row is not exact zeros and -inf")
            mask = None if pad is None else ~pad[:, None, None, :]
            (bound, bound_by), pairs = ring_block_bound(q, k, pad, torch.finfo(dtype).bits // 8)
            rec = dict(kernel="ring_block_forward", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       heads=h, queries=nq, keys=nk, head_dim=d, all_padding_rows=int(blind.sum()),
                       visible_pairs=pairs, max_abs_err=errs, limits=limits,
                       ms=time_ms(lambda: fl.ring_block_forward(q, k, v, pad)),
                       plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, False)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)),
                       library_returns="output only, no log-sum-exp", bound_ms=bound, bound_by=bound_by)
            if dtype == torch.float32:
                rec["bound_ms_cuda_cores"] = cuda_core_bound_ms(bound, 4 * d * pairs)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v, o, lse, want_o, want_lse
            torch.cuda.empty_cache()
    return records


# ----------------------------------------------------- phase 4: main path
def stamp_after(fn, stamps):
    """``fn``, made to synchronise the card and append the host clock when it
    returns: wrapped around the model's prefill, it splits a generate() call
    into its prefill and its decode loop."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    return wrapped


def drive(model, stamps, ids, num_latents, max_new, pad_mask=None, **cfg):
    """One generate() call with the launch counter read around it; returns
    the tokens, the stats, the counted launches, the decode iterations it must
    have made, and the seconds of its prefill and of its decode loop."""
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    t0 = time.perf_counter()
    tokens, stats = generate(model, ids, num_latents=num_latents, pad_mask=pad_mask, max_new_tokens=max_new,
                             return_stats=True, **cfg)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dk.launches
    if cfg.get("decode_chunk", 1) > 1:
        iterations = stats["chunk_iterations"] + max(stats["tail_steps"] - 1, 0)
    else:
        iterations = max_new - 1  # the step after the last token is never run
    return tokens, stats, launches, iterations, stamps[-1] - t0, t_end - stamps[-1]


def spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def main_path():
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    model = CausalSequenceModel(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    stamps = []
    model.prefill_with_hidden = stamp_after(model.prefill_with_hidden, stamps)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    batch = 8
    prompt = lambda n: torch.randint(1, cfg.vocab_size, (batch, n), generator=g, device="cuda")
    generate(model, prompt(64), num_latents=8, max_new_tokens=4)  # warm-up: cuBLAS handles, the kernel library

    ids768, ids1024 = prompt(768), prompt(1024)
    pads = torch.tensor([0, 17, 100, 300, 511, 0, 5, 64], device="cuda")
    pad_mask = torch.arange(768, device="cuda")[None, :] < pads[:, None]
    padded = ids768.masked_fill(pad_mask, 0)
    runs = [
        ("greedy", ids768, 256, 128, None, {}),
        ("rolling_window", ids1024, 512, 32, None, {}),
        ("chunked", ids768, 256, 128, None, {"decode_chunk": 8}),
        ("left_padded", padded, 256, 32, pad_mask, {}),
    ]
    total_launches, outputs = 0, {}
    for name, ids, num_latents, max_new, pm, extra in runs:
        prefill_ms, ms_per_iteration, tokens_per_s, news = [], [], [], []
        for _ in range(MAIN_PATH_REPEATS):
            tokens, stats, launches, iterations, prefill_s, decode_s = drive(
                model, stamps, ids, num_latents, max_new, pm, **extra)
            expected = (1 + layers) * iterations
            if launches != expected:
                raise AssertionError(f"{name}: {launches} decode-kernel launches, expected (1 + {layers}) x {iterations}")
            new = tokens[:, ids.shape[1]:]
            if tokens.shape != (batch, ids.shape[1] + max_new) or not torch.equal(tokens[:, : ids.shape[1]], ids):
                raise AssertionError(f"{name}: output shape {tuple(tokens.shape)} or prompt not preserved")
            if not ((new >= 0) & (new < cfg.vocab_size)).all():
                raise AssertionError(f"{name}: token ids outside the vocabulary")
            total_launches += launches
            news.append(new)
            prefill_ms.append(prefill_s * 1e3)
            ms_per_iteration.append(decode_s * 1e3 / iterations)
            tokens_per_s.append(batch * (max_new - 1) / decode_s)
        emit(phase="main_path", run=name, batch=batch, prompt=ids.shape[1], num_latents=num_latents,
             new_tokens=max_new, decode_iterations=iterations, launches_per_call=launches,
             expected_launches=expected, stats=stats, repeats=MAIN_PATH_REPEATS,
             tokens_identical_across_repeats=all(torch.equal(n, news[0]) for n in news),
             prefill_ms=spread(prefill_ms), ms_per_decode_iteration=spread(ms_per_iteration),
             decode_tokens_per_s=spread(tokens_per_s))
        outputs[name] = news[0]
    agree = (outputs["chunked"] == outputs["greedy"]).float().mean().item()
    emit(phase="main_path", check="chunked_vs_greedy_token_agreement_bf16", agreement=agree)
    del model
    torch.cuda.empty_cache()
    return total_launches


# -------------------------------------------------------- phase 5: serving
CHAT = dict(kv_page_size=128, prefill_chunk_tokens=256, prefix_cache=True, max_prefill_slots=2)
SERVING_MODES = {  # name: (the engine's options, the cross-attention kernel's module)
    "dense": ({}, dk),
    "paged_fp": (dict(kv_page_size=128), pk),
    "paged_int8": (dict(kv_page_size=128, kv_quant="int8"), pk),
    "paged_int4": (dict(kv_page_size=128, kv_quant="int4"), rk),
    "paged_chunked_prefix": (CHAT, pk),
}


def _sampling(i):
    """Even requests greedy, odd ones sampled at temperature 0.8 and top-k 50."""
    return dict(do_sample=bool(i % 2), temperature=0.8 if i % 2 else 1.0, top_k=50 if i % 2 else None)


def request_stream(cfg, n=32):
    """The fixed, seeded stream: prompts of 64-1024 tokens (so both admission
    paths run: shorter than 512 latents, the bucket prefill; longer, the
    split path), 16-128 new tokens, half of them sampled with their own
    seeds."""
    rs = np.random.RandomState(SEED + 4)
    stream = []
    for i in range(n):
        prompt = rs.randint(1, cfg.vocab_size, rs.randint(64, 1025)).tolist()
        config = GenerationConfig(max_new_tokens=int(rs.randint(16, 129)), **_sampling(i))
        stream.append((prompt, config, SEED + i))
    return stream


def chat_stream(cfg, n=32):
    """Chat serving with shared system prompts: four 256-token system
    prefixes (two pages each), each request one of them and its own turn,
    768-896 tokens in all (so the shared pages lie below the latent
    boundary), 16-128 new tokens (prompt and budget within the window: no
    request wraps, so every one may share), half of them sampled."""
    rs = np.random.RandomState(SEED + 6)
    systems = [rs.randint(1, cfg.vocab_size, 256).tolist() for _ in range(4)]
    stream = []
    for i in range(n):
        turn = rs.randint(1, cfg.vocab_size, int(rs.randint(768, 897)) - 256).tolist()
        config = GenerationConfig(max_new_tokens=int(rs.randint(16, 129)), **_sampling(i))
        stream.append((systems[i % 4] + turn, config, SEED + i))
    return stream


def serve(model, mode, stream, num_slots=8, cuda_graph=True, **options):
    """One engine run over ``stream`` (``options``: more engine options);
    returns the engine, the handles and the counters of the three kernels,
    zeroed just before the run."""
    engine = ServingEngine(model, num_slots=num_slots, cuda_graph=cuda_graph, **SERVING_MODES[mode][0], **options)
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
    engine.run_until_drained()
    torch.cuda.synchronize()
    return engine, handles, {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}


def graph_vs_eager(model, mode, stream):
    """The same stream through a graph engine and an eager one, ticked in
    turns: the first decoding tick's next logits (bf16: within 0.03 x the
    eager tensor's RMS, over the slots that decode) and every greedy token
    (identical). Returns the error and its limit, the greedy tokens, and
    each engine's mean ms a decoding tick."""
    engines = [ServingEngine(model, num_slots=8, cuda_graph=graph, **SERVING_MODES[mode][0]) for graph in (True, False)]
    handles = [[e.submit(p, config=c, seed=seed) for p, c, seed in stream] for e in engines]
    first = None
    work = [True, True]
    while any(work):
        work = [e.step() if w else False for e, w in zip(engines, work)]
        if first is None and engines[1].metrics.decode_steps:
            active = engines[1]._state.active
            got, want = (e._state.next_logits[active].float() for e in engines)
            first = ((got - want).abs().max().item(), BF16_RMS_FRACTION * want.pow(2).mean().sqrt().item())
    if engines[0].metrics.decode_steps != engines[1].metrics.decode_steps:
        raise AssertionError(f"serving {mode}: graph and eager engines ticked apart")
    greedy = [[h.result().tolist() for h in hs if not h.config.do_sample] for hs in handles]
    return first, greedy, [1e3 * e.metrics.snapshot()["decode_step_s"]["mean"] for e in engines]


def serving():
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    totals = {"B2": 0, "B3": 0, "B4": 0}
    for mode, (options, ca_kernel) in SERVING_MODES.items():
        stream = chat_stream(cfg) if mode == "paged_chunked_prefix" else request_stream(cfg)
        serve(model, mode, stream[:3])  # warm-up: cuBLAS handles, the kernel libraries, the allocator
        runs, greedy = [], []
        for _ in range(SERVING_REPEATS):
            engine, handles, counts = serve(model, mode, stream)
            snap = engine.metrics.snapshot()
            ticks = snap["decode_steps"]
            if engine.decode_compilations != 1 or engine.total_compilations != 1 or engine.graph_replays != ticks:
                raise AssertionError(f"serving {mode}: {engine.total_compilations} captures, {engine.graph_replays} "
                                     f"replays for {ticks} decode ticks (one capture, one replay a tick)")
            expected = {"B2": ticks * (layers + (ca_kernel is dk)), "B3": ticks * (ca_kernel is pk),
                        "B4": ticks * (ca_kernel is rk)}
            if counts != expected:
                raise AssertionError(f"serving {mode}: launches {counts}, expected {expected} for {ticks} ticks")
            if not all(h.ok and len(h.output_ids) == h.config.max_new_tokens for h in handles):
                raise AssertionError(f"serving {mode}: a request did not finish with its max_new_tokens")
            if not all(0 <= t < cfg.vocab_size for h in handles for t in h.output_ids):
                raise AssertionError(f"serving {mode}: token ids outside the vocabulary")
            for k in totals:
                totals[k] += counts[k]
            greedy.append([h.result().tolist() for h in handles if not h.config.do_sample])
            pool, cache, chunks = snap["page_pool"], snap["prefix_cache"], snap["chunked_prefill"]
            runs.append(dict(tokens_per_s=snap["decode_tokens_per_s"], ms_per_tick=1e3 * snap["decode_step_s"]["mean"],
                             ttft_p50_ms=1e3 * snap["ttft_s"]["p50"], ttft_p95_ms=1e3 * snap["ttft_s"]["p95"],
                             peak_pages=None if pool is None else pool["peak_pages_in_use"], ticks=ticks,
                             tokens=snap["tokens_generated"], replays=engine.graph_replays,
                             captures=engine.total_compilations,
                             dispatching_ticks=None if snap["ragged_tick"] is None else snap["ragged_tick"]["ticks"],
                             prefix_hits=None if cache is None else cache["hits"],
                             peak_shared_pages_in_use=None if cache is None else cache["peak_shared_pages_in_use"],
                             chunks=None if chunks is None else chunks["chunks_dispatched"]))
        identical = all(g == greedy[0] for g in greedy)
        (first_err, first_limit), (graph_greedy, eager_greedy), tick_ms = graph_vs_eager(
            model, mode, stream[:GRAPH_VS_EAGER_REQUESTS])
        # the prefix's greedy requests come first among the full run's
        graph_same = graph_greedy == eager_greedy == greedy[0][:len(graph_greedy)]
        emit(phase="serving", mode=mode, options=options, slots=8, requests=len(stream), repeats=SERVING_REPEATS,
             launches_per_run=counts, launches_per_tick={k: v / runs[-1]["ticks"] for k, v in counts.items()},
             greedy_tokens_identical_across_repeats=identical,
             graph_vs_eager={"requests": GRAPH_VS_EAGER_REQUESTS, "greedy_tokens_identical": graph_same,
                             "first_tick_max_logit_err": first_err, "limit": first_limit,
                             "ms_per_tick_in_turns": {"graph": tick_ms[0], "eager": tick_ms[1]}},
             **{k: spread([r[k] for r in runs]) if runs[0][k] is not None else None
                for k in ("tokens_per_s", "ms_per_tick", "ttft_p50_ms", "ttft_p95_ms", "peak_pages", "ticks",
                          "replays", "captures", "dispatching_ticks", "prefix_hits", "peak_shared_pages_in_use",
                          "chunks")},
             tokens=runs[-1]["tokens"])
        if not identical:
            raise AssertionError(f"serving {mode}: greedy tokens differ between repeats")
        if not graph_same or not first_err <= first_limit:
            raise AssertionError(f"serving {mode}: the graph and eager engines disagree: greedy tokens identical "
                                 f"{graph_same}, first decoding tick's logits {first_err} (limit {first_limit})")
        if mode == "paged_chunked_prefix" and not all(r["prefix_hits"] > 0 and r["chunks"] > 0 for r in runs):
            raise AssertionError(f"serving {mode}: no prefix hit or no chunk: {runs}")
    del model
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------- phase 5b: serving lifecycle
LIFECYCLE_MODES = ("dense", "paged_fp", "paged_int4")
LIFECYCLE_PAGES = 41  # five full-window reservations (8 pages of 128) plus the trash page
LIFECYCLE_LOW = 24  # requests 0-23 at class 0 at the start; 24-31 at class 1, one every 4 ticks from tick 8
LIFECYCLE_ARRIVALS = {8 + 4 * j: LIFECYCLE_LOW + j for j in range(8)}
LIFECYCLE_EVENT_TICK = 12  # the quarantine's poisoned tick; drain() starts after it
DEADLINE_REQUESTS = range(4, 8)  # deadline_s 0.5 in the deadline run, a 1.0 s stall at tick 10


def lifecycle_options(mode, contended):
    options = dict(SERVING_MODES[mode][0])
    if contended and mode != "dense":
        options["num_kv_pages"] = LIFECYCLE_PAGES
    return options


def _card_state_finite(engine) -> bool:
    c = engine._cache
    pool = [c.ca.kp, c.ca.vp, c.ca.k_scale, c.ca.v_scale] if engine.paged else [c.ca.k, c.ca.v]
    return all(t is None or bool(t.float().isfinite().all())
               for t in pool + [c.sa.k, c.sa.v, engine._state.next_logits])


def _quarantine_target(engine):
    """A sampled request decoding now, the least likely to be preempted
    this tick: a class-1 one or one out of budget first, then the smallest
    reservation, then the oldest."""
    running = [(s, r) for s, r in engine.scheduler.occupied()
               if s not in engine._prefilling and r.config.do_sample and r.output_ids]
    running.sort(key=lambda sr: (sr[1].priority == 0 and sr[1].preemptions < engine.max_preemptions,
                                 len(engine._slot_pages[sr[0]] or []) if engine.paged else 0, sr[1].request_id))
    if not running:
        raise AssertionError("serving_lifecycle: no sampled request decoding to poison")
    return running[0][1]


def serve_lifecycle(model, mode, stream, contended=True, event=None):
    """One engine run over ``stream`` with the counters zeroed just before.
    Uncontended: every request at class 0 at once, the default pool.
    Contended: requests 0-23 at class 0 at once and 24-31 at class 1 at
    LIFECYCLE_ARRIVALS' ticks, with LIFECYCLE_PAGES pages on paged pools,
    and ``event`` None, "deadline", "quarantine" or "drain". Returns the
    engine, the handles, the launch counts and what the event saw."""
    engine = ServingEngine(model, num_slots=8, **lifecycle_options(mode, contended))
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    handles = [None] * len(stream)

    def submit(i, priority=0):
        prompt, config, seed = stream[i]
        deadline = 0.5 if event == "deadline" and i in DEADLINE_REQUESTS else None
        handles[i] = engine.submit(prompt, config=config, seed=seed, priority=priority, deadline_s=deadline)

    for i in range(LIFECYCLE_LOW if contended else len(stream)):
        submit(i)
    seen = {}
    if event == "deadline":
        FAULTS.arm("serving.deadline", after=9, times=1, value=1.0)
    try:
        tick, work = 0, True
        while work or any(t > tick for t in LIFECYCLE_ARRIVALS) and contended:
            tick += 1
            if contended and tick in LIFECYCLE_ARRIVALS:
                submit(LIFECYCLE_ARRIVALS[tick], priority=1)
            if event == "quarantine" and tick == LIFECYCLE_EVENT_TICK:
                target = _quarantine_target(engine)
                seen["target"] = target.request_id
                FAULTS.arm("serving.nan", slot=target.slot)
            work = engine.step()
            if event == "quarantine" and tick == LIFECYCLE_EVENT_TICK:
                FAULTS.disarm("serving.nan")
            if event == "drain" and tick == LIFECYCLE_EVENT_TICK:
                seen["at_drain"] = {h.request_id: h.status.value for h in handles if h is not None}
                engine.drain()
                for later in sorted(t for t in LIFECYCLE_ARRIVALS if t > tick):
                    submit(LIFECYCLE_ARRIVALS[later], priority=1)
                break
    finally:
        FAULTS.reset()
    torch.cuda.synchronize()
    return engine, handles, {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}, seen


def _check_captures_and_launches(label, engine, counts, ca_kernel, layers):
    ticks = engine.metrics.snapshot()["decode_steps"]
    if engine.decode_compilations != 1 or engine.total_compilations != 1 or engine.graph_replays != ticks:
        raise AssertionError(f"{label}: {engine.total_compilations} captures, "
                             f"{engine.graph_replays} replays for {ticks} decode ticks")
    expected = {"B2": ticks * (layers + (ca_kernel is dk)), "B3": ticks * (ca_kernel is pk),
                "B4": ticks * (ca_kernel is rk)}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected} for {ticks} ticks")


def _prefix_of(handle, tokens) -> bool:
    return handle.result().tolist() == tokens[:len(handle.output_ids)]


def chunk_lane_numerics(model, stream):
    """Whether a chunk projection's rows depend on how many lanes the call
    holds (cuBLAS picks its algorithm by shape), and what the engine's fixed
    shape costs: lane 0's K/V rows at m = 2, 3, 5, 8 lanes of the
    full-window cap in one call against m = 1, and the card's ms of one
    lane, of the 8 lanes in one call (the descriptor's fixed shape, which
    the engine runs) and of 8 calls of one lane each."""
    cap = model.max_seq_len
    ids = torch.tensor([(p + [0] * cap)[:cap] for p, _, _ in stream[:8]], device=DEVICE)
    pos = torch.arange(cap, device=DEVICE)[None].expand(8, cap)
    latent = pos >= cap - model.max_latents
    call = lambda lo, hi: model.prefill_chunk_kv(ids[lo:hi], pos[lo:hi], latent[lo:hi])
    one = call(0, 1)
    differ = [m for m in (2, 3, 5, 8) if not all(torch.equal(a[:1], b) for a, b in zip(call(0, m), one))]
    return dict(lane_counts_whose_rows_differ_from_one=differ, ms_1_lane=time_ms(lambda: call(0, 1), reps=10),
                ms_8_lanes_one_call=time_ms(lambda: call(0, 8), reps=10),
                ms_8_lanes_one_call_each=time_ms(lambda: [call(i, i + 1) for i in range(8)], reps=10))


def serving_lifecycle():
    """The flagship in bf16 with 8 slots over request_stream: in dense,
    paged_fp (41 pages) and paged_int4 (41 pages), the contended run
    (classes, arrivals, preemption and replay) against the uncontended
    one; then in paged_fp a deadline run, a quarantine run and a drain
    run. Every check raises on failure. Returns the launch counts."""
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    stream = request_stream(cfg)
    totals = {"B2": 0, "B3": 0, "B4": 0}
    with torch.no_grad():
        emit(phase="serving_lifecycle", check="chunk_lanes", **chunk_lane_numerics(model, stream))
    uncontended = {}
    for mode in LIFECYCLE_MODES:
        ca_kernel = SERVING_MODES[mode][1]
        serve(model, mode, stream[:3])  # warm-up
        runs = {}
        for contended in (False, True):
            engine, handles, counts, _ = serve_lifecycle(model, mode, stream, contended)
            _check_captures_and_launches(f"serving_lifecycle {mode} contended={contended}", engine, counts, ca_kernel, layers)
            for k in totals:
                totals[k] += counts[k]
            runs[contended] = (engine, handles)
        tokens = [h.result().tolist() for h in runs[False][1]]
        uncontended[mode] = tokens
        engine, handles = runs[True]
        snap, base = engine.metrics.snapshot(), runs[False][0].metrics.snapshot()
        finished = all(h.ok and len(h.output_ids) == h.config.max_new_tokens for h in handles)
        identical = [h.result().tolist() for h in handles] == tokens
        sampled_identical = all(h.result().tolist() == t for h, t in zip(handles, tokens) if h.config.do_sample)
        pages_back = snap["page_pool"] is None or snap["page_pool"]["pages_in_use"] == 0
        emit(phase="serving_lifecycle", mode=mode, options=lifecycle_options(mode, True), slots=8,
             requests=len(stream), preemptions=snap["preemptions"], preempted_replays=snap["preempted_replays"],
             preempted_requests=sum(h.preemptions > 0 for h in handles),
             ticks={"contended": snap["decode_steps"], "uncontended": base["decode_steps"]},
             ms_per_tick={"contended": 1e3 * snap["decode_step_s"]["mean"],
                          "uncontended": 1e3 * base["decode_step_s"]["mean"]},
             ttft_ms={"contended": {k: 1e3 * v for k, v in snap["ttft_s"].items() if k in ("p50", "p95")},
                      "uncontended": {k: 1e3 * v for k, v in base["ttft_s"].items() if k in ("p50", "p95")}},
             queue_wait_by_priority_ms={c: {k: 1e3 * v for k, v in q.items()}
                                        for c, q in snap["queue_wait_by_priority"].items()},
             timed_out=snap["timed_out"], failed=snap["failed"], rejected=snap["rejected"],
             tokens_generated=snap["tokens_generated"], all_finished_with_max_new_tokens=finished,
             tokens_identical_to_uncontended=identical, sampled_tokens_identical=sampled_identical,
             pages_in_use_after=None if snap["page_pool"] is None else snap["page_pool"]["pages_in_use"],
             launches=counts, captures=engine.total_compilations, replays=engine.graph_replays)
        if not snap["preemptions"] or snap["preempted_replays"] != snap["preemptions"]:
            raise AssertionError(f"serving_lifecycle {mode}: {snap['preemptions']} preemptions, "
                                 f"{snap['preempted_replays']} replays")
        if not (finished and identical and pages_back):
            raise AssertionError(f"serving_lifecycle {mode}: all finished {finished}, tokens identical to the "
                                 f"uncontended run {identical}, pages back {pages_back}")

    mode, tokens = "paged_fp", uncontended["paged_fp"]
    ca_kernel = SERVING_MODES[mode][1]
    others_identical = lambda handles, skip: all(h.ok and h.result().tolist() == t for i, (h, t) in
                                                 enumerate(zip(handles, tokens)) if i not in skip)
    for event in ("deadline", "quarantine", "drain"):
        engine, handles, counts, seen = serve_lifecycle(model, mode, stream, True, event)
        _check_captures_and_launches(f"serving_lifecycle {mode} {event}", engine, counts, ca_kernel, layers)
        for k in totals:
            totals[k] += counts[k]
        snap = engine.metrics.snapshot()
        record = dict(timed_out=snap["timed_out"], failed=snap["failed"], rejected=snap["rejected"],
                      preemptions=snap["preemptions"], ticks=snap["decode_steps"])
        if event == "deadline":
            doomed = {i: handles[i] for i in DEADLINE_REQUESTS}
            ok = all((h.status is RequestStatus.TIMED_OUT and _prefix_of(h, tokens[i]))
                     or (h.ok and h.result().tolist() == tokens[i]) for i, h in doomed.items())
            ok = ok and others_identical(handles, set(DEADLINE_REQUESTS))
            record.update(deadline_statuses={i: h.status.value for i, h in doomed.items()},
                          tokens_before_expiry={i: len(h.output_ids) for i, h in doomed.items()})
        elif event == "quarantine":
            target = handles[seen["target"]]
            finite = _card_state_finite(engine)
            ok = (target.status is RequestStatus.FAILED and target.finish_reason == "nonfinite_logits"
                  and _prefix_of(target, tokens[seen["target"]]) and finite
                  and others_identical(handles, {seen["target"]}))
            record.update(target=seen["target"], target_status=target.status.value,
                          target_tokens=len(target.output_ids), pool_finite=finite)
        else:
            queued = {i for i, status in seen["at_drain"].items() if status == "queued"}
            later = set(range(len(stream))) - set(seen["at_drain"])
            rejected = {i for i, h in enumerate(handles) if h.finish_reason == "draining"}
            ok = rejected == queued | later and others_identical(handles, rejected)
            record.update(queued_at_drain=len(queued), preempted_at_drain=sum(
                status == "preempted" for status in seen["at_drain"].values()), submitted_after=len(later))
        emit(phase="serving_lifecycle", mode=mode, event=event, ok=ok, captures=engine.total_compilations,
             **record)
        if not ok:
            raise AssertionError(f"serving_lifecycle {mode} {event}: {record}")
    del model
    torch.cuda.empty_cache()
    return totals


# ------------------------------------ phase 5c: journal, recovery, weight serving
JOURNAL_MODES = ("dense", "paged_fp", "paged_int4")
# the snapshot counters the JSONL stream's last snapshot must repeat
SNAPSHOT_COUNTERS = ("requests_submitted", "requests_admitted", "requests_finished", "rejected", "timed_out",
                     "failed", "tokens_generated", "decode_steps", "prefills", "preemptions", "preempted_replays",
                     "queue_depth", "journal", "page_pool", "weight_serving", "chunked_prefill", "prefix_cache")
RECOVERY_MODE = "paged_fp"
RECOVERY_KILL_TICK = 40  # the parent SIGKILLs the journal child after this tick


def _serving_model(param_dtype=torch.bfloat16, seed=SEED):
    cfg = flagship_455m_config()
    return cfg, CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, param_dtype=param_dtype, seed=seed)


def _run_stats(snap):
    return dict(ms_per_tick=1e3 * snap["decode_step_s"]["mean"], tokens_per_s=snap["decode_tokens_per_s"],
                ttft_p50_ms=1e3 * snap["ttft_s"]["p50"], ttft_p95_ms=1e3 * snap["ttft_s"]["p95"],
                ticks=snap["decode_steps"])


def serving_journal():
    """The flagship in bf16, 8 slots, request_stream in JOURNAL_MODES, in
    turns: no journal, the metrics' JSONL stream alone, the
    journal (fsync "accept") with the stream, and no journal again: the
    same tokens, the stream's submits equal to its terminal events and to
    finished + rejected + timed out + failed, and its last snapshot equal
    to ``metrics.snapshot()`` in every counter; ms a tick and TTFT of each
    run, and the journal's records, segments, bytes and fsyncs. Returns the
    launch counts, the model, the stream and paged_fp's tokens."""
    cfg, model = _serving_model()
    layers = cfg.num_self_attention_layers
    stream = request_stream(cfg)
    totals = {"B2": 0, "B3": 0, "B4": 0}
    reference = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in JOURNAL_MODES:
            ca_kernel = SERVING_MODES[mode][1]
            serve(model, mode, stream[:3])  # warm-up
            runs = {}
            for arm in ("off", "jsonl", "journal", "off_again"):
                extra = {}
                if arm in ("jsonl", "journal"):
                    extra["metrics_jsonl"] = os.path.join(tmp, f"{mode}-{arm}.jsonl")
                if arm == "journal":
                    extra["journal"] = os.path.join(tmp, mode)
                engine, handles, counts = serve(model, mode, stream, **extra)
                _check_captures_and_launches(f"serving_journal {mode} {arm}", engine, counts, ca_kernel, layers)
                for k in totals:
                    totals[k] += counts[k]
                runs[arm] = (engine, handles)
                if arm == "jsonl":
                    engine.close()
            tokens = [h.result().tolist() for h in runs["off"][1]]
            reference[mode] = tokens
            identical = all([h.result().tolist() for h in runs[arm][1]] == tokens
                            for arm in ("jsonl", "journal", "off_again"))
            engine = runs["journal"][0]
            snap = engine.metrics.write_snapshot()
            engine.close()
            got = load_metrics_jsonl(os.path.join(tmp, f"{mode}-journal.jsonl"))
            last = got["snapshots"][-1]
            events = [e["event"] for e in got["events"]]
            terminal = events.count("finish") + events.count("reject")
            counts_agree = (events.count("submit") == terminal == last["requests_finished"] + last["rejected"]
                            + last["timed_out"] + last["failed"] == last["requests_submitted"] == len(stream))
            snapshot_agrees = all(last[k] == snap[k] for k in SNAPSHOT_COUNTERS)
            segments = sorted(os.listdir(os.path.join(tmp, mode)))
            journal = snap["journal"]
            emit(phase="serving_journal", mode=mode, slots=8, requests=len(stream), fsync=journal["fsync"],
                 tokens_identical_to_journal_off=identical, jsonl_events=len(events),
                 jsonl_counts_consistent=counts_agree, jsonl_last_snapshot_equals_snapshot=snapshot_agrees,
                 **{arm: _run_stats(snap if arm == "journal" else runs[arm][0].metrics.snapshot())
                    for arm in ("off", "jsonl", "journal", "off_again")},
                 records=journal["records_appended"], segments=len(segments),
                 bytes=journal["bytes_written"], bytes_on_disk=sum(
                     os.path.getsize(os.path.join(tmp, mode, n)) for n in segments),
                 fsyncs=journal["fsyncs"], compactions=journal["compactions"],
                 live_sessions_after=journal["live_sessions"], captures=engine.total_compilations)
            if not (identical and counts_agree and snapshot_agrees and journal["live_sessions"] == 0):
                raise AssertionError(f"serving_journal {mode}: tokens identical {identical}, JSONL counts "
                                     f"{counts_agree}, last snapshot {snapshot_agrees}, live sessions "
                                     f"{journal['live_sessions']}")
    return totals, model, stream, reference[RECOVERY_MODE]


def _param_checksum(model) -> list:
    """Each parameter's float64 sum, in order: equal lists, the same weights."""
    return [float(p.detach().double().sum()) for p in model.parameters()]


def journal_child(path):
    """The journal child (``python3 chip_smoke.py --journal-child <dir>``):
    the flagship in bf16 from SEED, serving request_stream in paged_fp with
    the journal at ``path``; it prints its parameters' checksum, then one
    line a tick (the tokens of requests that ended), until it is killed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _serving_model()
    stream = request_stream(cfg)
    print(json.dumps({"checksum": _param_checksum(model)}), flush=True)
    engine = ServingEngine(model, num_slots=8, journal=path, **SERVING_MODES[RECOVERY_MODE][0])
    handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
    tick, done, work = 0, set(), True
    while work:
        work = engine.step()
        tick += 1
        ended = {h.request_id: h.result().tolist() for h in handles if h.done and h.request_id not in done}
        done |= set(ended)
        print(json.dumps({"tick": tick, "ended": ended}), flush=True)
    return 0


def serving_recovery(model, stream, reference):
    """A child process serves request_stream in paged_fp with the journal and
    is SIGKILLed after RECOVERY_KILL_TICK ticks with greedy and sampled
    requests in flight; this process (the same seeded weights, checked by
    checksum) recovers the journal on the card and drains it. Every
    request's tokens, the child's ended ones and the recovered ones, must
    equal the uninterrupted run's; one capture. Returns the launch counts."""
    ca_kernel = SERVING_MODES[RECOVERY_MODE][1]
    layers = model.config.num_self_attention_layers
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal")
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--journal-child", path],
                                 stdout=subprocess.PIPE, text=True)
        ended, checksum, tick = {}, None, 0
        try:
            for line in child.stdout:
                record = json.loads(line)
                if "checksum" in record:
                    checksum = record["checksum"]
                    continue
                tick = record["tick"]
                ended.update({int(k): v for k, v in record["ended"].items()})
                if tick >= RECOVERY_KILL_TICK:
                    child.send_signal(signal.SIGKILL)
                    break
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
            child.stdout.close()
        child_s = time.perf_counter() - t0
        if tick < RECOVERY_KILL_TICK or child.returncode != -signal.SIGKILL:
            raise AssertionError(f"serving_recovery: the child stopped at tick {tick} with code {child.returncode}")
        same_weights = checksum == _param_checksum(model)
        state = read_journal(path)
        in_flight = [s for s in state.sessions if s.admitted]
        mixed = {bool(s.config["do_sample"]) for s in in_flight if s.emitted} == {False, True}
        t0 = time.perf_counter()
        engine, info = ServingEngine.recover(model, path, num_slots=8, metrics_jsonl=os.path.join(tmp, "m.jsonl"),
                                             **SERVING_MODES[RECOVERY_MODE][0])
        recover_ms = 1e3 * (time.perf_counter() - t0)  # the engine's construction and capture included
        torch.cuda.synchronize()
        dk.launches = pk.launches = rk.launches = 0
        engine.run_until_drained()
        torch.cuda.synchronize()
        counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
        _check_captures_and_launches("serving_recovery", engine, counts, ca_kernel, layers)
        recovered = {s.rid: h.result().tolist() for s, h in zip(state.sessions, info["handles"])}
        engine.close()
        event = next(e for e in load_metrics_jsonl(os.path.join(tmp, "m.jsonl"))["events"] if e["event"] == "recovery")
    tokens = {**ended, **recovered}
    wrong = [i for i in range(len(stream)) if tokens.get(i) != reference[i]]
    sampled = [i for i, (_p, c, _s) in enumerate(stream) if c.do_sample]
    emit(phase="serving_recovery", mode=RECOVERY_MODE, killed_after_tick=tick, signal="SIGKILL",
         same_weights=same_weights, child_s=child_s, ended_before_kill=len(ended), sessions=info["sessions"],
         in_flight=info["in_flight"], in_flight_greedy_and_sampled=mixed, replayed_tokens=info["replayed_tokens"],
         truncated=info["truncated"], dropped_records=info["dropped_records"], records=info["records"],
         recovery_event={k: v for k, v in event.items() if k != "ts"}, recover_ms=recover_ms,
         ticks_to_drain=engine.metrics.snapshot()["decode_steps"], captures=engine.total_compilations,
         all_tokens_identical=not wrong, sampled_identical=not [i for i in wrong if i in sampled],
         launches=counts)
    if not (same_weights and mixed and not wrong and len(tokens) == len(stream)):
        raise AssertionError(f"serving_recovery: same weights {same_weights}, greedy and sampled in flight {mixed}, "
                             f"requests with other tokens {wrong}, requests accounted {len(tokens)}")
    return counts


# ------------------------------------------------- phase 5d: the serving router
ROUTER_MODES = ("dense", "paged_fp", "paged_int4")
ROUTER_REPLICAS = 2  # each of 8 slots: the single engine's geometry, so its GEMMs see the same rows
ROUTER_EVENT_TICK = 40  # replica 1 crashes, is first poisoned or first stalls at this router tick
ROUTER_COOLDOWN = 4  # breaker_cooldown_ticks (the router's default): half-open and closed 4 ticks later
ROUTER_SLOW_TICK_S = 2.0  # slow_tick_threshold_s of the stall run, far above a healthy replica tick
ROUTER_STALL_S = 3.0  # replica.stall's sleep at two ticks in a row
ROUTER_RECOVERY_MODE = "paged_fp"
ROUTER_KILL_TICK = 40  # the parent SIGKILLs the router child after this tick


def drive_ticks(step, handles, at_tick=None):
    """Step until ``step()`` reports no work, the card synced at both ends;
    ``at_tick(t)`` gives a context (a fault armed) for tick t. Returns the
    ticks, the wall seconds and each request's time to first token on the
    host (submit to the end of the tick that delivered it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = [None] * len(handles)
    ticks, work = 0, True
    while work:
        ticks += 1
        with at_tick(ticks) if at_tick else contextlib.nullcontext():
            work = step()
        now = time.perf_counter()
        for i, h in enumerate(handles):
            if first[i] is None and h.output_ids:
                first[i] = now - h.submitted_at
    torch.cuda.synchronize()
    return ticks, time.perf_counter() - t0, first


def _fleet_stats(ticks, wall, first, tokens):
    p50, p95 = np.percentile([f for f in first if f is not None], [50, 95])
    return dict(ticks=ticks, wall_s=wall, ms_per_tick=1e3 * wall / ticks, tokens=tokens, tokens_per_s=tokens / wall,
                ttft_p50_ms=1e3 * float(p50), ttft_p95_ms=1e3 * float(p95))


def _at(tick_faults):
    """``at_tick`` for ``drive_ticks``: {tick: (point, arming)} armed for that
    tick alone."""
    return lambda t: armed(tick_faults[t][0], **tick_faults[t][1]) if t in tick_faults else contextlib.nullcontext()


def serve_router(model, mode, stream, tick_faults=None, **options):
    """One router run over ``stream`` with ROUTER_REPLICAS replicas of 8
    slots (``options``: more router options), the counters zeroed just
    before; returns the router, its handles, the counts and its fleet
    stats."""
    router = ServingRouter(model, num_replicas=ROUTER_REPLICAS, num_slots=8, **SERVING_MODES[mode][0], **options)
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    handles = [router.submit(p, config=c, seed=seed) for p, c, seed in stream]
    ticks, wall, first = drive_ticks(router.step, handles, _at(tick_faults) if tick_faults else None)
    counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
    tokens = sum(r.engine.metrics.tokens_generated for r in router.replicas)
    return router, handles, counts, _fleet_stats(ticks, wall, first, tokens)


def _check_router_captures_and_launches(label, router, counts, ca_kernel, layers):
    """One capture a replica, a replay a decode tick, and the kernels' counts
    equal to the replays times the launches a replay makes."""
    replays = 0
    for r in router.replicas:
        engine, ticks = r.engine, r.engine.metrics.snapshot()["decode_steps"]
        if engine.decode_compilations != 1 or engine.total_compilations != 1 or engine.graph_replays != ticks:
            raise AssertionError(f"{label} r{r.rid}: {engine.total_compilations} captures, {engine.graph_replays} "
                                 f"replays for {ticks} decode ticks")
        replays += ticks
    expected = {"B2": replays * (layers + (ca_kernel is dk)), "B3": replays * (ca_kernel is pk),
                "B4": replays * (ca_kernel is rk)}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected} for {replays} replays")


def _breaker_ticks(path):
    return [(e["replica"], e["transition"], e["tick"]) for e in load_metrics_jsonl(path)["events"]
            if e["event"] == "breaker"]


def _cycle(opened, replica=1):
    """The breaker events of ``replica`` opening at ``opened``."""
    return [(replica, "closed->open", opened), (replica, "open->half_open", opened + ROUTER_COOLDOWN),
            (replica, "half_open->closed", opened + ROUTER_COOLDOWN)]


def _moved(handles):
    """The failed-over requests, greedy and sampled."""
    moved = [h for h in handles if h.failovers]
    return dict(greedy=sum(not h.config.do_sample for h in moved), sampled=sum(h.config.do_sample for h in moved))


def _settle(router):
    """Tick an idle fleet until every breaker is closed again (at most a
    cooldown and a probe)."""
    for _ in range(2 * ROUTER_COOLDOWN):
        if all(r.breaker == BREAKER_CLOSED for r in router.replicas):
            return
        router.step()


def serving_router(model, stream):
    """The flagship in bf16 over request_stream through ServingRouter with two
    replicas of 8 slots, in dense, paged_fp and paged_int4: a single 8-slot
    engine, the fault-free router and a router whose replica 1 crashes at
    ROUTER_EVENT_TICK, each timed on the host (ms a tick, tokens/s, TTFT);
    every request's tokens equal the single engine's. Then in paged_fp:
    shedding after warm-up, NaN containment (serving.nan on replica 1 at two
    ticks, nan_failures_to_open 2), a stall of replica 0 (3 s at two ticks
    against a 2 s threshold) and recovery after a SIGKILL of a journaled
    router child. The stream alternates greedy and sampled requests and
    dispatch by load alternates replicas, so replica 0 serves the greedy
    half and replica 1 the sampled half: the crash and the NaN move sampled
    requests, the stall greedy ones. Returns the launch counts, the single
    engine's tokens by mode, and paged_fp's single-engine and fault-free
    router stats."""
    layers = model.config.num_self_attention_layers
    totals = {"B2": 0, "B3": 0, "B4": 0}
    process_inputs = {}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    references = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ROUTER_MODES:
            ca_kernel = SERVING_MODES[mode][1]
            serve(model, mode, stream[:3])  # warm-up
            engine = ServingEngine(model, num_slots=8, **SERVING_MODES[mode][0])
            torch.cuda.synchronize()
            dk.launches = pk.launches = rk.launches = 0
            handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
            single = _fleet_stats(*drive_ticks(engine.step, handles), engine.metrics.tokens_generated)
            counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
            _check_captures_and_launches(f"serving_router {mode} single engine", engine, counts, ca_kernel, layers)
            add(counts)
            reference = references[mode] = [h.result().tolist() for h in handles]
            del engine, handles

            router, handles, counts, fleet = serve_router(model, mode, stream)
            _check_router_captures_and_launches(f"serving_router {mode}", router, counts, ca_kernel, layers)
            add(counts)
            identical = [h.result().tolist() for h in handles] == reference and all(h.ok for h in handles)
            spread = [sum(h.replica == i for h in handles) for i in range(ROUTER_REPLICAS)]
            shed = None
            if mode == ROUTER_RECOVERY_MODE:
                process_inputs = dict(single_engine=single, router_in_process=fleet)
                # warm: every replica's latency window is full
                estimate = router._estimate_completion_s(128)
                doomed = router.submit(stream[0][0], max_new_tokens=128, deadline_s=estimate / 10)
                feasible = router.submit(stream[0][0], max_new_tokens=16, deadline_s=600.0)
                router.run_until_drained()
                shed = dict(estimate_s_for_128_tokens=estimate, infeasible_deadline_s=estimate / 10,
                            infeasible=doomed.finish_reason, feasible=feasible.status.value,
                            feasible_tokens_are_the_streams=feasible.result().tolist() == reference[0][:16])
            router.close()
            del router, handles

            path = os.path.join(tmp, f"{mode}-crash.jsonl")
            router, handles, counts, crash = serve_router(
                model, mode, stream, {ROUTER_EVENT_TICK: ("replica.crash", dict(slot=1))}, metrics_jsonl=path)
            _settle(router)
            _check_router_captures_and_launches(f"serving_router {mode} crash", router, counts, ca_kernel, layers)
            add(counts)
            snap = router.snapshot()
            router.close()
            events = load_metrics_jsonl(path)["events"]
            failovers = [e for e in events if e["event"] == "failover"]
            crash.update(failovers=len(failovers), replayed_tokens=sum(e["emitted_tokens"] for e in failovers),
                         breaker=_breaker_ticks(path), failovers_in_snapshot=snap["failovers"],
                         failed_over=_moved(handles))
            crash_identical = [h.result().tolist() for h in handles] == reference and all(h.ok for h in handles)
            del router, handles
            emit(phase="serving_router", mode=mode, replicas=ROUTER_REPLICAS, slots_per_replica=8,
                 requests=len(stream), single_engine=single, router=fleet, requests_per_replica=spread,
                 ms_per_tick_router_over_single=fleet["ms_per_tick"] / single["ms_per_tick"],
                 tokens_per_s_router_over_single=fleet["tokens_per_s"] / single["tokens_per_s"],
                 tokens_identical_to_single_engine=identical, shed=shed, crash_at_tick=ROUTER_EVENT_TICK,
                 crash=crash, crash_tokens_identical=crash_identical,
                 crash_ticks_over_fault_free=crash["ticks"] / fleet["ticks"], captures_per_replica=1,
                 launches=counts)
            ok = (identical and crash_identical and failovers and crash["breaker"] == _cycle(ROUTER_EVENT_TICK)
                  and snap["failovers"] == len(failovers) and min(spread) > 0)
            if shed is not None:
                ok = (ok and shed["infeasible"] == "shed_infeasible" and shed["feasible"] == "finished"
                      and shed["feasible_tokens_are_the_streams"])
            if not ok:
                raise AssertionError(f"serving_router {mode}: tokens identical {identical}, after the crash "
                                     f"{crash_identical}, failovers {crash['failovers']} (snapshot "
                                     f"{snap['failovers']}), breaker {crash['breaker']}, spread {spread}, shed {shed}")

        mode, reference = ROUTER_RECOVERY_MODE, references[ROUTER_RECOVERY_MODE]
        ca_kernel = SERVING_MODES[mode][1]
        for event, replica, faults_at, options in (
                ("nan", 1, {t: ("serving.nan", dict(after=1)) for t in (ROUTER_EVENT_TICK, ROUTER_EVENT_TICK + 1)},
                 dict(nan_failures_to_open=2)),
                ("stall", 0, {t: ("replica.stall", dict(slot=0, value=ROUTER_STALL_S))
                              for t in (ROUTER_EVENT_TICK, ROUTER_EVENT_TICK + 1)},
                 dict(slow_tick_threshold_s=ROUTER_SLOW_TICK_S, slow_ticks_to_open=2))):
            # serving.nan with after=1: replica 0 ticks first and takes the
            # skipped hit, replica 1's first occupied slot is poisoned
            path = os.path.join(tmp, f"{mode}-{event}.jsonl")
            router, handles, counts, stats = serve_router(model, mode, stream, faults_at, metrics_jsonl=path,
                                                          **options)
            _settle(router)
            _check_router_captures_and_launches(f"serving_router {mode} {event}", router, counts, ca_kernel, layers)
            add(counts)
            router.close()
            breaker = _breaker_ticks(path)
            poisoned = [i for i, h in enumerate(handles) if h.finish_reason == "nonfinite_logits"]
            others = all(h.ok and h.result().tolist() == reference[i] for i, h in enumerate(handles)
                         if i not in poisoned)
            prefixes = all(handles[i].result().tolist() == reference[i][:len(handles[i].output_ids)]
                           for i in poisoned)
            emit(phase="serving_router", mode=mode, event=event, breaker=breaker, poisoned=poisoned,
                 failovers=sum(h.failovers for h in handles), failed_over=_moved(handles), others_identical=others,
                 **stats)
            if not (breaker == _cycle(ROUTER_EVENT_TICK + 1, replica) and others and prefixes
                    and len(poisoned) == (2 if event == "nan" else 0)):
                raise AssertionError(f"serving_router {mode} {event}: breaker {breaker}, poisoned {poisoned}, the "
                                     f"others identical {others}, the poisoned prefixes {prefixes}")
            del router, handles
    add(serving_router_recovery(model, stream, references[ROUTER_RECOVERY_MODE]))
    torch.cuda.empty_cache()
    return totals, references, process_inputs


def router_child(template):
    """The router child (``python3 chip_smoke.py --router-child <template>``):
    the flagship in bf16 from SEED, serving request_stream in
    ROUTER_RECOVERY_MODE through two journaled replicas (the journal
    template ``template``); it prints its parameters' checksum, then one
    line a tick (the tokens of requests that ended), until it is killed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _serving_model()
    stream = request_stream(cfg)
    print(json.dumps({"checksum": _param_checksum(model)}), flush=True)
    router = ServingRouter(model, num_replicas=ROUTER_REPLICAS, num_slots=8, journal=template,
                           **SERVING_MODES[ROUTER_RECOVERY_MODE][0])
    handles = [router.submit(p, config=c, seed=seed) for p, c, seed in stream]
    tick, done, work = 0, set(), True
    while work:
        work = router.step()
        tick += 1
        ended = {h.request_id: h.result().tolist() for h in handles if h.done and h.request_id not in done}
        done |= set(ended)
        print(json.dumps({"tick": tick, "ended": ended}), flush=True)
    return 0


def serving_router_recovery(model, stream, reference):
    """A child process serves request_stream through a journaled two-replica
    router and is SIGKILLed after ROUTER_KILL_TICK ticks; this process (the
    same seeded weights) runs ServingRouter.recover on the card and drains.
    Every request's tokens, the child's ended ones and the recovered ones,
    equal the uninterrupted run's; one capture a replica. Returns the
    launch counts."""
    ca_kernel = SERVING_MODES[ROUTER_RECOVERY_MODE][1]
    layers = model.config.num_self_attention_layers
    with tempfile.TemporaryDirectory() as tmp:
        template = os.path.join(tmp, "r{i}")
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--router-child", template],
                                 stdout=subprocess.PIPE, text=True)
        ended, checksum, tick = {}, None, 0
        try:
            for line in child.stdout:
                record = json.loads(line)
                if "checksum" in record:
                    checksum = record["checksum"]
                    continue
                tick = record["tick"]
                ended.update({int(k): v for k, v in record["ended"].items()})
                if tick >= ROUTER_KILL_TICK:
                    child.send_signal(signal.SIGKILL)
                    break
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
            child.stdout.close()
        child_s = time.perf_counter() - t0
        if tick < ROUTER_KILL_TICK or child.returncode != -signal.SIGKILL:
            raise AssertionError(f"serving_router recovery: the child stopped at tick {tick} with code "
                                 f"{child.returncode}")
        same_weights = checksum == _param_checksum(model)
        in_flight = [s for i in range(ROUTER_REPLICAS) for s in read_journal(template.format(i=i)).sessions
                     if s.admitted]
        mixed = {bool(s.config["do_sample"]) for s in in_flight if s.emitted} == {False, True}
        t0 = time.perf_counter()
        router, info = ServingRouter.recover(model, template, num_replicas=ROUTER_REPLICAS, num_slots=8,
                                             **SERVING_MODES[ROUTER_RECOVERY_MODE][0])
        recover_ms = 1e3 * (time.perf_counter() - t0)  # both engines' construction and capture included
        torch.cuda.synchronize()
        dk.launches = pk.launches = rk.launches = 0
        ticks = 0
        while router.step():
            ticks += 1
        torch.cuda.synchronize()
        counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
        _check_router_captures_and_launches("serving_router recovery", router, counts, ca_kernel, layers)
        # the session id is "<fleet>:<the child's request id>", its stream index
        recovered = {int(h.session_id.rsplit(":", 1)[1]): h.result().tolist()
                     for h in info["handles"] + info["parked_handles"]}
        router.close()
    tokens = {**ended, **recovered}
    wrong = [i for i in range(len(stream)) if tokens.get(i) != reference[i]]
    sampled = [i for i, (_p, c, _s) in enumerate(stream) if c.do_sample]
    emit(phase="serving_router", mode=ROUTER_RECOVERY_MODE, event="recovery", killed_after_tick=tick,
         signal="SIGKILL", same_weights=same_weights, child_s=child_s, ended_before_kill=len(ended),
         sessions=info["sessions"], router_parked=info["router_parked"], deduped=info["deduped"],
         in_flight=len(in_flight), in_flight_greedy_and_sampled=mixed, replayed_tokens=info["replayed_tokens"],
         recover_ms=recover_ms, ticks_to_drain=ticks + 1, all_tokens_identical=not wrong,
         sampled_identical=not [i for i in wrong if i in sampled], launches=counts)
    if not (same_weights and mixed and not wrong and len(tokens) == len(stream)):
        raise AssertionError(f"serving_router recovery: same weights {same_weights}, greedy and sampled in flight "
                             f"{mixed}, requests with other tokens {wrong}, requests accounted {len(tokens)}")
    return counts


PROCESS_MODE = "paged_fp"
FLEET_PROCESS_REQUESTS = 16  # the worker fleet's rolling restart serves the stream's first half
# the process replicas' transport: a hung worker's RPC gives up after two
# attempts of 2.5 s, far above a healthy tick's RPC (285 ms at most on an
# H100); a worker's init (its interpreter, CUDA context, the model's build
# and the graph's capture) has minutes
PROCESS_TRANSPORT = dict(rpc_timeout_s=2.5, init_timeout_s=300.0,
                         retry=RetryPolicy(attempts=2, base_delay_s=0.05, max_delay_s=0.1, jitter=0.0))


def process_router(model, transport=PROCESS_TRANSPORT, **options):
    """ROUTER_REPLICAS replicas of 8 slots in PROCESS_MODE, each in a worker
    process; returns the router and the seconds its construction took."""
    t0 = time.perf_counter()
    router = ServingRouter(model, num_replicas=ROUTER_REPLICAS, num_slots=8, replica_mode="process",
                           transport=transport, **SERVING_MODES[PROCESS_MODE][0], **options)
    return router, time.perf_counter() - t0


def _worker_counts(label, router, layers):
    """One capture a live worker, and every worker's B2-B4 launches (the
    replaced ones' from their last reply) equal to its graph replays times a
    replay's launches (paged_fp: B2 once a layer, B3 once). Returns the
    launches summed over the workers."""
    per_replay = {"B2": layers, "B3": 1, "B4": 0}
    captures = [r.engine.decode_compilations for r in router.replicas]
    if captures != [1] * ROUTER_REPLICAS:
        raise AssertionError(f"{label}: captures a worker {captures}")
    totals = {"B2": 0, "B3": 0, "B4": 0}
    for stats in router.retired_transport + [r.engine.transport_stats() for r in router.replicas]:
        want = {k: stats["graph_replays"] * v for k, v in per_replay.items()}
        if stats["launches"] != want:
            raise AssertionError(f"{label}: a worker launched {stats['launches']}, expected {want} for "
                                 f"{stats['graph_replays']} replays")
        for k in totals:
            totals[k] += stats["launches"][k]
    return totals


def _timed_ticks(router, handles, tick_faults=None, watch=None):
    """``drive_ticks`` with each tick's seconds, and ``watch(tick)`` called
    after every tick."""
    seconds = []

    def step():
        t0 = time.perf_counter()
        work = router.step()
        seconds.append(time.perf_counter() - t0)
        if watch is not None:
            watch(len(seconds))
        return work

    ticks, wall, first = drive_ticks(step, handles, _at(tick_faults) if tick_faults else None)
    return ticks, wall, first, seconds


class _FleetBehind:
    """process_router(model, **options) built on a thread of its own, so a
    fleet's workers start while the current fleet serves. The thread's CUDA
    calls (the recipe's copy of the weights to the host) may fall inside a
    decode-graph capture in the caller's thread: the engine captures in the
    thread-local error mode, which they leave valid. ``join()`` waits and
    returns (router, seconds the build took) or raises the build's error."""

    def __init__(self, model, **options):
        self._out = {}
        self._thread = threading.Thread(target=self._build, args=(model, options), name="fleet-behind")
        self._thread.start()

    def _build(self, model, options):
        try:
            self._out["value"] = process_router(model, **options)
        except BaseException as e:  # noqa: BLE001 — raised by join()
            self._out["error"] = e

    def join(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def serving_router_process(model, stream, reference, in_process, fleet=None):
    """The flagship in bf16 over request_stream through ServingRouter with
    two replicas of 8 slots in worker processes (paged_fp; each worker
    builds the model from its recipe and captures its own decode graph).
    (a) fault-free, after a three-request warm-up on the same fleet: every
    request's tokens equal the single engine's (``reference``), ms a tick,
    tokens/s and TTFT against the single engine's and the in-process
    router's of serving_router (``in_process``), RPCs and bytes a tick, RPC
    p50/p95, each worker's peak memory, one capture a worker. (c) on the
    same fleet, the stream again with a SIGSTOP of worker 0 at
    ROUTER_EVENT_TICK: the RPC times out twice, the client kills and reaps
    the worker, the breaker opens, its requests fail over by forced-token
    replay with the same tokens, and a fresh worker takes the probe. (b) a
    real SIGKILL of worker 1 at that tick on a journaled fleet: one respawn
    through its journal, no failover, no breaker transition, the same
    tokens, both workers alive. (d) a device-side
    assert in worker 1 at that tick (transport.worker.device_fault, armed
    in this process for that tick, counted by worker 1's client): the op's
    CUDA error comes
    back, the breaker opens, the requests fail over, worker 1 exits and is
    respawned through its journal at half-open, worker 0 serves on, every
    request's tokens are the same, and both workers and this process still
    launch kernels. (e) after (b), on its journaled fleet: the stream's
    first FLEET_PROCESS_REQUESTS requests with a rolling restart begun after
    FLEET_TICK of them: each worker replaced by a fresh one through its
    journal (the rebuild tick's seconds, each new worker's startup by
    part), no failover, no breaker transition, the same tokens. Each
    worker's B2-B4 launches equal its replays times a replay's. The runs go
    (a), (c), (d), (b), (e): (d)'s fleet is built on a thread while (c)
    runs, (b)'s while (d) runs (_FleetBehind), and each fleet's spare
    worker (the router keeps one) takes the hang's probe, the respawns and
    the recycles; ``fleet``, when given, is
    (a)'s fleet, started by the caller before an earlier phase. Returns
    the launches summed over the workers."""
    layers = model.config.num_self_attention_layers
    totals = {"B2": 0, "B3": 0, "B4": 0}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    def same_tokens(handles):
        return [h.result().tolist() for h in handles] == reference and all(h.ok for h in handles)

    def submit_all(router):
        return [router.submit(p, config=c, seed=seed) for p, c, seed in stream]

    # (a) fault-free, on ``fleet`` (a _FleetBehind started by the caller) or a fleet built here
    router, spawn_s = fleet.join() if fleet is not None else process_router(model)
    warm = [router.submit(p, config=c, seed=seed) for p, c, seed in stream[:3]]
    router.run_until_drained()
    clients = [r.engine for r in router.replicas]
    # the warm-up's slowest RPCs a worker (the init's excluded): the fresh
    # workers' first ticks, which the workers' warm_up has made ordinary
    warm_slowest = [sorted(((ms, op) for op, ms in zip(c.rpc_ops, c.rpc_ms) if op != "init"), reverse=True)[:3]
                    for c in clients]
    before = [c.transport_stats() for c in clients]
    handles = submit_all(router)
    ticks, wall, first = drive_ticks(router.step, handles)
    fleet = _fleet_stats(ticks, wall, first, sum(len(h.output_ids) for h in handles))
    after = [c.transport_stats() for c in clients]
    samples = [ms for b, a in zip(before, after) for ms in a["rpc_ms"][len(b["rpc_ms"]):]]
    rpcs = sum(a["rpcs"] - b["rpcs"] for b, a in zip(before, after))
    moved = sum(a[k] - b[k] for b, a in zip(before, after) for k in ("bytes_sent", "bytes_recv"))
    workers = [c.device_stats() for c in clients]
    identical = same_tokens(handles) and all(h.ok for h in warm)
    counts = _worker_counts("serving_router_process fault-free", router, layers)
    snap = router.snapshot()
    single, inproc = in_process["single_engine"], in_process["router_in_process"]
    emit(phase="serving_router_process", run="fault_free", mode=PROCESS_MODE, replicas=ROUTER_REPLICAS,
         slots_per_replica=8, requests=len(stream), spawn_s=spawn_s, single_engine=single,
         router_in_process=inproc, router_process=fleet,
         ms_per_tick_process_over_single=fleet["ms_per_tick"] / single["ms_per_tick"],
         ms_per_tick_process_over_in_process=fleet["ms_per_tick"] / inproc["ms_per_tick"],
         tokens_per_s_process_over_single=fleet["tokens_per_s"] / single["tokens_per_s"],
         tokens_per_s_process_over_in_process=fleet["tokens_per_s"] / inproc["tokens_per_s"],
         rpcs_per_tick=rpcs / ticks, bytes_per_tick=moved / ticks,
         rpc_p50_ms=float(np.percentile(samples, 50)), rpc_p95_ms=float(np.percentile(samples, 95)),
         rpc_max_ms=max(samples), warm_up_slowest_rpcs=warm_slowest, worker_startup=[c.startup for c in clients], worker_pids=[w["pid"] for w in workers],
         worker_peak_bytes=[w["max_memory_allocated"] for w in workers],
         worker_allocated_bytes=[w["memory_allocated"] for w in workers], transport=snap["transport"],
         captures_per_worker=[c.decode_compilations for c in clients], tokens_identical_to_single_engine=identical,
         launches=counts)
    if not (identical and snap["transport"]["workers_alive"] == ROUTER_REPLICAS and snap["failovers"] == 0
            and snap["transport"]["rpc_retries"] == 0 and snap["breaker_transitions"] == {}):
        raise AssertionError(f"serving_router_process fault-free: tokens identical {identical}, snapshot "
                             f"{snap['transport']}, failovers {snap['failovers']}, breaker "
                             f"{snap['breaker_transitions']}")
    del handles, clients

    with tempfile.TemporaryDirectory() as tmp:
        # (d)'s fleet starts while (c) runs
        device_fleet = _FleetBehind(model, journal=os.path.join(tmp, "device", "r{i}"),
                                    metrics_jsonl=os.path.join(tmp, "device.jsonl"))
        # (c) SIGSTOP of worker 0, on the fault-free run's fleet (no journal)
        hung = router.replicas[0].engine
        hung_pid = hung.pid
        states = ["closed"]  # replica 0's breaker after each tick

        def watch(tick):
            states.append(router.replicas[0].breaker)

        handles = submit_all(router)
        ticks, wall, first, seconds = _timed_ticks(
            router, handles, {ROUTER_EVENT_TICK: ("transport.worker.hang", dict(slot=0))}, watch=watch)
        totals_ac = _worker_counts("serving_router_process hang", router, layers)
        add(totals_ac)
        counts = {k: totals_ac[k] - counts[k] for k in totals_ac}
        snap = router.snapshot()
        router.close()
        try:
            os.kill(hung_pid, 0)
            reaped = False
        except ProcessLookupError:
            reaped = True
        reaped = reaped and not hung.alive and hung.pid is None
        # the half-open promotion and the probe's close fall in one tick
        breaker = [[t, f"{states[t - 1]}->{states[t]}"] for t in range(1, len(states)) if states[t] != states[t - 1]]
        identical = same_tokens(handles)
        t = snap["transport"]
        emit(phase="serving_router_process", run="hang", mode=PROCESS_MODE, stopped_at_tick=ROUTER_EVENT_TICK,
             signal="SIGSTOP", fleet="the fault-free run's", strike_tick_s=seconds[ROUTER_EVENT_TICK - 1],
             half_open_tick_s=seconds[ROUTER_EVENT_TICK + ROUTER_COOLDOWN - 1], breaker_by_tick=breaker,
             breaker_transitions=snap["breaker_transitions"], last_error=snap["replicas"]["r0"].get("last_error"),
             hung_worker_reaped=reaped, failovers=snap["failovers"], failed_over=_moved(handles), timeouts=t["timeouts"],
             worker_respawns=t["worker_respawns"], workers_alive=t["workers_alive"], tokens_identical=identical,
             **_fleet_stats(ticks, wall, first, sum(len(h.output_ids) for h in handles)), launches=counts)
        if not (identical and reaped and snap["failovers"] > 0
                and breaker == [[ROUTER_EVENT_TICK, "closed->open"], [ROUTER_EVENT_TICK + ROUTER_COOLDOWN, "open->closed"]]
                and snap["breaker_transitions"] == {"closed->open": 1, "half_open->closed": 1, "open->half_open": 1}
                and "TransportError" in (snap["replicas"]["r0"].get("last_error") or "") and t["timeouts"] == 2
                and t["worker_respawns"] == 0 and t["workers_alive"] == ROUTER_REPLICAS):
            raise AssertionError(f"serving_router_process hang: tokens identical {identical}, reaped {reaped}, "
                                 f"breaker {breaker} {snap['breaker_transitions']}, failovers {snap['failovers']}, "
                                 f"transport {t}, last error {snap['replicas']['r0'].get('last_error')}")
        del router, handles, hung

        # (d) a device-side assert in worker 1, journaled
        path = os.path.join(tmp, "device.jsonl")
        router, spawn_s = device_fleet.join()
        # the next fleet's workers start while this one runs
        kill_fleet = _FleetBehind(model, journal=os.path.join(tmp, "kill", "r{i}"),
                                  metrics_jsonl=os.path.join(tmp, "kill.jsonl"))
        pid = router.replicas[1].engine.pid
        errors = {}

        def watch(tick):
            if router.replicas[1].last_error and not errors:
                errors[tick] = router.replicas[1].last_error

        handles = submit_all(router)
        ticks, wall, first, seconds = _timed_ticks(
            router, handles, {ROUTER_EVENT_TICK: ("transport.worker.device_fault", dict(slot=1))}, watch=watch)
        counts = _worker_counts("serving_router_process device fault", router, layers)
        add(counts)
        snap = router.snapshot()
        probes = [r.engine.device_stats()["probe"] for r in router.replicas]
        respawned = router.replicas[1].engine.pid not in (None, pid)
        startup = router.replicas[1].engine.startup
        router.close()
        client_probe = torch.arange(8, device=DEVICE, dtype=torch.float32).sum().item()
        breaker = _breaker_ticks(path)
        identical = same_tokens(handles)
        t = snap["transport"]
        [(error_tick, error)] = errors.items() if len(errors) == 1 else [(None, None)]
        emit(phase="serving_router_process", run="device_fault", mode=PROCESS_MODE, fault_at_tick=ROUTER_EVENT_TICK,
             error_tick=error_tick, error=error, spawn_s=spawn_s,
             half_open_tick_s=seconds[ROUTER_EVENT_TICK + ROUTER_COOLDOWN - 1], respawn_startup=startup,
             breaker=breaker, failovers=snap["failovers"], failed_over=_moved(handles),
             worker_respawns=t["worker_respawns"],
             workers_alive=t["workers_alive"], worker_probes=probes, client_probe=client_probe,
             tokens_identical=identical, **_fleet_stats(ticks, wall, first, sum(len(h.output_ids) for h in handles)),
             launches=counts)
        device_error = error is not None and ("AcceleratorError" in error or "CUDA error" in error)
        if not (identical and respawned and device_error and error_tick == ROUTER_EVENT_TICK
                and breaker == _cycle(ROUTER_EVENT_TICK, 1) and snap["failovers"] > 0 and t["worker_respawns"] == 1
                and t["workers_alive"] == ROUTER_REPLICAS and probes == [28.0] * ROUTER_REPLICAS
                and client_probe == 28.0):
            raise AssertionError(f"serving_router_process device fault: tokens identical {identical}, respawned "
                                 f"{respawned}, error at {error_tick}: {error}, breaker {breaker}, failovers "
                                 f"{snap['failovers']}, transport {t}, probes {probes} and {client_probe}")
        del router, handles

        # (b) SIGKILL of worker 1, journaled
        path = os.path.join(tmp, "kill.jsonl")
        router, spawn_s = kill_fleet.join()
        pid = router.replicas[1].engine.pid
        handles = submit_all(router)
        ticks, wall, first, seconds = _timed_ticks(
            router, handles, {ROUTER_EVENT_TICK: ("transport.worker.kill", dict(slot=1))})
        counts = _worker_counts("serving_router_process kill", router, layers)
        add(counts)
        snap = router.snapshot()
        respawned = router.replicas[1].engine.pid not in (None, pid)
        startup = router.replicas[1].engine.startup
        respawn = [e for e in load_metrics_jsonl(path)["events"] if e["event"] == "respawn"]
        identical = same_tokens(handles)
        t = snap["transport"]
        emit(phase="serving_router_process", run="kill", mode=PROCESS_MODE, killed_at_tick=ROUTER_EVENT_TICK,
             signal="SIGKILL", spawn_s=spawn_s, respawn_tick_s=seconds[ROUTER_EVENT_TICK - 1], respawn_startup=startup,
             respawn_events=[{k: v for k, v in e.items() if k != "ts"} for e in respawn],
             worker_respawns=t["worker_respawns"], failovers=snap["failovers"],
             breaker_transitions=snap["breaker_transitions"], workers_alive=t["workers_alive"],
             tokens_identical=identical, **_fleet_stats(ticks, wall, first, sum(len(h.output_ids) for h in handles)),
             launches=counts)
        if not (identical and respawned and t["worker_respawns"] == 1 and snap["failovers"] == 0
                and snap["breaker_transitions"] == {} and t["workers_alive"] == ROUTER_REPLICAS
                and [e["tick"] for e in respawn] == [ROUTER_EVENT_TICK] and respawn[0]["sessions"] > 0):
            raise AssertionError(f"serving_router_process kill: tokens identical {identical}, respawned "
                                 f"{respawned}, events {respawn}, failovers {snap['failovers']}, breaker "
                                 f"{snap['breaker_transitions']}, transport {t}")

        # (e) a rolling restart of the same journaled fleet
        handles = [router.submit(p, config=c, seed=seed) for p, c, seed in stream[:FLEET_PROCESS_REQUESTS]]
        watch = FleetWatch(router, handles, engines=False)
        pids = [r.engine.pid for r in router.replicas]
        start = router._tick
        t0 = time.perf_counter()
        while watch.step():
            if router._tick == start + FLEET_TICK:
                assert router.begin_rolling_restart()
        wall = time.perf_counter() - t0
        totals_e = _worker_counts("serving_router_process rolling restart", router, layers)
        counts_e = {k: totals_e[k] - counts[k] for k in totals_e}
        add(counts_e)
        snap_e = router.snapshot()
        router.close()
        recycles = [{k: v for k, v in e.items() if k != "ts"} for e in load_metrics_jsonl(path)["events"]
                    if e["event"] == "recycle"]
        rebuilt = [r.engine.pid not in pids for r in router.replicas]
        identical_e = ([h.result().tolist() for h in handles] == reference[:FLEET_PROCESS_REQUESTS]
                       and all(h.ok for h in handles))
        t = snap_e["transport"]
        emit(phase="serving_router_process", run="rolling_restart", mode=PROCESS_MODE, fleet="the kill run's",
             requests=len(handles), begun_after_tick=FLEET_TICK, recycle_events=recycles,
             rebuild_tick_s=[watch.tick_s[e["tick"]] for e in recycles],
             steady_tick_ms=1e3 * statistics.median(watch.tick_s[start + k] for k in range(2, FLEET_TICK + 1)),
             rebuild_startup=[r.engine.startup for r in router.replicas], workers_rebuilt=rebuilt,
             sessions_lost=sum(not h.ok for h in handles), failovers=snap_e["failovers"] - snap["failovers"],
             breaker_transitions=snap_e["breaker_transitions"], workers_alive=t["workers_alive"], wall_s=wall,
             tokens_identical=identical_e, launches=counts_e)
        if not (identical_e and all(rebuilt) and len(recycles) == ROUTER_REPLICAS and t["workers_alive"] == 2
                and snap_e["failovers"] == snap["failovers"] and snap_e["breaker_transitions"] == {}):
            raise AssertionError(f"serving_router_process rolling restart: tokens identical {identical_e}, rebuilt "
                                 f"{rebuilt}, recycles {recycles}, transport {t}, breaker "
                                 f"{snap_e['breaker_transitions']}")
        del router, handles, watch

    torch.cuda.empty_cache()
    return totals


def serving_router_process_alone():
    """serving_router_process without the rest of the script: the flagship
    in bf16 from SEED, and PROCESS_MODE's single-engine tokens and stats and
    the in-process router's computed here as serving_router computes them.
    Returns the workers' launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _serving_model()
    stream = request_stream(cfg)
    serve(model, PROCESS_MODE, stream[:3])  # warm-up
    engine = ServingEngine(model, num_slots=8, **SERVING_MODES[PROCESS_MODE][0])
    handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
    single = _fleet_stats(*drive_ticks(engine.step, handles), engine.metrics.tokens_generated)
    reference = [h.result().tolist() for h in handles]
    del engine, handles
    router, handles, _counts, fleet = serve_router(model, PROCESS_MODE, stream)
    router.close()
    if [h.result().tolist() for h in handles] != reference:
        raise AssertionError("serving_router_process_alone: the in-process router's tokens are not the engine's")
    del router, handles
    return serving_router_process(model, stream, reference, dict(single_engine=single, router_in_process=fleet))


FLEET_MODE = "paged_fp"
FLEET_AUTOSCALE_MODE = "paged_int4"
FLEET_TICK = ROUTER_EVENT_TICK  # the fleet operation starts after this router tick
# the autoscale run: a burst of FLEET_BURST requests, then one a tick
FLEET_BURST = 20
FLEET_AUTOSCALE = dict(min_replicas=1, max_replicas=2, scale_up_load=8, scale_down_load=0, every_ticks=4, patience=2)


def _engine_stats(engine):
    return dict(captures=engine.decode_compilations, total=engine.total_compilations, replays=engine.graph_replays,
                ticks=engine.metrics.decode_steps)


class FleetWatch:
    """``router.step()`` with bookkeeping: each router tick's seconds, each
    request's token arrivals (router tick, time, tokens so far), the
    replicas' versions by tick, and the last counters of every engine the
    router replaced (a replaced engine was not ticked after the tick that
    last showed it)."""

    def __init__(self, router, handles, engines=True):
        self.router, self.handles = router, handles
        # in-process engines' counters (a worker's come from _worker_counts)
        self.track = engines
        self.engines = {r.rid: r.engine for r in router.replicas}
        self.initial = len(self.engines)  # built before the counters were zeroed
        self.replaced = []
        self.tick_s = {}
        self.arrivals = {}
        self.versions = []

    def step(self):
        t0 = time.perf_counter()
        work = self.router.step()
        now = time.perf_counter()
        tick = self.router._tick
        self.tick_s[tick] = now - t0
        for r in self.router.replicas:
            old = self.engines.get(r.rid)
            if old is not r.engine:
                if old is not None and self.track:
                    self.replaced.append(_engine_stats(old))
                self.engines[r.rid] = r.engine
        for h in self.handles:
            arrived = self.arrivals.setdefault(h.request_id, [])
            n = len(h.output_ids)
            if n and (not arrived or n > arrived[-1][2]):
                arrived.append((tick, now, n))
        self.versions.append((tick, [r.version for r in self.router.replicas]))
        return work

    def drain(self):
        while self.step():
            pass

    def engine_stats(self):
        return self.replaced + [_engine_stats(e) for e in self.engines.values()]

    def flips(self):
        """(router tick, replica, old version, new version) of each flip."""
        out, last = [], None
        for tick, versions in self.versions:
            if last is not None:
                out += [(tick, i, a, b) for i, (a, b) in enumerate(zip(last, versions)) if a != b]
            last = versions
        return out

    def gaps_ms(self, lo=None, hi=None):
        """ms between successive tokens of a request: the gaps that overlap
        router ticks [lo, hi], or (hi None) those that end before ``lo``."""
        out = []
        for arrived in self.arrivals.values():
            for (t0, s0, _), (t1, s1, _) in zip(arrived, arrived[1:]):
                if (t1 < lo if hi is None else t1 >= lo and t0 <= hi):
                    out.append(1e3 * (s1 - s0))
        return out


def _gap_stats(gaps):
    if not gaps:
        return dict(n=0)
    return dict(n=len(gaps), p50=float(np.percentile(gaps, 50)), p95=float(np.percentile(gaps, 95)), max=max(gaps))


def _check_fleet_captures_and_launches(label, watch, counts, ca_kernel, layers):
    """One capture for each engine the run built, a replay a decode tick, and
    the kernels' counts equal to the decode passes times the launches a pass
    makes: every engine's replays, and the eager warm-up step before the
    capture of each engine built during the run (a rebuild, a flip, a
    scale-up)."""
    engines = watch.engine_stats()
    bad = [e for e in engines if e["captures"] != 1 or e["total"] != 1 or e["replays"] != e["ticks"]]
    if bad:
        raise AssertionError(f"{label}: engines with other than one capture or a replay a tick: {bad}")
    passes = sum(e["replays"] for e in engines) + len(engines) - watch.initial
    expected = {"B2": passes * (layers + (ca_kernel is dk)), "B3": passes * (ca_kernel is pk),
                "B4": passes * (ca_kernel is rk)}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected} for {passes} decode passes "
                             f"({len(engines) - watch.initial} of them warm-ups)")


def _zero_counts():
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0


def _read_counts():
    torch.cuda.synchronize()
    return {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}


def serving_router_fleet(model, stream, references):
    """The fleet operations on the flagship in bf16 over request_stream,
    ROUTER_REPLICAS in-process replicas of 8 slots. (a) paged_fp: after
    FLEET_TICK every live session of replica 0 migrates to replica 1, then
    every other one back: no failover, a ``migrate`` event a move. (b)
    paged_fp, journaled: half the stream, a rolling restart after FLEET_TICK
    while the other half arrives one request a tick; each replica's rebuild
    tick (a fresh engine through its journal: its build and capture), the
    sessions moved, none lost, and the inter-token gaps that overlap the
    restart against those before it. (c) paged_fp: half the stream, then
    version 1 (the flagship from seed SEED + 1) deployed at fraction 0.5
    after FLEET_TICK and the other half submitted: each request's tokens are
    the single engine's of its pinned version (the requests pinned to
    version 0 decode on a replica whose weights the flip left alone);
    rollback, four requests on version 0; a full rollout of the same
    weights (version 2), promoted, four requests on it; the flips by tick
    and the memory allocated with one and two versions live. (d)
    paged_int4 from one replica (FLEET_AUTOSCALE, at most two): a burst of
    FLEET_BURST requests and the rest one a tick scale the fleet up, the
    idle tail back down, none lost. Every run: tokens equal the single
    engine's (``references``, greedy and sampled), one capture for each
    engine built, B2/B3/B4 launches equal the engines' replays times a
    replay's. Returns the launch counts."""
    layers = model.config.num_self_attention_layers
    totals = {"B2": 0, "B3": 0, "B4": 0}
    reference = references[FLEET_MODE]
    ca_kernel = SERVING_MODES[FLEET_MODE][1]

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    def router_of(mode, **options):
        return ServingRouter(model, num_replicas=ROUTER_REPLICAS, num_slots=8, **SERVING_MODES[mode][0], **options)

    def submit(router, handles, indices):
        for i in indices:
            p, c, seed = stream[i]
            handles.append(router.submit(p, config=c, seed=seed))
            order.append(i)

    def events(path, kinds):
        return [{k: v for k, v in e.items() if k != "ts"} for e in load_metrics_jsonl(path)["events"]
                if e["event"] in kinds]

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) migration
        path = os.path.join(tmp, "migrate.jsonl")
        router = router_of(FLEET_MODE, metrics_jsonl=path)
        _zero_counts()
        order, handles = [], []
        submit(router, handles, range(len(stream)))
        watch = FleetWatch(router, handles)
        moves = None
        t0 = time.perf_counter()
        while watch.step():
            if router._tick == FLEET_TICK:
                on0 = [h for h in handles if h.replica == 0 and not h.done]
                landed1 = [router.migrate(h.request_id, 1) for h in on0]
                landed0 = [router.migrate(h.request_id, 0) for h in on0[::2]]
                moves = dict(to_replica_1=len(on0), landed_on_1=sum(landed1), back_to_0=len(on0[::2]),
                             landed_on_0=sum(landed0), emitted_at_move=[len(h.output_ids) for h in on0])
        wall = time.perf_counter() - t0
        counts = _read_counts()
        _check_fleet_captures_and_launches("serving_router_fleet migration", watch, counts, ca_kernel, layers)
        add(counts)
        snap = router.snapshot()
        router.close()
        migrate_events = events(path, {"migrate"})
        identical = [h.result().tolist() for h in handles] == reference and all(h.ok for h in handles)
        emit(phase="serving_router_fleet", run="migration", mode=FLEET_MODE, replicas=ROUTER_REPLICAS,
             slots_per_replica=8, requests=len(stream), at_tick=FLEET_TICK, moves=moves,
             migrate_events=len(migrate_events), migrations_in_snapshot=snap["fleet_ops"]["migrations"],
             failovers=snap["failovers"], breaker_transitions=snap["breaker_transitions"], ticks=router._tick,
             wall_s=wall, tokens_identical=identical, engines=watch.engine_stats(), launches=counts)
        if not (identical and moves and moves["to_replica_1"] > 0 and moves["landed_on_1"] == moves["to_replica_1"]
                and moves["landed_on_0"] == moves["back_to_0"] and snap["failovers"] == 0
                and len(migrate_events) == moves["landed_on_1"] + moves["landed_on_0"]
                == snap["fleet_ops"]["migrations"] and snap["breaker_transitions"] == {}):
            raise AssertionError(f"serving_router_fleet migration: tokens identical {identical}, moves {moves}, "
                                 f"events {len(migrate_events)}, snapshot {snap['fleet_ops']}, failovers "
                                 f"{snap['failovers']}, breaker {snap['breaker_transitions']}")
        del router, handles, watch

        # (b) rolling restart under load, journaled
        path = os.path.join(tmp, "restart.jsonl")
        router = router_of(FLEET_MODE, metrics_jsonl=path, journal=os.path.join(tmp, "restart", "r{i}"))
        _zero_counts()
        order, handles = [], []
        half = len(stream) // 2
        submit(router, handles, range(half))
        watch = FleetWatch(router, handles)
        arriving = list(range(half, len(stream)))
        restart_end = None
        t0 = time.perf_counter()
        while watch.step() or arriving:
            if router._tick == FLEET_TICK:
                assert router.begin_rolling_restart()
            if router._tick >= FLEET_TICK and arriving:
                submit(router, handles, [arriving.pop(0)])
            if restart_end is None and router._tick > FLEET_TICK and not router.restart_in_progress:
                restart_end = router._tick
        wall = time.perf_counter() - t0
        counts = _read_counts()
        _check_fleet_captures_and_launches("serving_router_fleet restart", watch, counts, ca_kernel, layers)
        add(counts)
        snap = router.snapshot()
        router.close()
        recycles = events(path, {"recycle"})
        got = [h.result().tolist() for h in handles]
        identical = got == [reference[i] for i in order] and all(h.ok for h in handles)
        lost = sum(not h.ok for h in handles)
        steady, during = watch.gaps_ms(FLEET_TICK + 1), watch.gaps_ms(FLEET_TICK + 1, restart_end)
        emit(phase="serving_router_fleet", run="rolling_restart", mode=FLEET_MODE, journaled=True,
             begun_after_tick=FLEET_TICK, restart_end_tick=restart_end, recycle_events=recycles,
             rebuild_tick_ms=[1e3 * watch.tick_s[e["tick"]] for e in recycles],
             steady_tick_ms=1e3 * statistics.median(watch.tick_s[t] for t in range(2, FLEET_TICK + 1)),
             sessions_moved=sum(e["sessions_moved"] for e in recycles), sessions_lost=lost,
             inter_token_gap_ms_steady=_gap_stats(steady), inter_token_gap_ms_during_restart=_gap_stats(during),
             failovers=snap["failovers"], breaker_transitions=snap["breaker_transitions"], ticks=router._tick,
             wall_s=wall, tokens_identical=identical, engines=watch.engine_stats(), launches=counts)
        if not (identical and lost == 0 and len(recycles) == ROUTER_REPLICAS and snap["failovers"] == 0
                and snap["breaker_transitions"] == {} and len(watch.engine_stats()) == 2 * ROUTER_REPLICAS):
            raise AssertionError(f"serving_router_fleet restart: tokens identical {identical}, lost {lost}, "
                                 f"recycles {recycles}, failovers {snap['failovers']}, breaker "
                                 f"{snap['breaker_transitions']}, engines {watch.engine_stats()}")
        del router, handles, watch

        # (c) deploy, rollback, full rollout
        _, v1_model = _serving_model(seed=SEED + 1)
        _, v1_handles, _ = serve(v1_model, FLEET_MODE, stream)
        reference_v1 = [h.result().tolist() for h in v1_handles]
        state_v1 = {k: v.detach().cpu() for k, v in v1_model.state_dict().items()}
        del v1_model, v1_handles
        torch.cuda.empty_cache()
        path = os.path.join(tmp, "deploy.jsonl")
        router = router_of(FLEET_MODE, metrics_jsonl=path)
        _zero_counts()
        order, handles = [], []
        submit(router, handles, range(half))
        watch = FleetWatch(router, handles)
        memory = {}
        while True:
            work = watch.step()
            if router._tick == FLEET_TICK:
                memory["one_version_bytes"] = torch.cuda.memory_allocated()
                deployed = router.deploy(state_v1, fraction=0.5)
                submit(router, handles, range(half, len(stream)))
                work = True
            if "two_versions_bytes" not in memory and 1 in [r.version for r in router.replicas]:
                memory["two_versions_bytes"] = torch.cuda.memory_allocated()
            if not work and router._tick > FLEET_TICK:
                break
        rolled_back = router.rollback()
        for _ in range(2):
            watch.step()  # the flipped replica flips back
        submit(router, handles, range(4))
        watch.drain()
        promoted_version = router.deploy(state_v1, fraction=1.0)
        for _ in range(2):
            watch.step()  # both flip, then the full rollout becomes the primary
        memory["after_full_rollout_bytes"] = torch.cuda.memory_allocated()
        promoted = router._primary_version == promoted_version and router._rollout is None
        submit(router, handles, range(4, 8))
        watch.drain()
        counts = _read_counts()
        _check_fleet_captures_and_launches("serving_router_fleet deploy", watch, counts, ca_kernel, layers)
        add(counts)
        snap = router.snapshot()
        router.close()
        pins = [h.version for h in handles]
        want = [(reference if v == 0 else reference_v1)[i] for i, v in zip(order, pins)]
        identical = [h.result().tolist() for h in handles] == want and all(h.ok for h in handles)
        by_version = {v: sum(p == v for p in pins) for v in sorted(set(pins))}
        v0_left_alone = [h.result().tolist() for h, v in zip(handles, pins) if v == 0] == [
            reference[i] for i, v in zip(order, pins) if v == 0]
        emit(phase="serving_router_fleet", run="deploy_rollback", mode=FLEET_MODE, deployed_after_tick=FLEET_TICK,
             fraction=0.5, version=deployed, pins=by_version, flips=watch.flips(),
             flip_tick_ms=[1e3 * watch.tick_s[t] for t in sorted({f[0] for f in watch.flips()})],
             steady_tick_ms=1e3 * statistics.median(watch.tick_s[t] for t in range(2, FLEET_TICK + 1)),
             rolled_back=rolled_back,
             full_rollout_version=promoted_version, promoted=promoted, memory=memory,
             second_version_bytes=memory.get("two_versions_bytes", 0) - memory["one_version_bytes"],
             events=events(path, {"deploy", "rollback"}), rollout=snap["fleet_ops"]["rollout"],
             version_0_tokens_identical=v0_left_alone, tokens_identical=identical, engines=watch.engine_stats(),
             launches=counts)
        if not (identical and rolled_back and promoted and by_version.get(1) and by_version.get(0)
                and by_version.get(promoted_version) == 4 and snap["failovers"] == 0
                and snap["breaker_transitions"] == {}):
            raise AssertionError(f"serving_router_fleet deploy: tokens identical {identical}, pins {by_version}, "
                                 f"rolled back {rolled_back}, promoted {promoted}, flips {watch.flips()}")
        del router, handles, watch, state_v1

        # (d) autoscale, paged_int4
        mode = FLEET_AUTOSCALE_MODE
        path = os.path.join(tmp, "autoscale.jsonl")
        router = ServingRouter(model, num_replicas=1, num_slots=8, metrics_jsonl=path, autoscale=FLEET_AUTOSCALE,
                               **SERVING_MODES[mode][0])
        _zero_counts()
        order, handles = [], []
        submit(router, handles, range(FLEET_BURST))
        watch = FleetWatch(router, handles)
        arriving = list(range(FLEET_BURST, len(stream)))
        active = []
        t0 = time.perf_counter()
        while watch.step() or arriving:
            if arriving:
                submit(router, handles, [arriving.pop(0)])
            active.append(sum(not r.retired and not r.recycling for r in router.replicas))
        for _ in range(4 * FLEET_AUTOSCALE["every_ticks"] * FLEET_AUTOSCALE["patience"]):
            if sum(not r.retired for r in router.replicas) == FLEET_AUTOSCALE["min_replicas"]:
                break
            watch.step()  # the idle tail
        wall = time.perf_counter() - t0
        counts = _read_counts()
        _check_fleet_captures_and_launches("serving_router_fleet autoscale", watch, counts, SERVING_MODES[mode][1],
                                           layers)
        add(counts)
        snap = router.snapshot()
        router.close()
        scaled = events(path, {"autoscale"})
        identical = ([h.result().tolist() for h in handles] == [references[mode][i] for i in order]
                     and all(h.ok for h in handles))
        fleet = snap["fleet_ops"]
        emit(phase="serving_router_fleet", run="autoscale", mode=mode, knobs=FLEET_AUTOSCALE, burst=FLEET_BURST,
             autoscale_events=scaled, peak_replicas=max(active), replicas_active=fleet["replicas_active"],
             scale_ups=fleet["scale_ups"], scale_downs=fleet["scale_downs"],
             sessions_lost=sum(not h.ok for h in handles),
             ticks=router._tick, wall_s=wall, tokens_identical=identical, engines=watch.engine_stats(),
             launches=counts)
        if not (identical and max(active) == 2 and fleet["scale_ups"] >= 1 and fleet["scale_downs"] >= 1
                and fleet["replicas_active"] == 1 and counts["B4"] > 0 and snap["failovers"] == 0):
            raise AssertionError(f"serving_router_fleet autoscale: tokens identical {identical}, peak {max(active)}, "
                                 f"fleet {fleet}, launches {counts}")
        del router, handles, watch
    torch.cuda.empty_cache()
    emit(phase="serving_router_fleet", run="phase", seconds=time.perf_counter() - t_phase, launches=totals)
    return totals


def serving_router_fleet_alone():
    """serving_router_fleet without the rest of the script: the flagship in
    bf16 from SEED and the single engine's tokens in paged_fp and
    paged_int4 computed here. Returns the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = _serving_model()
    stream = request_stream(cfg)
    references = {}
    for mode in (FLEET_MODE, FLEET_AUTOSCALE_MODE):
        serve(model, mode, stream[:3])  # warm-up
        _, handles, _ = serve(model, mode, stream)
        references[mode] = [h.result().tolist() for h in handles]
        del handles
    return serving_router_fleet(model, stream, references)


def served_bytes_from_shapes(model, weight_dtype):
    """(served, float) bytes of ``model``'s parameters under ``weight_dtype``,
    from their shapes alone: int8 codes a byte an element plus one 4-byte
    scale per JAX leaf of ndim >= 2 (a layer stack is one leaf), the rest as
    stored."""
    shapes = {n: (p.numel(), p.dim(), p.element_size()) for n, p in model.named_parameters()}
    fp = sum(n * e for n, _d, e in shapes.values())
    if weight_dtype is None:
        return fp, fp
    if weight_dtype == "bf16":
        return sum(2 * n for n, _d, _e in shapes.values()), fp
    leaves = {}
    for name, (n, d, e) in shapes.items():
        key, stacked = jax_leaf(name)
        leaves.setdefault(key, []).append((n, d + int(stacked), e))
    served = sum(sum(n for n, _d, _e in group) + group[0][2] if group[0][1] >= 2 else sum(n * e for n, _d, e in group)
                 for group in leaves.values())
    return served, fp


def weight_serving():
    """The flagship with float32 parameters and bf16 compute, paged_fp with
    the prefix cache, 8 slots, request_stream, serving the weights as
    stored, in bf16 and in int8 (a fresh model each: the engine takes it
    over): served and float bytes equal to their count from the shapes, the
    card's allocated memory after construction and its peak, the graph
    pool, ms a tick, tokens/s and greedy agreement with the float weights;
    then set_params to SEED + 1's parameters: one capture still, the prefix
    cache empty, and 8 requests' tokens equal to a fresh engine's on those
    parameters. Returns the launch counts."""
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    stream = request_stream(cfg)
    options = dict(prefix_cache=True)
    totals = {"B2": 0, "B3": 0, "B4": 0}
    greedy_none = None
    for weight_dtype in (None, "bf16", "int8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, model = _serving_model(torch.float32)
        want_served, want_fp = served_bytes_from_shapes(model, weight_dtype)
        engine = ServingEngine(model, num_slots=8, weight_dtype=weight_dtype, **SERVING_MODES["paged_fp"][0], **options)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - base
        peak_construction = torch.cuda.max_memory_allocated() - base
        served = tree_bytes(engine.params)
        gauges = engine.metrics.snapshot()["weight_serving"]
        bytes_ok = served == want_served and (gauges is None or (gauges["param_bytes"], gauges["param_bytes_fp"])
                                              == (want_served, want_fp))
        dk.launches = pk.launches = rk.launches = 0
        handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
        engine.run_until_drained()
        torch.cuda.synchronize()
        counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
        _check_captures_and_launches(f"weight_serving {weight_dtype}", engine, counts, pk, layers)
        for k in totals:
            totals[k] += counts[k]
        stats = _run_stats(engine.metrics.snapshot())
        greedy = [h.result().tolist() for h in handles if not h.config.do_sample]
        greedy_none = greedy if weight_dtype is None else greedy_none
        matched = sum(a == b for g, r in zip(greedy, greedy_none) for a, b in zip(g, r))
        total = sum(len(r) for r in greedy_none)
        peak = torch.cuda.max_memory_allocated() - base
        # the swap: SEED + 1's parameters, in place
        cached_before = engine._prefix_cache.stats()["cached_pages"]
        _, other = _serving_model(torch.float32, seed=SEED + 1)
        engine.set_params(dict(other.named_parameters()))
        cached_after = engine._prefix_cache.stats()["cached_pages"]
        fresh = ServingEngine(other, num_slots=8, weight_dtype=weight_dtype, **SERVING_MODES["paged_fp"][0], **options)
        swapped = []
        for e in (engine, fresh):  # launches of this check are not counted: the kernels line counts the runs above
            hs = [e.submit(p, config=c, seed=seed) for p, c, seed in stream[:8]]
            e.run_until_drained()
            swapped.append([h.result().tolist() for h in hs])
        swap_ok = (swapped[0] == swapped[1] and engine.decode_compilations == engine.total_compilations == 1
                   and cached_after == 0)
        emit(phase="weight_serving", weight_dtype=weight_dtype, mode="paged_fp", options=options, slots=8,
             requests=len(stream), served_bytes=served, float_bytes=want_fp, served_bytes_from_shapes=want_served,
             bytes_agree=bytes_ok, memory_allocated_after_construction=allocated,
             peak_memory_allocated_construction=peak_construction, peak_memory_allocated_run=peak,
             graph_pool_bytes=engine.graph_pool_bytes, **stats,
             greedy_agreement_with_float_weights=matched / total if total else None,
             set_params=dict(captures=engine.total_compilations, cached_pages_before=cached_before,
                             cached_pages_after=cached_after, tokens_equal_a_fresh_engine=swapped[0] == swapped[1],
                             tokens_changed=swapped[0] != [h.result().tolist() for h in handles[:8]]),
             launches=counts)
        if not (bytes_ok and swap_ok):
            raise AssertionError(f"weight_serving {weight_dtype}: bytes {served} / {gauges} against {want_served} / "
                                 f"{want_fp} from the shapes; set_params captures {engine.total_compilations}, cached "
                                 f"pages {cached_after}, tokens equal a fresh engine's {swapped[0] == swapped[1]}")
        del engine, fresh, model, other
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------- phase 6: optical-flow inference
FLOW_IMAGE = (436, 1024)  # a Sintel frame pair: a 2 x 3 grid of 368 x 496 patches


def optical_flow():
    """Perceiver IO inference at full width through OpticalFlowPipeline:
    official_41m_config() in bf16 over float32 parameters (random, from
    SEED) on a seeded synthetic 436 x 1024 frame pair, its six patches in one
    micro-batch, as bench.py:bench_optical_flow runs the JAX model. One
    warm-up, then REPEATS model forwards on the preprocessed patches (ms,
    synced) and REPEATS pipeline calls (preprocessing, forward, blending:
    frame pairs/s). Every count is zeroed just before and read just after;
    B1a must launch 24 times a forward at D = 64 and once at D = 512, and
    nothing else. Returns the B1a launches by width."""
    cfg = official_41m_config()
    layers = cfg.encoder.num_self_attention_layers_per_block
    model = OpticalFlow(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    frame1, frame2, _ = make_flow_pair(np.random.default_rng(SEED), FLOW_IMAGE)
    pipe = OpticalFlowPipeline(model, micro_batch_size=6)
    patches = len(pipe.processor.compute_patch_grid_indices(FLOW_IMAGE))
    x = torch.from_numpy(pipe.processor.preprocess((frame1, frame2))).to(DEVICE)
    pipe([(frame1, frame2)])  # warm-up: cuBLAS handles, the kernel libraries, the Fourier table's cast
    torch.cuda.synchronize()
    zero_counts()
    fl.forward_launches_by_width.clear()
    torch.cuda.reset_peak_memory_stats()
    forward_ms, pipeline_s = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        flow = pipe([(frame1, frame2)])
        pipeline_s.append(time.perf_counter() - t0)
    counts = dict(fl.forward_launches_by_width)
    others = {"B1b": fl.backward_launches, "B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    forwards = 2 * REPEATS
    expected = {64: layers * forwards, 512: forwards}
    emit(phase="optical_flow", model="official_41m_config", dtype="bfloat16 compute, float32 params",
         image=FLOW_IMAGE, patches=patches, micro_batch_size=6, forwards=forwards,
         forward_ms=spread(forward_ms), frame_pairs_per_s=spread([1 / t for t in pipeline_s]),
         pipeline_s=spread(pipeline_s), max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         b1a_launches_by_head_dim=counts, expected_b1a_launches_by_head_dim=expected, other_launches=others,
         flow_shape=list(flow.shape[1:]), flow_finite=bool(np.isfinite(flow).all()),
         flow_rms=float(np.sqrt(np.mean(flow**2))))
    if counts != expected or any(others.values()):
        raise AssertionError(f"optical flow: B1a launches {counts}, expected {expected}; others {others}")
    if flow.shape != (1, *FLOW_IMAGE, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"optical flow: flow of shape {flow.shape}, finite: {np.isfinite(flow).all()}")
    del model, pipe
    torch.cuda.empty_cache()
    return counts, optical_flow_default_dtype(cfg, x)


def optical_flow_default_dtype(cfg, x):
    """The same model at its default dtype (its parameters', float32; TF32
    off), one patch a call as OpticalFlowPipeline's default micro-batch of
    1: REPEATS passes over the pair's six preprocessed patches, each patch
    a synced forward (ms a pair, ms a patch). Every count is zeroed just
    before and read just after: B1a must run in float32 only, 24 times a
    patch at D = 64 and once at D = 512 (csrc/flash_forward_f32.cu), and
    nothing else launch; the flows finite. Returns B1a's float32
    launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers = cfg.encoder.num_self_attention_layers_per_block
    model = OpticalFlow(cfg, device=DEVICE, seed=SEED)
    patches = x.float()
    with torch.inference_mode():
        model(patches[:1])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    fl.forward_launches_by_width.clear()
    torch.cuda.reset_peak_memory_stats()
    pair_ms, finite = [], True
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for i in range(len(patches)):
            with torch.inference_mode():
                out = model(patches[i:i + 1])
            torch.cuda.synchronize()
            finite = finite and bool(torch.isfinite(out).all())
        pair_ms.append((time.perf_counter() - t0) * 1e3)
    calls = REPEATS * len(patches)
    counts = dict(fl.forward_launches_by_width)
    by_dtype = dict(fl.forward_launches_by_dtype)
    others = {"B1b": fl.backward_launches, "B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    expected = {64: layers * calls, 512: calls}
    emit(phase="optical_flow", model="official_41m_config", dtype="float32 (the parameters' dtype, the default)",
         micro_batch_size=1, patches_per_pair=len(patches), forwards=calls, pair_ms=spread(pair_ms),
         patch_ms=spread([t / len(patches) for t in pair_ms]),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, b1a_launches_by_head_dim=counts,
         b1a_launches_by_dtype=by_dtype, expected_b1a_launches_by_head_dim=expected, other_launches=others,
         flow_finite=finite)
    if counts != expected or by_dtype != {"float32": sum(expected.values())} or any(others.values()) or not finite:
        raise AssertionError(f"optical flow in float32: B1a launches {counts} ({by_dtype}), expected {expected}; "
                             f"others {others}; finite {finite}")
    del model, patches
    torch.cuda.empty_cache()
    return by_dtype["float32"]


# ------------------------------------------------ phase 6: optical-flow training
FLOW_TRAIN_PATCHES = 2  # a micro-batch of two Sintel-sized 368 x 496 patches
FLOW_TRAIN_WARMUP, FLOW_TRAIN_STEPS = 3, 5
FLOW_SCALE = 20  # OpticalFlowProcessor's flow_scale_factor: the model learns flow / 20


def flow_train_batch(cfg, patches, seed):
    """``patches`` seeded make_flow_pair frame pairs of one patch each,
    preprocessed to 27-channel patches, and their flow (flow_patches)."""
    x, flow = flow_patches(np.random.default_rng(seed), cfg.encoder.image_shape, patches)
    return {"x": torch.from_numpy(x), "flow": torch.from_numpy(flow)}


def train_flow(dtype=torch.bfloat16, patches=FLOW_TRAIN_PATCHES):
    """The Perceiver IO optical-flow train step at full width and depth:
    official_41m_config() with activation checkpointing, float32 parameters
    (random, from SEED) in ``dtype`` compute (bf16, or float32: the model's
    default dtype, which runs B1a and B1b in float32), AdamW at 1e-3 with
    clipping at 1.0, on a micro-batch of ``patches`` 368 x 496 patches from
    make_flow_pair and the processor, through scripts/convergence.py's flow
    train step (the loss of the probe task, MSE against flow / 20).
    FLOW_TRAIN_WARMUP steps, then FLOW_TRAIN_STEPS timed steps on the same
    batch (each synced: ms a step, patches/s), the counts zeroed just before
    them and read just after: B1a and B1b by head width must be exact (the
    decoder's one head at D 512 and the self-attention layers at D 64, B1a
    twice a layer with checkpointing, B1b once), all in
    ``dtype``, and nothing else launched; the loss finite and lower after
    the timed steps than at the first. Returns the launches by kernel and
    width."""
    cfg = dataclasses.replace(official_41m_config(), activation_checkpointing=True)
    layers = cfg.encoder.num_self_attention_layers_per_block * cfg.encoder.num_self_attention_blocks
    model = OpticalFlow(cfg, device=DEVICE, dtype=None if dtype == torch.float32 else dtype, seed=SEED)
    batch = {k: v.to(DEVICE) for k, v in flow_train_batch(cfg, patches, SEED + 12).items()}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_flow_train_step(model, tx, FLOW_SCALE)
    losses = []
    for _ in range(FLOW_TRAIN_WARMUP):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    fl.forward_launches_by_width.clear()
    fl.backward_launches_by_width.clear()
    ms = []
    for _ in range(FLOW_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # the step's one host read, which syncs it
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"B1a": dict(fl.forward_launches_by_width), "B1b": dict(fl.backward_launches_by_width)}
    by_dtype = {"B1a": dict(fl.forward_launches_by_dtype), "B1b": dict(fl.backward_launches_by_dtype)}
    others = {"B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    remat = 2 if cfg.activation_checkpointing else 1  # a checkpointed layer's forward runs again in the backward
    expected = {"B1a": {64: remat * layers * FLOW_TRAIN_STEPS, 512: remat * FLOW_TRAIN_STEPS},
                "B1b": {64: layers * FLOW_TRAIN_STEPS, 512: FLOW_TRAIN_STEPS}}
    name = str(dtype).removeprefix("torch.")
    expected_by_dtype = {key: {name: sum(widths.values())} for key, widths in expected.items()}
    emit(phase="train_flow", model="official_41m_config", dtype=f"{name} compute, float32 params",
         activation_checkpointing=cfg.activation_checkpointing, patches=patches,
         image=list(cfg.encoder.image_shape), steps=FLOW_TRAIN_STEPS, ms_per_step=spread(ms),
         patches_per_s=spread([patches / (t / 1e3) for t in ms]),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, losses=losses,
         launches_by_head_dim=counts, expected_launches_by_head_dim=expected, launches_by_dtype=by_dtype,
         other_launches=others)
    if counts != expected or any(others.values()):
        raise AssertionError(f"flow train: launches {counts}, expected {expected}; others {others}")
    if dtype == torch.float32 and by_dtype != expected_by_dtype:
        raise AssertionError(f"flow train: launches by dtype {by_dtype}, expected {expected_by_dtype}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"flow train: the loss did not fall from {losses[0]}: {losses}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    return counts


def card_vs_cpu_flow_train():
    """Optical-flow training in float32 (TF32 off) at official_41m_config's
    width with 2 self-attention layers and 128 latents on 16 x 16 patches,
    whose decoder head (512 channels, 256 pixel queries over 128 latents)
    and self-attention heads (64) pass the flash gate: the card's loss
    within 1e-5 relative of the port's CPU run, every gradient within 1e-3
    x its RMS, 3 AdamW steps' losses within 1e-4 relative; on the card B1b
    launched at D 64 and at D 512 (csrc/flash_backward_f32.cu).
    The key projections' biases, whose gradient the softmax cancels, are
    held to 1e-6 x the whole gradient's RMS on both sides instead."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = official_41m_config()
    shape = (16, 16)
    cfg = dataclasses.replace(
        full, num_latents=128,
        encoder=dataclasses.replace(full.encoder, image_shape=shape, num_self_attention_layers_per_block=2),
        decoder=dataclasses.replace(full.decoder, image_shape=shape))
    cpu = OpticalFlow(cfg, device="cpu", seed=SEED)
    gpu = OpticalFlow(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    batch = flow_train_batch(cfg, 2, SEED + 13)
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}

    def loss_and_grads(model, b):
        model.train()
        loss = torch.mean((model(b["x"]) - b["flow"] / FLOW_SCALE) ** 2)
        return loss, torch.autograd.grad(loss, trainable(model))

    l_cpu, g_cpu = loss_and_grads(cpu, batch)
    fl.backward_launches_by_width.clear()
    l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
    launches = dict(fl.backward_launches_by_width)
    loss_rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    names = [n for n, p in cpu.named_parameters() if p.requires_grad]
    # a key projection's bias moves all of a query's scores by one amount,
    # which the softmax cancels: its gradient is zero in exact arithmetic
    # and float32 rounding noise on both sides, with no scale of its own;
    # it is held to 1e-6 x the RMS of the whole gradient on both sides
    scale = torch.cat([t.flatten() for t in g_cpu]).pow(2).mean().sqrt().item()
    cancelled = {n: max(a.abs().max().item(), b.abs().max().item()) / scale
                 for n, a, b in zip(names, g_gpu, g_cpu) if n.endswith("attention.k_proj.bias")}
    grad_ratio = {n: ((a.cpu() - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-30)).item()
                  for n, a, b in zip(names, g_gpu, g_cpu) if n not in cancelled}
    worst = max(grad_ratio, key=grad_ratio.get)
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
        tx = build_optimizer(1e-3, max_grad_norm=1.0)
        state = TrainState.create(model, tx, seed=SEED)
        step = make_flow_train_step(model, tx, FLOW_SCALE)
        runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="flow_train", layers=2, image=shape, latents=128, loss_rel_err=loss_rel,
         loss_rtol=1e-5, max_grad_err_over_rms=grad_ratio[worst], worst_grad=worst, grad_limit=1e-3,
         worst_grads=dict(sorted(grad_ratio.items(), key=lambda kv: -kv[1])[:4]),
         cancelled_grads_over_gradient_rms=cancelled, cancelled_limit=1e-6,
         step_losses=runs, step_loss_rel_err=step_rel, step_rtol=1e-4, b1b_launches_by_head_dim=launches)
    if not (loss_rel <= 1e-5 and grad_ratio[worst] <= 1e-3 and step_rel <= 1e-4
            and max(cancelled.values()) <= 1e-6):
        raise AssertionError(f"flow train card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {grad_ratio[worst]} "
                             f"x RMS (1e-3), steps {step_rel} (1e-4), cancelled gradients {cancelled} (1e-6)")
    if launches != {64: 2, 512: 1}:
        raise AssertionError(f"flow train card vs CPU: B1b launches {launches}, expected {{64: 2, 512: 1}}")


FLOW_CONVERGENCE_STEPS = 500


def flow_convergence():
    """scripts/convergence.py's run_optical_flow_epe on the card, float32, at
    FLOW_CONVERGENCE_STEPS steps through Trainer.fit (the probe model: 32 x
    48 pairs, 128 latents of 64 channels, one 64-channel decoder head, so B1a
    and B1b at D 64), then the endpoint error through the whole pipeline on
    unseen 48 x 72 pairs: raises unless ``met`` (EPE < 0.5 x the zero-flow
    baseline). Returns the B1 launches of the run."""
    zero_counts()
    t0 = time.perf_counter()
    result = run_optical_flow_epe(FLOW_CONVERGENCE_STEPS, device=DEVICE, log_fn=lambda line: None)
    torch.cuda.synchronize()
    counts = flash_counts()
    by_dtype = {"B1a": dict(fl.forward_launches_by_dtype), "B1b": dict(fl.backward_launches_by_dtype)}
    emit(phase="flow_convergence", steps=FLOW_CONVERGENCE_STEPS, wall_s=time.perf_counter() - t0,
         **{k: v for k, v in result.items() if k != "history"}, val_epe_curve=[h["val_epe"] for h in result["history"]
                                                                             if "val_epe" in h], launches=counts,
         launches_by_dtype=by_dtype)
    if by_dtype != {"B1a": {"float32": counts["B1a"]}, "B1b": {"float32": counts["B1b"]}}:
        raise AssertionError(f"flow convergence: B1 ran other than float32: {by_dtype}")
    if not result["met"]:
        raise AssertionError(f"flow convergence: pipeline EPE {result['full_pipeline_epe_px']} is not under half the "
                             f"zero-flow baseline {result['zero_flow_baseline_epe_px']}")
    if not (counts["B1a"] and counts["B1b"]):
        raise AssertionError(f"flow convergence: B1 launches {counts}")
    return counts


# --------------------------------------------------- phase 6: card vs cpu
def card_vs_cpu():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_455m_config()
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device="cuda", param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(SEED + 2))
    max_err = 0.0
    with torch.no_grad():  # prefill (8 latents: decode attention) then 8 decode steps on the same tokens
        c_cpu, c_gpu = cpu.init_cache(1), gpu.init_cache(1)
        l_cpu, c_cpu = cpu.prefill(ids, 56, c_cpu)
        l_gpu, c_gpu = gpu.prefill(ids.cuda(), 56, c_gpu)
        for step in range(8):
            max_err = max(max_err, (l_gpu.cpu() - l_cpu).abs().max().item())
            tok = l_cpu[:, -1].argmax(-1, keepdim=True)
            l_cpu, c_cpu = cpu.decode_step(tok, c_cpu)
            l_gpu, c_gpu = gpu.decode_step(tok.cuda(), c_gpu)
        max_err = max(max_err, (l_gpu.cpu() - l_cpu).abs().max().item())
    t_cpu = generate(cpu, ids, num_latents=8, max_new_tokens=8)
    t_gpu = generate(gpu, ids.cuda(), num_latents=8, max_new_tokens=8).cpu()
    same = torch.equal(t_cpu, t_gpu)
    emit(phase="card_vs_cpu", max_logit_err=max_err, atol=1e-3, greedy_tokens_identical=same)
    if not max_err <= 1e-3 or not same:
        raise AssertionError(f"card vs CPU: logit error {max_err} (atol 1e-3), tokens identical: {same}")


def card_vs_cpu_flow():
    """OpticalFlow at official_41m_config's full width with 2 self-attention
    layers on a 64 x 96 image (6,144 pixel queries, which a splash tile
    divides, so the decoder's 512-channel head still takes B1a), in f32
    with TF32 off: the card's flow within 1e-3 x its RMS of the CPU's, and
    B1a launched on the card at D = 64 (twice) and D = 512 (once)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = official_41m_config()
    shape = (64, 96)
    cfg = dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, image_shape=shape, num_self_attention_layers_per_block=2),
        decoder=dataclasses.replace(full.decoder, image_shape=shape))
    cpu = OpticalFlow(cfg, device="cpu", seed=SEED)
    gpu = OpticalFlow(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal((1, 2, 27, *shape), dtype=np.float32))
    fl.forward_launches_by_width.clear()
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(DEVICE)).cpu()
    counts = dict(fl.forward_launches_by_width)
    rms = want.pow(2).mean().sqrt().item()
    err = (got - want).abs().max().item()
    emit(phase="card_vs_cpu", path="optical_flow", layers=2, image=shape, max_flow_err=err, flow_rms=rms,
         limit=1e-3 * rms, b1a_launches_by_head_dim=counts)
    if not err <= 1e-3 * rms or counts != {64: 2, 512: 1}:
        raise AssertionError(f"optical flow card vs CPU: error {err} (limit {1e-3 * rms}), B1a launches {counts}")


def _copy_device_state(src: ServingEngine, dst: ServingEngine) -> None:
    """Overwrite ``dst``'s pool, caches and next logits with ``src``'s (the
    two engines hold the same requests in the same slots)."""
    ca, dca = src._cache.ca, dst._cache.ca
    for name in ("kp", "vp", "page_table", "start", "k_scale", "v_scale"):
        if getattr(ca, name) is not None:
            getattr(dca, name).copy_(getattr(ca, name))
    for a, b in ((src._cache.sa.k, dst._cache.sa.k), (src._cache.sa.v, dst._cache.sa.v),
                 (src._cache.shift, dst._cache.shift), (src._cache.live, dst._cache.live),
                 (src._state.next_logits, dst._state.next_logits)):
        b.copy_(a)


def card_vs_cpu_serving():
    """The engine at flagship width with 2 layers in float32 (TF32 off), 4
    slots, page 128, the same 6 greedy requests on the card and on the CPU,
    in paged fp, int8 and int4 pools:
    - the two runs give identical tokens;
    - a decode tick from the same state (the card's pools, caches and logits
      after its first tick copied into a CPU engine) gives logits within
      1e-3 of the card's;
    - the first tick's logits of the two independent runs agree within 1e-3
      in fp and int8 pools. In int4 pools that number is printed, not held:
      the card and the CPU compute the keys and values in a different order,
      a few codes round the other way, and one int4 step is 1/7 of a head's
      largest value in the page."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(SEED + 5)
    requests = [(rs.randint(1, cfg.vocab_size, n).tolist(), m)
                for n, m in ((100, 8), (600, 12), (1024, 6), (300, 10), (512, 9), (777, 7))]

    def engine(model, quant):
        e = ServingEngine(model, num_slots=4, kv_page_size=128, kv_quant=quant)
        return e, [e.submit(p, max_new_tokens=m) for p, m in requests]

    logits = lambda e: e._state.next_logits.float().cpu()
    for quant in (None, "int8", "int4"):
        (e_cpu, h_cpu), (e_gpu, h_gpu), (e_same, _) = engine(cpu, quant), engine(gpu, quant), engine(cpu, quant)
        for e in (e_cpu, e_gpu, e_same):
            e.step()
        first_err = (logits(e_gpu) - logits(e_cpu)).abs().max().item()
        _copy_device_state(e_gpu, e_same)
        e_gpu.step()
        e_same.step()
        same_state_err = (logits(e_gpu) - logits(e_same)).abs().max().item()
        e_cpu.run_until_drained()
        e_gpu.run_until_drained()
        tokens = [h.result().tolist() for h in h_gpu]
        same = tokens == [h.result().tolist() for h in h_cpu]
        held = quant != "int4"
        emit(phase="card_vs_cpu", path="serving", kv_quant=quant, first_tick_max_logit_err=first_err,
             first_tick_held=held, same_state_tick_max_logit_err=same_state_err, atol=1e-3, tokens_identical=same,
             tokens=sum(map(len, tokens)))
        if not same or not same_state_err <= 1e-3 or (held and not first_err <= 1e-3):
            raise AssertionError(f"serving card vs CPU ({quant}): tokens identical: {same}, logit error from the "
                                 f"same state {same_state_err}, first tick {first_err} (atol 1e-3)")


def card_vs_cpu_chunked():
    """The chunked and prefix path at flagship width with 2 layers in float32
    (TF32 off): one engine on the card (decode on its CUDA graph) and one on
    the CPU, 4 slots, page 128, chunks of 256, the prefix cache, 2 prompts
    in flight, ticked in turns over the same 8 greedy requests (two 256-token
    system prefixes, 768-896 tokens in all): identical tokens, the same
    prefix hits and chunks (both > 0), and after every tick the next logits
    of the slots that decode within 1e-3 of the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(SEED + 7)
    systems = [rs.randint(1, cfg.vocab_size, 256).tolist() for _ in range(2)]
    requests = [(systems[i % 2] + rs.randint(1, cfg.vocab_size, int(rs.randint(768, 897)) - 256).tolist(),
                 int(rs.randint(6, 13))) for i in range(8)]
    engines = [ServingEngine(m, num_slots=4, **CHAT) for m in (gpu, cpu)]
    handles = [[e.submit(p, max_new_tokens=m) for p, m in requests] for e in engines]
    max_err, ticks, work = 0.0, 0, [True, True]
    while any(work):
        work = [e.step() for e in engines]
        if work[0] != work[1]:
            raise AssertionError("chunked card vs CPU: the engines ticked apart")
        active = engines[1]._state.active
        if active.any():
            err = (engines[0]._state.next_logits.cpu()[active] - engines[1]._state.next_logits[active]).abs().max()
            max_err = max(max_err, err.item())
        ticks += 1
    tokens = [[h.result().tolist() for h in hs] for hs in handles]
    snaps = [e.metrics.snapshot() for e in engines]
    hits = [s["prefix_cache"]["hits"] for s in snaps]
    chunks = [s["chunked_prefill"]["chunks_dispatched"] for s in snaps]
    same = tokens[0] == tokens[1]
    emit(phase="card_vs_cpu", path="serving_chunked_prefix", ticks=ticks, max_logit_err=max_err, atol=1e-3,
         tokens_identical=same, tokens=sum(map(len, tokens[0])), prefix_hits=hits, chunks=chunks,
         graph_replays=engines[0].graph_replays)
    if not same or not max_err <= 1e-3 or hits[0] != hits[1] or chunks[0] != chunks[1] or not (hits[0] and chunks[0]):
        raise AssertionError(f"chunked card vs CPU: tokens identical {same}, logit error {max_err} (atol 1e-3), "
                             f"prefix hits {hits}, chunks {chunks}")


# -------------------------------------------------------- phase 7: training
TRAIN_STEPS = 3  # steps per timed window; REPEATS windows, each ending in one host read of the loss


def flash_counts():
    return {"B1a": fl.forward_launches, "B1b": fl.backward_launches}


def train_flagship(model):
    """The 455M flagship at full width (20 layers, 1280 channels, sequence
    1024, 512 latents; ``model``, built from SEED), bf16 compute over f32
    parameters, batch 16, random
    ids from SEED with labels rolled by one; make_causal_lm_train_step with
    build_optimizer(1e-3, max_grad_norm=1.0) and the config's activation
    checkpointing (dots policy). 2 warm-up steps, then REPEATS windows of
    TRAIN_STEPS steps. The batch is fixed, so the loss must fall."""
    cfg = model.config
    layers = cfg.num_self_attention_layers
    batch = 16
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
    first = None
    for _ in range(2):
        state, metrics = step(state, data)
        first = float(metrics["loss"]) if first is None else first

    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    peak = detect_peak_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fl.forward_launches = fl.backward_launches = dk.launches = pk.launches = rk.launches = 0
    ms_per_step, losses = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, data)
        losses.append(float(metrics["loss"]))  # the window's one host read; steps depend on each other
        ms_per_step.append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
    counts = flash_counts()
    steps = REPEATS * TRAIN_STEPS
    expected = {"B1a": (1 + layers) * steps + layers * steps, "B1b": (1 + layers) * steps}
    tokens_per_s = [flops.tokens_per_step(batch) / (ms / 1e3) for ms in ms_per_step]
    emit(phase="train", model="flagship_455m", layers=layers, batch=batch, dtype="bfloat16 compute, float32 params",
         remat_policy=cfg.remat_policy, steps=steps, launches=counts, expected_launches=expected,
         decode_kernel_launches=dk.launches + pk.launches + rk.launches,
         ms_per_step=spread(ms_per_step), latent_tokens_per_s=spread(tokens_per_s),
         mfu=None if peak is None else spread([flops.train_flops_per_step(batch) / (ms / 1e3) / peak
                                               for ms in ms_per_step]),
         peak_flops=peak, train_flops_per_step=flops.train_flops_per_step(batch),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, first_loss=first,
         window_losses=losses)
    if counts != expected:
        raise AssertionError(f"flagship train: launches {counts}, expected {expected} for {steps} steps")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < first:
        raise AssertionError(f"flagship train: the loss did not fall from {first}: {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------ phase 5c: telemetry
TELEMETRY_REQUESTS = 16  # the stream's first 16 requests: two waves of 8 slots
TELEMETRY_STEPS = 12  # (c): Trainer.fit's steps, logged every 4
TELEMETRY_PROFILE = dict(profile_start_step=3, profile_steps=3)  # steps 4-6 traced
# the warning torch.cuda.set_sync_debug_mode("warn") gives a synchronizing
# call (its first use also warns that the mode is a prototype: not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _phase_table(summary, prefix):
    """A recorder summary's phases under ``prefix``: count and mean ms."""
    return {k: {"count": v["count"], "mean_ms": 1e3 * v["mean_s"], "p95_ms": 1e3 * v["p95_s"]}
            for k, v in summary["phases"].items() if k.startswith(prefix)}


def _telemetry_run(model, stream, telemetry, count_syncs):
    """One paged_int4 engine run over ``stream``, stepped here so that the
    ticks are counted; with ``count_syncs`` the run's host syncs are counted
    under torch.cuda.set_sync_debug_mode("warn") (the engine is built
    outside it). Returns the engine (closed), its handles, the ticks, the
    syncs, the wall s and the B2-B4 counts."""
    engine = ServingEngine(model, num_slots=8, telemetry=telemetry, **SERVING_MODES["paged_int4"][0])
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    syncs = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
            ticks = 1
            while engine.step():
                ticks += 1
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if count_syncs:
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    torch.cuda.synchronize()
    counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
    engine.close()
    return engine, handles, ticks, syncs, wall, counts


def telemetry_serving(model, stream):
    """Phase 5c (a) and (b): the engine with telemetry on and off in turns,
    then a two-replica router with telemetry on. Returns the B2-B4 launches."""
    cfg = model.config
    layers = cfg.num_self_attention_layers
    stream = stream[:TELEMETRY_REQUESTS]
    totals = {"B2": 0, "B3": 0, "B4": 0}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="telemetry-") as root:
        runs = []
        # in turns, the syncs counted on the middle two
        for i, (on, count_syncs) in enumerate(((False, False), (True, True), (False, True), (True, False))):
            path = os.path.join(root, f"engine{i}.json") if on else None
            engine, handles, ticks, syncs, wall, counts = _telemetry_run(model, stream, path if on else False,
                                                                        count_syncs)
            snap = engine.metrics.snapshot()
            harvests = snap["decode_steps"]
            expected = {"B2": harvests * layers, "B3": 0, "B4": harvests}
            if counts != expected or engine.decode_compilations != 1 or engine.graph_replays != harvests:
                raise AssertionError(f"telemetry (a) run {i}: launches {counts}, expected {expected}; "
                                     f"{engine.decode_compilations} captures, {engine.graph_replays} replays")
            if not all(h.ok and len(h.output_ids) == h.config.max_new_tokens for h in handles):
                raise AssertionError(f"telemetry (a) run {i}: a request did not finish with its max_new_tokens")
            for k in totals:
                totals[k] += counts[k]
            run = dict(on=on, ticks=ticks, harvests=harvests, syncs=syncs, wall_ms_per_tick=1e3 * wall / ticks,
                       decode_ms_per_tick=1e3 * snap["decode_step_s"]["mean"],
                       greedy=[h.result().tolist() for h in handles if not h.config.do_sample])
            if on:
                summary = engine.telemetry_summary()
                trace = load_chrome_trace(path)
                problems = validate_chrome_trace(trace)
                begins = sorted(e["id"] for e in trace["traceEvents"] if e["ph"] == "b")
                ends = sorted(e["id"] for e in trace["traceEvents"] if e["ph"] == "e")
                ids = sorted(h.request_id for h in handles)
                phases = summary["phases"]
                run.update(problems=problems, spans_per_request=begins == ends == ids,
                           tick_spans=phases["serving.tick"]["count"],
                           sample_sync_spans=phases["serving.sample_sync"]["count"],
                           compile=summary["compile"], trace_bytes=os.path.getsize(path),
                           phases=_phase_table(summary, "serving."))
                if (problems or begins != ids or ends != ids or run["tick_spans"] != ticks
                        or run["sample_sync_spans"] != harvests):
                    raise AssertionError(f"telemetry (a) run {i}: trace problems {problems[:3]}, one begin and "
                                         f"end a request {run['spans_per_request']}, tick spans "
                                         f"{run['tick_spans']} for {ticks} ticks, sample_sync spans "
                                         f"{run['sample_sync_spans']} for {harvests} harvests")
                if summary["compile"]["per_function"] != {"serving.decode_step": {"compilations": 1, "budget": 1}} \
                        or summary["compile"]["unexpected"]:
                    raise AssertionError(f"telemetry (a) run {i}: compile block {summary['compile']}")
            runs.append(run)
        identical = all(r["greedy"] == runs[0]["greedy"] for r in runs)
        syncs = {r["on"]: r["syncs"] for r in runs if r["syncs"] is not None}
        on_ms = [r["wall_ms_per_tick"] for r in runs if r["on"]]
        off_ms = [r["wall_ms_per_tick"] for r in runs if not r["on"]]
        emit(phase="telemetry", run="engine", mode="paged_int4", slots=8, requests=len(stream),
             order=["off", "on (syncs counted)", "off (syncs counted)", "on"],
             greedy_tokens_identical=identical, host_syncs={"on": syncs[True], "off": syncs[False]},
             ms_per_tick_on=on_ms, ms_per_tick_off=off_ms,
             decode_ms_per_tick_on=[r["decode_ms_per_tick"] for r in runs if r["on"]],
             decode_ms_per_tick_off=[r["decode_ms_per_tick"] for r in runs if not r["on"]],
             overhead_ms_per_tick=statistics.mean(on_ms) - statistics.mean(off_ms),
             **{k: [r[k] for r in runs] for k in ("ticks", "harvests")},
             tick_spans=runs[1]["tick_spans"], sample_sync_spans=runs[1]["sample_sync_spans"],
             compile=runs[1]["compile"], trace_bytes=runs[1]["trace_bytes"], tick_phases=runs[-1]["phases"])
        if not identical or syncs[True] != syncs[False] or not syncs[True]:
            raise AssertionError(f"telemetry (a): greedy tokens identical {identical}, host syncs on / off "
                                 f"{syncs[True]} / {syncs[False]}")

        # (b) the router: one shared recorder, a namespace a replica
        path = os.path.join(root, "router.json")
        router = ServingRouter(model, num_replicas=2, num_slots=8, telemetry=path, **SERVING_MODES["paged_fp"][0])
        torch.cuda.synchronize()
        dk.launches = pk.launches = rk.launches = 0
        handles = [router.submit(p, config=c, seed=seed) for p, c, seed in stream]
        ticks, wall, first = drive_ticks(router.step, handles)
        counts = {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}
        _check_router_captures_and_launches("telemetry (b)", router, counts, pk, layers)
        summary = router.telemetry_summary()
        router.close()
        trace = load_chrome_trace(path)
        problems = validate_chrome_trace(trace)
        phases = summary["phases"]
        namespaces = sorted({k.split(".")[1] for k in phases if k.startswith("serving.r")})
        report = summary["compile"]
        emit(phase="telemetry", run="router", mode="paged_fp", replicas=2, requests=len(stream), ticks=ticks,
             ms_per_tick=1e3 * wall / ticks, namespaces=namespaces, compile=report,
             router_tick_spans=phases["router.tick"]["count"], trace_problems=problems[:5],
             counters=summary["counters"], phases=_phase_table(summary, "router."))
        if (problems or namespaces != ["r0", "r1"] or len(report["per_function"]) != 2
                or any(v["compilations"] != 1 for v in report["per_function"].values()) or report["unexpected"]
                or not all(h.ok for h in handles) or phases["router.tick"]["count"] != ticks):
            raise AssertionError(f"telemetry (b): trace problems {problems[:3]}, namespaces {namespaces}, compile "
                                 f"report {report}, all finished {all(h.ok for h in handles)}")
        for k in totals:
            totals[k] += counts[k]
    emit(phase="telemetry", run="serving_seconds", seconds=time.perf_counter() - t_phase)
    return totals


def _profile_top_kernels(path, top=10):
    """The device kernels of a torch.profiler Chrome trace, summed by name:
    the ``top`` by device time (ms and count)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and isinstance(e.get("dur"), (int, float)):
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return by_name, [{"kernel": k[:90], "ms": ms, "count": n} for k, (ms, n) in ranked[:top]]


def telemetry_training(model, init):
    """Phase 5c (c): Trainer.fit on the flagship from its seeded weights
    ``init``, TELEMETRY_STEPS steps logged every 4, with telemetry and
    profile_dir, then with both off. Returns the B1a/B1b launches."""
    t_phase = time.perf_counter()
    data = ResilientData(model.config)
    fl.forward_launches = fl.backward_launches = 0
    losses, summaries = {}, {}
    with tempfile.TemporaryDirectory(prefix="telemetry-train-") as root:
        prof = os.path.join(root, "profile")
        for on in (True, False):
            state, step, rec = _resilient_state(model, init)
            cfg = TrainerConfig(max_steps=TELEMETRY_STEPS, log_every=4, eval_every=10**9, prefetch_depth=2,
                                telemetry=on, profile_dir=prof if on else None,
                                **TELEMETRY_PROFILE)
            lines = []
            trainer = Trainer(cfg, log_fn=lambda line: lines.append(json.loads(line)))
            t0 = time.perf_counter()
            trainer.fit(state, step, data.train_dataloader)
            fit_s = time.perf_counter() - t0
            losses[on] = _losses(rec)
            summaries[on] = (trainer.telemetry_summary, fit_s, _step_ms(rec),
                             [line for line in lines if "profile_trace" in line])
            del state, step, rec
        summary, fit_s, step_ms, profile_events = summaries[True]
        files = sorted(os.listdir(prof))
        by_name, top = _profile_top_kernels(os.path.join(prof, files[0])) if files else ({}, [])
    counts = flash_counts()
    layers = model.config.num_self_attention_layers
    steps = 2 * TELEMETRY_STEPS
    expected = {"B1a": (1 + layers) * steps + layers * steps, "B1b": (1 + layers) * steps}
    names = set(by_name)
    b1 = {"flash_fwd_mma_kernel": any("flash_fwd_mma_kernel" in n for n in names),
          "flash_bwd_*": any("flash_bwd_" in n for n in names)}
    phases = summary["phases"]
    emit(phase="telemetry", run="train", steps=TELEMETRY_STEPS, losses=losses[True],
         bit_identical=losses[True] == losses[False], step_dispatch_spans=phases["train.step_dispatch"]["count"],
         log_sync_spans=phases["train.log_sync"]["count"], compile=summary["compile"], gauges=summary["gauges"],
         step_phases=_phase_table(summary, "train."), profile_events=profile_events, profile_files=files,
         profile_b1_kernels=b1, profile_top_kernels=top,
         step_ms_on=spread(step_ms[1:]), step_ms_off=spread(summaries[False][2][1:]),
         step_ms_on_each=step_ms, step_ms_off_each=summaries[False][2],
         fit_s={"on": fit_s, "off": summaries[False][1]}, launches=counts,
         seconds=time.perf_counter() - t_phase)
    if (losses[True] != losses[False] or len(losses[True]) != TELEMETRY_STEPS
            or phases["train.step_dispatch"]["count"] != TELEMETRY_STEPS or phases["train.log_sync"]["count"] != 3
            or not all(b1.values()) or summary["compile"]["unexpected"] or len(files) != 1
            or profile_events != [{"step": 6, "profile_trace": prof}] or counts != expected):
        raise AssertionError(f"telemetry (c): losses identical {losses[True] == losses[False]}, step_dispatch "
                             f"{phases['train.step_dispatch']['count']}, log_sync {phases['train.log_sync']['count']}, "
                             f"B1 in the profile {b1}, unexpected {summary['compile']['unexpected']}, profile files "
                             f"{files}, events {profile_events}, launches {counts} (expected {expected})")
    return counts


# ------------------------------------------- phase 6a: resilient training
RESILIENT_STEPS = 12  # the uninterrupted run's steps: L
RESILIENT_EVERY = 4  # checkpoint_every: saves at 4, 8, 12 and the final one
RESILIENT_CHILD_STEPS = 8  # the killed child's max_steps: its step-8 periodic write is the last it submits
RESILIENT_TERM_STEP = 6  # run (c) raises SIGTERM after this step
RESILIENT_BATCH = 16
RESILIENT_EPOCH_BATCHES = 8  # 12 steps cross an epoch boundary
RESILIENT_SLOW_S = 0.1  # run (e): loader.fetch.slow's sleep a fetch
RESILIENT_SLOW_STEPS = 6  # run (e): steps at each prefetch depth
RESILIENT_KILL_TIMEOUT_S = 300.0


class SeededTokens:
    """Item i: ``seq_len`` token ids from numpy's generator seeded (seed, i)."""

    def __init__(self, n, seq_len, vocab, seed=SEED):
        self.n, self.seq_len, self.vocab, self.seed = n, seq_len, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.default_rng([self.seed, i]).integers(0, self.vocab, self.seq_len, dtype=np.int64)


class ResilientData:
    """The phase's data module: a stateful DataLoader (exact mid-epoch
    resume) over SeededTokens, shuffled from SEED, labels rolled by one."""

    def __init__(self, cfg):
        self.cfg = cfg

    @staticmethod
    def collate(ex):
        x = np.stack(ex)
        return {"input_ids": x, "labels": np.roll(x, -1, axis=1)}

    def train_dataloader(self):
        ds = SeededTokens(RESILIENT_BATCH * RESILIENT_EPOCH_BATCHES, self.cfg.max_seq_len, self.cfg.vocab_size)
        return DataLoader(ds, RESILIENT_BATCH, collate_fn=self.collate, shuffle=True, rng=np.random.default_rng(SEED))


def _resilient_state(model, init=None):
    """A fresh train state (AdamW 1e-3, clipping at 1.0: a constant rate, so
    a run's steps do not depend on its max_steps) and its step, recording
    each step's loss (on the card) and an event after it; ``term_at``
    raises SIGTERM after that step."""
    if init is not None:
        model.load_state_dict(init)
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    inner = make_causal_lm_train_step(model, tx, max_latents=model.config.max_latents)
    rec = {"losses": [], "events": [], "term_at": None, "print": False}

    def step(state, batch):
        state, metrics = inner(state, batch)
        rec["losses"].append(metrics["loss"].detach())
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        rec["events"].append(event)
        if rec["print"]:
            print(json.dumps({"step": state.step, "loss": metrics["loss"].item()}), flush=True)
        if rec["term_at"] is not None and state.step == rec["term_at"]:
            signal.raise_signal(signal.SIGTERM)  # a preemption notice, delivered to this main thread
        return state, metrics

    return state, step, rec


def _losses(rec):
    return torch.stack(rec["losses"]).tolist() if rec["losses"] else []


def _step_ms(rec):
    """ms between consecutive steps' events (the card's timeline, idle
    included): element i is step i + 2's."""
    torch.cuda.synchronize()
    ev = rec["events"]
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def _resilient_config(max_steps, ckpt_dir=None, depth=2, jsonl=None, every=RESILIENT_EVERY):
    return TrainerConfig(max_steps=max_steps, log_every=RESILIENT_EVERY, eval_every=10**9,
                         checkpoint_dir=ckpt_dir, checkpoint_every=every if ckpt_dir else 0,
                         prefetch_depth=depth, async_checkpoint=True, metrics_jsonl=jsonl)


def _no_perceiver_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("perceiver-")]


def train_child(path):
    """The resilient phase's child (``python3 chip_smoke.py --train-child
    <dir>``): the flagship from SEED, the phase's fit to
    RESILIENT_CHILD_STEPS with lineage saves to ``path`` every
    RESILIENT_EVERY steps through the async writer; it prints its
    parameters' checksum, then a line a step, until it is killed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CausalSequenceModel(flagship_455m_config(), device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    print(json.dumps({"checksum": _param_checksum(model)}), flush=True)
    state, step, rec = _resilient_state(model)
    rec["print"] = True
    Trainer(_resilient_config(RESILIENT_CHILD_STEPS, path), log_fn=lambda line: None).fit(
        state, step, ResilientData(model.config).train_dataloader)
    return 0


def _kill_child_mid_write(path, gen_bytes, out):
    """Start the child and SIGKILL it while its step-8 write is in flight:
    after the rotation (``last.prev`` holds step 4's data and manifest) and
    while the new ``last/state.pt`` holds part of its bytes, before
    ``last.manifest.json``. Fills ``out`` (run on a thread of its own)."""
    last = os.path.join(path, "last")
    state_pt = os.path.join(last, ckpt.STATE_FILE)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--train-child", path],
                             stdout=subprocess.PIPE, text=True)
    out["proc"] = child  # for the phase's clean-up, should it fail before this returns
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(child.stdout), name="train-child-reader")
    reader.start()
    t0, killed_at, rotated = time.perf_counter(), None, False
    try:
        while time.perf_counter() - t0 < RESILIENT_KILL_TIMEOUT_S and child.poll() is None:
            if not rotated:  # step 4's generation moved whole to last.prev: the step-8 write follows
                try:
                    with open(ckpt.manifest_path(last + ".prev")) as f:
                        rotated = json.load(f).get("step") == RESILIENT_EVERY and os.path.isdir(last + ".prev")
                except (OSError, json.JSONDecodeError):
                    pass
                time.sleep(0.002)
                continue
            size = os.path.getsize(state_pt) if os.path.exists(state_pt) else 0
            if size > 0 and not os.path.exists(ckpt.manifest_path(last)):
                child.send_signal(signal.SIGKILL)
                killed_at = {"s": time.perf_counter() - t0, "state_pt_bytes": size, "mid_data": size < gen_bytes}
                break
            time.sleep(0.0005)
    finally:
        if child.poll() is None and killed_at is None:
            child.kill()
        child.wait()
        reader.join()
        child.stdout.close()
    records = [json.loads(line) for line in lines]
    out.update(killed=killed_at, code=child.returncode, checksum=next((r["checksum"] for r in records
                                                                       if "checksum" in r), None),
               losses=[r["loss"] for r in records if "loss" in r], child_s=time.perf_counter() - t0)


def train_resilient(model, init):
    """The resilient-training phase alone: train_resilient_start, then
    train_resilient_finish. Returns the B1 counts."""
    return train_resilient_finish(train_resilient_start(model, init))


def train_resilient_start(model, init):
    """Resilient training of the 455M flagship at full width (the model
    train_flagship runs, reset to its seeded weights ``init`` before each
    run): run_fit / Trainer.fit on ResilientData with prefetch_depth 2,
    lineage saves every RESILIENT_EVERY steps through the async writer,
    under a temporary directory.
    (a) RESILIENT_STEPS steps twice, no saves: the losses L, which must be
        the same bits (else the gates below take that difference);
    (b) a child (--train-child, started before (a); main() runs checks that
        read no clock while it starts) SIGKILLed while its step-8 write is
        in flight: on disk ``last`` torn (no manifest, its state.pt does not
        load) and ``last.prev`` (step 4) valid; run_fit(resume=True) takes
        ``last.prev`` (validated by its manifest) and steps 5-12 give
        L[4:12], its one save the final one;
    (d) checkpoint.corrupt armed on that final save: restore falls back to
        ``last.prev`` and names ``last`` in skipped;
    (c) SIGTERM after step RESILIENT_TERM_STEP in this process: fit returns
        preempted with a ``preempted`` event, its final save at that step,
        the previous handler back, no perceiver-* thread; the resume gives
        L[6:12]; the step-4 write's timings, the submit's ms on the step
        thread, ms a step with the write in flight against steady steps;
    (e) loader.fetch.slow at RESILIENT_SLOW_S a fetch: ms a step at
        prefetch_depth 2 against 0.
    B1a and B1b counted over the phase's steps as in train_flagship. This
    part starts the child and runs (a); it returns the context that
    train_resilient_finish (or, on a failure between them,
    train_resilient_cleanup) takes."""
    cfg = model.config
    ctx = dict(model=model, init=init, data=ResilientData(cfg), root=tempfile.mkdtemp(prefix="train_resilient-"),
               child={}, watcher=None, steps=0, launches={"B1a": 0, "B1b": 0})
    t0_phase = time.perf_counter()
    try:
        state, _, _ = _resilient_state(model, init)
        ctx["gen_bytes"] = gen_bytes = sum(v.numel() * v.element_size() for v in ckpt.state_tree(state).values())
        del state
        ctx["free_before"] = shutil.disk_usage(ctx["root"]).free
        need = 3 * gen_bytes  # last, last.prev and a write in flight
        if ctx["free_before"] < need:
            raise RuntimeError(f"train_resilient: {ctx['free_before']} bytes free under {ctx['root']}, {need} needed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.forward_launches = fl.backward_launches = 0

        # (b) starts first: the child's interpreter, imports, build and first
        # steps run beside (a), which only reads the card's results
        model.load_state_dict(init)
        ctx["parent_checksum"] = _param_checksum(model)
        ctx["dir_b"] = os.path.join(ctx["root"], "b")
        os.makedirs(ctx["dir_b"])
        ctx["watcher"] = threading.Thread(target=_kill_child_mid_write, args=(ctx["dir_b"], gen_bytes, ctx["child"]),
                                          name="train-child-watch")
        ctx["watcher"].start()

        # (a) uninterrupted, twice
        runs = []
        for _ in range(2):
            state, step, rec = _resilient_state(model, init)
            t0 = time.perf_counter()
            Trainer(_resilient_config(RESILIENT_STEPS), log_fn=lambda line: None).fit(state, step,
                                                                                     ctx["data"].train_dataloader)
            runs.append((_losses(rec), _step_ms(rec), time.perf_counter() - t0))
            ctx["steps"] += len(rec["losses"])
            del state, step, rec
        ctx["L"] = L = runs[0][0]
        ctx["spread"] = spread_a = max(abs(a - b) for a, b in zip(runs[0][0], runs[1][0]))
        first_diff = next((i for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0])) if a != b), None)
        emit(phase="train_resilient", run="a", steps=RESILIENT_STEPS, losses=L, second_run_losses=runs[1][0],
             bit_identical=spread_a == 0, first_differing_step=None if first_diff is None else first_diff + 1,
             max_abs_diff=spread_a, step_ms_beside_the_child=spread(runs[0][1][1:]), fit_s=[r[2] for r in runs])
        torch.cuda.synchronize()
        ctx["launches"] = flash_counts()  # the checks run between start and finish launch B1 too
        ctx["peak"] = torch.cuda.max_memory_allocated()
        ctx["seconds"] = time.perf_counter() - t0_phase
        return ctx
    except BaseException:
        train_resilient_cleanup(ctx)
        raise


def train_resilient_cleanup(ctx):
    """Stop the child if it still runs, free the pinned pool, remove the
    phase's directory."""
    if ctx["watcher"] is not None:
        proc = ctx["child"].get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
        ctx["watcher"].join()
    ckpt.PINNED.clear()
    shutil.rmtree(ctx["root"], ignore_errors=True)
    torch.cuda.empty_cache()


def train_resilient_finish(ctx):
    """Runs (b), (d), (c) and (e) of train_resilient_start's phase and
    returns the B1 counts of the phase's steps."""
    model, init, data, root, child = ctx["model"], ctx["init"], ctx["data"], ctx["root"], ctx["child"]
    layers = model.config.num_self_attention_layers
    L, spread_a, steps = ctx["L"], ctx["spread"], ctx["steps"]
    same = lambda got, want: len(got) == len(want) and all(abs(a - b) <= spread_a for a, b in zip(got, want))
    t0_wait = time.perf_counter()
    try:
        ctx["watcher"].join()
        child_wait_s = time.perf_counter() - t0_wait
        t_phase = time.perf_counter()
        fl.forward_launches = fl.backward_launches = 0
        torch.cuda.reset_peak_memory_stats()

        # (b) the child SIGKILLed mid-write; run_fit(resume=True) with
        # checkpoint.corrupt armed on its one save, the final one (d)
        dir_b = ctx["dir_b"]
        last = os.path.join(dir_b, "last")
        torn = os.path.isdir(last) and not os.path.exists(ckpt.manifest_path(last))
        try:
            ckpt.load_pytree(last)
            loads = True
        except Exception:  # noqa: BLE001 — a torn state.pt must fail to load
            loads = False
        with open(ckpt.manifest_path(last + ".prev")) as f:  # the resume below checks it against the data
            prev_step = json.load(f)["step"]
        if child["killed"] is None or child["code"] != -signal.SIGKILL or not torn or loads \
                or prev_step != RESILIENT_EVERY:
            raise AssertionError(f"train_resilient (b): the kill missed the step-8 write's window: {child}, last "
                                 f"without manifest {torn}, last loads {loads}, last.prev step {prev_step}")
        state, step, rec = _resilient_state(model, init)
        lines = []
        with armed("checkpoint.corrupt"):
            run_fit(_resilient_config(RESILIENT_STEPS, dir_b, every=0), state, step, data, resume=True,
                    log_fn=lines.append)
        head = json.loads(lines[0])
        resumed_b = _losses(rec)
        steps += len(resumed_b)
        emit(phase="train_resilient", run="b", child_s=child["child_s"], child_wait_s=child_wait_s,
             killed=child["killed"],
             child_exit=child["code"], same_weights=child["checksum"] == ctx["parent_checksum"],
             child_losses=child["losses"], last_torn=torn, last_loads=loads, last_prev_step=prev_step, resumed=head,
             resumed_losses=resumed_b, equal_to_L=same(resumed_b, L[RESILIENT_EVERY:]))
        if not (child["checksum"] == ctx["parent_checksum"] and head.get("checkpoint") == "last.prev"
                and head.get("validated") == "manifest" and head.get("resumed_from_step") == RESILIENT_EVERY
                and same(resumed_b, L[RESILIENT_EVERY:]) and same(child["losses"], L[:len(child["losses"])])):
            raise AssertionError(f"train_resilient (b): resume {head}, losses {resumed_b} against {L[4:]}, child "
                                 f"{child['losses']}")
        del state
        state, _, _ = _resilient_state(model)
        t0 = time.perf_counter()
        state, info_d = Trainer.restore_latest_valid(dir_b, state)
        restore_d_s = time.perf_counter() - t0
        emit(phase="train_resilient", run="d", restore=info_d, restore_s=restore_d_s, state_step=state.step)
        if not (info_d["name"] == "last.prev" and info_d["step"] == RESILIENT_EVERY
                and info_d["validated"] == "manifest" and [s.split(":")[0] for s in info_d["skipped"]] == ["last"]):
            raise AssertionError(f"train_resilient (d): {info_d}")
        del state, step, rec
        shutil.rmtree(dir_b)

        # (c) SIGTERM in this process, then the resume
        dir_c = os.path.join(root, "c")
        jsonl = os.path.join(root, "c.jsonl")
        state, step, rec = _resilient_state(model, init)
        rec["term_at"] = RESILIENT_TERM_STEP
        prev_handler = signal.getsignal(signal.SIGTERM)
        trainer = Trainer(_resilient_config(RESILIENT_STEPS, dir_c, jsonl=jsonl), log_fn=lambda line: None)
        t0 = time.perf_counter()
        state = trainer.fit(state, step, data.train_dataloader)
        fit_c_s = time.perf_counter() - t0
        trainer.close()
        threads, handler_back = _no_perceiver_threads(), signal.getsignal(signal.SIGTERM) == prev_handler
        killed_c, ms_c = _losses(rec), _step_ms(rec)
        steps += len(killed_c)
        events = load_train_metrics(jsonl)["by_kind"]
        writes, submits, final = trainer.writer.writes, trainer.writer.submits, trainer.final_save
        last_c = ckpt.verify_checkpoint(os.path.join(dir_c, "last"))["step"]
        del state, step, rec
        state, step, rec = _resilient_state(model, init)
        t0 = time.perf_counter()
        state, info = Trainer.restore_latest_valid(dir_c, state)
        restore_c_s = time.perf_counter() - t0
        loader = data.train_dataloader()
        Trainer.restore_iterator(info["iterator_path"], loader)
        state = Trainer(_resilient_config(RESILIENT_STEPS), log_fn=lambda line: None).fit(state, step, lambda: loader)
        resumed_c = _losses(rec)
        steps += len(resumed_c)
        steady = ms_c[:RESILIENT_EVERY - 1]  # steps 2-4
        in_flight = ms_c[RESILIENT_EVERY - 1:]  # steps 5-6: after the step-4 submit (its copies in step 5), its write running
        emit(phase="train_resilient", run="c", preempted=trainer.preempted, preempted_events=events.get("preempted"),
             final_save_step=last_c, threads_left=threads, handler_restored=handler_back, fit_s=fit_c_s,
             killed_losses=killed_c, resumed_losses=resumed_c, equal_to_L=same(resumed_c, L[RESILIENT_TERM_STEP:]),
             generation_bytes=ctx["gen_bytes"], submits=submits, writes=writes,
             final_save=final,
             steady_step_ms=steady, write_in_flight_step_ms=in_flight, restore=info, restore_s=restore_c_s)
        if not (trainer.preempted and events.get("preempted") and events["preempted"][0]["step"] == RESILIENT_TERM_STEP
                and last_c == RESILIENT_TERM_STEP and not threads and handler_back and info["name"] == "last"
                and same(killed_c, L[:RESILIENT_TERM_STEP]) and same(resumed_c, L[RESILIENT_TERM_STEP:])):
            raise AssertionError(f"train_resilient (c): preempted {trainer.preempted}, events {events.get('preempted')}, "
                                 f"final save {last_c}, threads {threads}, handler {handler_back}, restore {info}, "
                                 f"losses {killed_c} + {resumed_c} against {L}")

        del state, step, rec
        free_during = shutil.disk_usage(root).free  # last and last.prev on disk
        shutil.rmtree(dir_c)

        # (e) a slow loader at prefetch depth 2 and 0
        slow = {}
        for depth in (2, 0):
            state, step, rec = _resilient_state(model, init)
            with armed("loader.fetch.slow", times=None, value=RESILIENT_SLOW_S):
                Trainer(_resilient_config(RESILIENT_SLOW_STEPS, depth=depth), log_fn=lambda line: None).fit(
                    state, step, data.train_dataloader)
            slow[depth] = _step_ms(rec)
            if not same(_losses(rec), L[:RESILIENT_SLOW_STEPS]):
                raise AssertionError(f"train_resilient (e): depth {depth} losses {_losses(rec)}")
            steps += len(rec["losses"])
            del state, step, rec
        emit(phase="train_resilient", run="e", slow_fetch_s=RESILIENT_SLOW_S,
             step_ms_depth_2=spread(slow[2][1:]), step_ms_depth_0=spread(slow[0][1:]))

        torch.cuda.synchronize()
        counts = {k: ctx["launches"][k] + v for k, v in flash_counts().items()}
        expected = {"B1a": (1 + layers) * steps + layers * steps, "B1b": (1 + layers) * steps}
        emit(phase="train_resilient", steps=steps, launches=counts, expected_launches=expected,
             pinned_host_bytes=ckpt.PINNED.nbytes,
             max_memory_allocated_gib=max(ctx["peak"], torch.cuda.max_memory_allocated()) / 2**30,
             free_disk_before=ctx["free_before"], free_disk_with_two_generations=free_during,
             free_disk_after=shutil.disk_usage(root).free, child_wait_s=child_wait_s,
             seconds=ctx["seconds"] + time.perf_counter() - t_phase)
        if counts != expected:
            raise AssertionError(f"train_resilient: launches {counts}, expected {expected} for {steps} steps")
        return counts
    finally:
        train_resilient_cleanup(ctx)




def train_30m():
    """The 30M recipe (bench.py's clm_30m and the CLM script's defaults:
    sequence 4096, 512 latents, 512 channels, 8 heads of 64, 8 layers,
    cross-attention dropout 0.5 in gather mode, batch 8, bf16 compute; AdamW
    at 2e-4, cosine schedule with 200 warm-up updates, clipping at 0.5)
    through run_fit / Trainer.fit on the Markov data module: 10 steps and
    one eval. Returns the B1 launches of the run."""
    cfg = CausalSequenceModelConfig(vocab_size=262, max_seq_len=4096, max_latents=512, num_channels=512,
                                    num_heads=8, num_self_attention_layers=8, cross_attention_dropout=0.5,
                                    fused_qkv=True)
    data = SyntheticTextDataModule(seq_len=cfg.max_seq_len, batch_size=8, seed=SEED)
    data.setup()
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    max_steps = 10
    tx = build_tx(OptimizerFlags(lr=2e-4, warmup_steps=200, schedule="cosine", max_grad_norm=0.5), max_steps)
    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    trainer_cfg = TrainerConfig(max_steps=max_steps, log_every=5, eval_every=max_steps,
                                tokens_per_batch=flops.tokens_per_step(data.batch_size),
                                flops_per_step=flops.train_flops_per_step(data.batch_size),
                                peak_flops=detect_peak_flops())
    lines = []
    torch.cuda.synchronize()
    fl.forward_launches = fl.backward_launches = 0
    t0 = time.perf_counter()
    run_fit(trainer_cfg, TrainState.create(model, tx, seed=SEED),
            make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents), data,
            eval_step=make_causal_lm_eval_step(model, max_latents=cfg.max_latents),
            log_fn=lambda line: (lines.append(json.loads(line)), emit(phase="train_30m", **json.loads(line))))
    torch.cuda.synchronize()
    counts = flash_counts()
    layers = cfg.num_self_attention_layers
    eval_batches = len(data.val_dataloader())
    expected = {"B1a": (1 + layers) * (max_steps + eval_batches), "B1b": (1 + layers) * max_steps}
    val = [ln["val_loss"] for ln in lines if "val_loss" in ln]
    emit(phase="train_30m", steps=max_steps, seconds=time.perf_counter() - t0, launches=counts,
         expected_launches=expected, eval_batches=eval_batches, val_loss=val, entropy_floor=data.entropy_floor)
    if counts != expected:
        raise AssertionError(f"30M fit: launches {counts}, expected {expected}")
    if len(val) != 1 or not math.isfinite(val[0]):
        raise AssertionError(f"30M fit: eval loss {val}")
    del model
    torch.cuda.empty_cache()
    return counts


# ------------------------------------- phase 7b: Perceiver AR's other faces
FACES_BATCH = 16
FACES_SETTINGS = {  # name: (activation_checkpointing, remat_policy, activation_offloading)
    "no_checkpoint": (False, None, False),
    "full_recompute": (True, None, False),
    **{policy: (True, policy, False) for policy in REMAT_POLICIES},
    "offload": (True, None, True),
    "offload_dots_with_no_batch_dims": (True, "dots_with_no_batch_dims_saveable", True),
}
FACES_ALIASES = {"checkpoint_dots": "dots_saveable",
                 "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable"}
FACES_TEXT_BYTES = 2_000_000  # the python-source corpus the CLM recipe trains on
FACES_TEXT_CHUNK = 65_536  # characters a source text
FACES_TEXT_STEPS = 10
FACES_PROMPTS = 8
FACES_NEW_TOKENS = 32
FACES_AUDIO_PROMPT = 2048
FACES_AUDIO_NEW_TOKENS = 64
FACES_AUDIO_FILES = 24
FACES_AUDIO_BATCH = 8


def faces_text_config() -> CausalLanguageModelConfig:
    """The 30.7M CLM recipe (scripts/text/clm.py's MODEL_DEFAULTS and the
    30M train config) with activation checkpointing and offloading."""
    return CausalLanguageModelConfig(vocab_size=262, max_seq_len=4096, max_latents=512, num_channels=512, num_heads=8,
                                     num_self_attention_layers=8, cross_attention_dropout=0.5, fused_qkv=True,
                                     activation_checkpointing=True, activation_offloading=True)


def faces_audio_config() -> SymbolicAudioModelConfig:
    """The GiantMIDI recipe (scripts/audio/symbolic.py's MODEL_DEFAULTS and
    DATA_DEFAULTS' sequence): 134M parameters."""
    return SymbolicAudioModelConfig(vocab_size=389, max_seq_len=6144, max_latents=2048, num_channels=768, num_heads=8,
                                    num_self_attention_layers=18, cross_attention_dropout=0.1,
                                    post_attention_dropout=0.1, residual_dropout=0.1, output_norm=True,
                                    output_bias=False, abs_pos_emb=False, activation_checkpointing=True)


def _loss_and_grads(model, batch, max_latents, generator=None):
    """The causal-LM train step's loss and gradients (labels -100 under pads,
    CE over the latent logits), with no optimizer update."""
    x = batch["input_ids"]
    prefix_len = x.shape[1] - max_latents
    labels = batch["labels"]
    pad_mask = batch.get("pad_mask")
    if pad_mask is not None:
        labels = labels.masked_fill(pad_mask, -100)
    model.train()
    logits = model(x, prefix_len=prefix_len, pad_mask=pad_mask, generator=generator)
    loss = cross_entropy(logits, labels[:, prefix_len:])
    return loss.detach(), torch.autograd.grad(loss, trainable(model), materialize_grads=True)


def _grad_error_over_rms(got, want) -> float:
    """The largest max |got - want| / RMS(want) over the gradient tensors."""
    return max(((a.float() - b.float()).abs().max() / b.float().pow(2).mean().sqrt().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def _timed_setting(model, block, plan, batch, max_latents, steps, generator_seed=None):
    """Swap ``block``'s remat plan, reset the peak, then one warm-up step and
    ``steps`` timed ones: (first loss, first gradients, the warm-up's ms,
    the timed steps' ms, peak bytes, B1a and B1b a timed step, bytes to and
    from the host a timed step)."""
    block.remat = plan
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = lambda: None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    zero_counts()
    offload.reset_stats()
    t0 = time.perf_counter()
    loss, grads = _loss_and_grads(model, batch, max_latents, gen())
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    zero_counts()
    offload.reset_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, g = _loss_and_grads(model, batch, max_latents, gen())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del g
    counts = {k: v / steps for k, v in flash_counts().items()}
    moved = {k: offload.STATS[k] / steps for k in ("d2h_bytes", "h2d_bytes")}
    return loss, grads, first_ms, ms, torch.cuda.max_memory_allocated(), counts, moved


def faces_remat(model, init):
    """(a) The flagship (``model``, from the seeded weights ``init``) at
    batch FACES_BATCH on a fixed seeded batch under every remat setting: no
    checkpointing, None, the JAX package's six policy names, and offloading
    with None and with dots_with_no_batch_dims_saveable, each a train step's
    forward and backward (no update) from the same weights: one warm-up step
    and 2 timed ones. Gates: the first step's loss the same bits under every
    setting; every gradient within 1e-3 x its RMS of the no-checkpoint
    step's; each alias its target's launches and peak (1 %); offloading's
    peak below the dots_with_no_batch_dims_saveable peak by at least half the
    bytes it moves to the host a step; B1a 21 a step without checkpointing
    or under everything_saveable and 41 otherwise (the self-attention
    layers' recomputes), B1b 21. Peaks from the second setting on hold the
    no-checkpoint gradients kept for the comparison. Returns the launches."""
    cfg = model.config
    layers = cfg.num_self_attention_layers
    g = torch.Generator(DEVICE).manual_seed(SEED + 24)
    x = torch.randint(0, cfg.vocab_size, (FACES_BATCH, cfg.max_seq_len), generator=g, device=DEVICE)
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    block = model.ar.self_attention
    plan = block.remat
    ref_loss = ref_grads = None
    rows, launches = {}, {"B1a": 0, "B1b": 0}
    for name, (ac, policy, off) in FACES_SETTINGS.items():
        model.load_state_dict(init)
        loss, grads, first_ms, ms, peak, counts, moved = _timed_setting(
            model, block, remat_plan(policy, ac, off), batch, cfg.max_latents, 2)
        for k in launches:
            launches[k] += int(counts[k] * 2)
        if ref_grads is None:
            ref_loss, ref_grads = loss, grads
        rows[name] = dict(
            first_step_ms=first_ms, ms_per_step=ms, max_memory_allocated_bytes=peak, b1a_per_step=counts["B1a"], b1b_per_step=counts["B1b"],
            first_loss=loss.item(), loss_bits_equal=bool(torch.equal(loss, ref_loss)),
            max_grad_err_over_rms=_grad_error_over_rms(grads, ref_grads),
            grads_bit_identical=all(torch.equal(a, b) for a, b in zip(grads, ref_grads)),
            d2h_bytes_per_step=moved["d2h_bytes"], h2d_bytes_per_step=moved["h2d_bytes"],
            pinned_host_bytes=offload.POOL.nbytes if off else 0)
        del grads
        emit(phase="perceiver_ar_faces", part="remat", model="flagship_455m", batch=FACES_BATCH, setting=name,
             activation_checkpointing=ac, remat_policy=policy, activation_offloading=off, **rows[name])
    block.remat = plan
    model.load_state_dict(init)
    del ref_grads
    offload.POOL.clear()
    torch.cuda.empty_cache()
    for name, row in rows.items():
        ac, policy, _ = FACES_SETTINGS[name]
        b1a = 1 + layers + (layers if ac and policy != "everything_saveable" else 0)
        if (row["b1a_per_step"], row["b1b_per_step"]) != (b1a, 1 + layers):
            raise AssertionError(f"remat {name}: B1a/B1b a step {row['b1a_per_step']}/{row['b1b_per_step']}, "
                                 f"expected {b1a}/{1 + layers}")
        if not (row["loss_bits_equal"] and row["max_grad_err_over_rms"] <= 1e-3):
            raise AssertionError(f"remat {name}: loss bits equal {row['loss_bits_equal']}, gradient error "
                                 f"{row['max_grad_err_over_rms']} x RMS (limit 1e-3)")
    for alias, target in FACES_ALIASES.items():
        a, t = rows[alias], rows[target]
        if a["b1a_per_step"] != t["b1a_per_step"] or abs(a["max_memory_allocated_bytes"] -
                                                         t["max_memory_allocated_bytes"]) > 0.01 * t[
                "max_memory_allocated_bytes"]:
            raise AssertionError(f"remat alias {alias}: launches {a['b1a_per_step']} peak "
                                 f"{a['max_memory_allocated_bytes']}, {target}: {t['b1a_per_step']} "
                                 f"{t['max_memory_allocated_bytes']}")
    dots = rows["dots_with_no_batch_dims_saveable"]
    for name in ("offload", "offload_dots_with_no_batch_dims"):
        row = rows[name]
        if not (row["d2h_bytes_per_step"] > 0 and row["max_memory_allocated_bytes"]
                <= dots["max_memory_allocated_bytes"] - row["d2h_bytes_per_step"] / 2):
            raise AssertionError(f"remat {name}: peak {row['max_memory_allocated_bytes']} against the dots policy's "
                                 f"{dots['max_memory_allocated_bytes']}, {row['d2h_bytes_per_step']} bytes "
                                 f"offloaded a step")
    return launches


class _PythonSourceText(TextDataModule):
    """The CLM recipe's data module over the installed torch and numpy
    sources: the python-source corpus's first FACES_TEXT_BYTES bytes as
    FACES_TEXT_CHUNK-character texts, the last two for validation."""

    def load_source_dataset(self):
        corpus = python_source_corpus(FACES_TEXT_BYTES, packages=("torch", "numpy"))
        if len(corpus) < FACES_TEXT_BYTES:
            raise AssertionError(f"python-source corpus: {len(corpus)} bytes, expected {FACES_TEXT_BYTES}")
        text = corpus.tobytes().decode("utf-8", errors="replace")
        texts = [text[i:i + FACES_TEXT_CHUNK] for i in range(0, len(text), FACES_TEXT_CHUNK)]
        return {"train": texts[:-2], "valid": texts[-2:]}


def faces_text(tmp):
    """(b) CausalLanguageModel at the 30.7M recipe's full width
    (scripts/text/clm.py: sequence 4096, 512 latents, 512 channels, 8 heads
    of 64, 8 layers, gather prefix dropout 0.5, vocab 262), bf16 compute,
    with activation checkpointing and offloading, trained FACES_TEXT_STEPS
    steps and one eval through run_fit on the recipe's TextDataModule
    (bytes, left padding, random train shift, batch 20) prepared from the
    python-source corpus; then TextGenerationPipeline: FACES_PROMPTS prompts
    cut from the valid split through its engine (greedy,
    FACES_NEW_TOKENS new tokens), each output equal to generate() on the
    engine's canonical padding (the prompts left-padded to the window,
    num_latents = max_latents, as one batch of the engine's 8 slots), and
    one prompt through the direct path with num_latents 16. Gates: finite
    losses, windows of 4,097 tokens shifted by one, exact B1 counts, B2
    launched. Returns the launches."""
    cfg = faces_text_config()
    t0 = time.perf_counter()
    data = _PythonSourceText(os.path.join(tmp, "text"), tokenizer="bytes", max_seq_len=cfg.max_seq_len,
                             task=Task.clm, padding_side="left", random_train_shift=True, batch_size=20, seed=SEED)
    data.prepare_data()
    data.setup()
    prepare_s = time.perf_counter() - t0
    example = data.ds_train[0]
    chunk = data.ds_train.dataset.dataset.chunks[0]
    shifted = (len(chunk) == cfg.max_seq_len + 1 and len(example["input_ids"]) == cfg.max_seq_len
               and list(example["input_ids"][1:]) == list(example["label_ids"][:-1]))
    model = CausalLanguageModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    tx = build_tx(OptimizerFlags(lr=2e-4, warmup_steps=200, schedule="cosine", max_grad_norm=0.5), FACES_TEXT_STEPS)
    lines = []
    trainer_cfg = TrainerConfig(max_steps=FACES_TEXT_STEPS, log_every=5, eval_every=FACES_TEXT_STEPS)
    torch.cuda.synchronize()
    zero_counts()
    offload.reset_stats()
    t1 = time.perf_counter()
    run_fit(trainer_cfg, TrainState.create(model, tx, seed=SEED),
            make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents), data,
            eval_step=make_causal_lm_eval_step(model, max_latents=cfg.max_latents),
            log_fn=lambda line: lines.append(json.loads(line)))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    counts = flash_counts()
    layers = cfg.num_self_attention_layers
    eval_batches = len(data.val_dataloader())
    expected = {"B1a": (1 + 2 * layers) * FACES_TEXT_STEPS + (1 + layers) * eval_batches,
                "B1b": (1 + layers) * FACES_TEXT_STEPS}
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    val = [ln["val_loss"] for ln in lines if "val_loss" in ln]
    moved = dict(offload.STATS)
    offload.POOL.clear()

    model.eval()  # generation runs in eval mode
    tok = ByteTokenizer()
    valid = data.ds_valid.dataset.chunks
    step = (cfg.max_seq_len - cfg.max_latents) // 16
    prompts = [tok.decode(valid[i][: cfg.max_latents + (i + 1) * step].tolist()) for i in range(FACES_PROMPTS)]
    pipe = TextGenerationPipeline(model)
    dk.launches = 0
    t2 = time.perf_counter()
    out = pipe(prompts, max_new_tokens=FACES_NEW_TOKENS)
    engine_s = time.perf_counter() - t2
    engine_b2 = dk.launches
    window = cfg.max_seq_len
    ids = torch.full((FACES_PROMPTS, window), tok.pad_token_id, dtype=torch.long)
    pad = torch.ones(FACES_PROMPTS, window, dtype=torch.bool)
    for i, p in enumerate(prompts):
        enc = tok.encode(p)
        ids[i, window - len(enc):] = torch.tensor(enc)
        pad[i, window - len(enc):] = False
    want = generate(model, ids, num_latents=cfg.max_latents, pad_mask=pad, max_new_tokens=FACES_NEW_TOKENS)
    canonical = [p + tok.decode([t for t in row[window:].tolist() if t != tok.pad_token_id])
                 for p, row in zip(prompts, want.cpu())]
    same = [a == b for a, b in zip(out, canonical)]
    t3 = time.perf_counter()
    direct = pipe(prompts[0], num_latents=16, max_new_tokens=FACES_NEW_TOKENS)
    direct_s = time.perf_counter() - t3
    b2 = dk.launches
    emit(phase="perceiver_ar_faces", part="text_clm", model="clm_30m", steps=FACES_TEXT_STEPS, prepare_s=prepare_s,
         train_chunks=len(data.ds_train), valid_chunks=len(valid), windows_shifted=shifted, fit_s=fit_s,
         losses=losses, val_loss=val, launches=counts, expected_launches=expected, eval_batches=eval_batches,
         offload_d2h_bytes=moved["d2h_bytes"], offload_h2d_bytes=moved["h2d_bytes"],
         engine_slots=pipe._engine_inst.num_slots, engine_s=engine_s, engine_b2=engine_b2,
         engine_equals_generate=same, direct_s=direct_s, direct_chars=len(direct) - len(prompts[0]), b2=b2)
    if not (shifted and losses and all(math.isfinite(v) for v in losses + val) and len(val) == 1):
        raise AssertionError(f"text_clm: windows shifted {shifted}, losses {losses}, eval {val}")
    if counts != expected:
        raise AssertionError(f"text_clm: launches {counts}, expected {expected}")
    if not all(same):
        raise AssertionError(f"text_clm: engine outputs differ from generate() on the canonical padding: {same}")
    if not (engine_b2 and b2 > engine_b2 and moved["d2h_bytes"] > 0):
        raise AssertionError(f"text_clm: B2 {engine_b2} / {b2}, offloaded {moved['d2h_bytes']} bytes")
    pipe._engine_inst.close()
    del pipe, model
    torch.cuda.empty_cache()
    return {"B1a": counts["B1a"], "B1b": counts["B1b"], "B2": b2}


def _audio_notes(rng, n):
    """``n`` seeded notes (overlapping chords and runs) and a sustain pedal
    pressed and released every few seconds."""
    notes, t = [], 0.0
    for _ in range(n):
        t += float(rng.choice([0.0, 0.05, 0.12, 0.25, 0.5]))
        notes.append(Note(int(rng.integers(21, 109)), int(rng.integers(20, 128)), round(t, 2),
                          round(t + float(rng.choice([0.1, 0.2, 0.4, 0.8, 1.6])), 2)))
    pedal = [ControlChange(64, 127 if i % 2 == 0 else 0, round(1.5 * i + 0.3, 2)) for i in range(int(t / 1.5))]
    return notes, pedal


def faces_audio(tmp):
    """(c) SymbolicAudioModel at the GiantMIDI recipe's full width
    (scripts/audio/symbolic.py: sequence 6,144, 2,048 latents, 768
    channels, 8 heads of 96, 18 layers, vocab 389, dropouts 0.1, output
    norm, checkpointing), bf16 compute from seeded weights. A seeded note
    list with a sustain pedal through write_smf, then SymbolicAudioPipeline
    from the file with max_prompt_tokens 2048, FACES_AUDIO_NEW_TOKENS greedy
    tokens and output_midi_path: its notes equal generate()'s on the same
    prompt, the written file read back by read_smf re-encodes to the
    generated tokens' notes, B2 launched (D 96). Then one train step's
    forward and backward at batch 8 (a warm-up, whose offloading allocates
    the pinned pool, and one timed) on a SymbolicAudioDataModule prepared
    from FACES_AUDIO_FILES seeded .mid files, under
    dots_with_no_batch_dims_saveable and with offloading, on the same batch
    and dropout seed: the losses the same bits, the gradients within 1e-3 x
    their RMS, offloading's peak below the dots policy's. Returns the
    launches."""
    cfg = faces_audio_config()
    model = SymbolicAudioModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED + 24)
    notes, pedal = _audio_notes(rng, 900)
    prompt_path, out_path = os.path.join(tmp, "prompt.mid"), os.path.join(tmp, "continued.mid")
    write_smf(prompt_path, notes, pedal)
    tokens = encode_notes(read_smf(prompt_path).notes, read_smf(prompt_path).control_changes)[-FACES_AUDIO_PROMPT:]
    dk.launches = 0
    t0 = time.perf_counter()
    doc = SymbolicAudioPipeline(model)(prompt_path, max_prompt_tokens=FACES_AUDIO_PROMPT,
                                       max_new_tokens=FACES_AUDIO_NEW_TOKENS, output_midi_path=out_path)
    pipeline_s = time.perf_counter() - t0
    b2 = dk.launches
    out = generate(model, torch.tensor(tokens)[None], max_new_tokens=FACES_AUDIO_NEW_TOKENS)[0].tolist()
    want_notes = decode_notes(out)
    same = [dataclasses.astuple(n) for n in doc.notes] == [dataclasses.astuple(n) for n in want_notes]
    reread = read_smf(out_path)
    reencoded = encode_notes(reread.notes, reread.control_changes) == encode_notes(want_notes)
    emit(phase="perceiver_ar_faces", part="symbolic_audio_generate", model="giantmidi_134m", params=params,
         prompt_tokens=len(tokens), new_tokens=FACES_AUDIO_NEW_TOKENS, pipeline_s=pipeline_s, b2=b2,
         notes_out=len(doc.notes), equals_generate=same, reread_reencodes=reencoded)
    if not (len(tokens) == FACES_AUDIO_PROMPT and same and reencoded and b2):
        raise AssertionError(f"symbolic_audio: prompt {len(tokens)} tokens, equals generate() {same}, re-read "
                             f"re-encodes {reencoded}, B2 {b2}")

    source = {}
    for split, n in (("train", FACES_AUDIO_FILES), ("valid", 2)):
        d = os.path.join(tmp, "midi", split)
        os.makedirs(d)
        for i in range(n):
            write_smf(os.path.join(d, f"{i}.mid"), *_audio_notes(rng, 1000))
        source[split] = d

    class LocalMidi(SymbolicAudioDataModule):
        def load_source_dataset(self):
            return source

    data = LocalMidi(os.path.join(tmp, "giantmidi"), max_seq_len=cfg.max_seq_len, min_seq_len=cfg.max_latents,
                     padding_side="left", batch_size=FACES_AUDIO_BATCH, seed=SEED)
    data.prepare_data()
    data.setup()
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(iter(data.train_dataloader())).items()}
    block = model.ar.self_attention
    runs = {}
    for name, off in (("dots_with_no_batch_dims_saveable", False), ("offload", True)):
        loss, grads, first_ms, ms, peak, counts, moved = _timed_setting(
            model, block, remat_plan("dots_with_no_batch_dims_saveable", True, off), batch, cfg.max_latents, 1,
            generator_seed=SEED + 7)
        runs[name] = (loss, grads, peak, moved)
        emit(phase="perceiver_ar_faces", part="symbolic_audio_train", setting=name, batch=FACES_AUDIO_BATCH,
             loss=loss.item(), first_step_ms=first_ms, ms=ms[0], max_memory_allocated_bytes=peak,
             pinned_host_bytes=offload.POOL.nbytes if off else 0, d2h_bytes=moved["d2h_bytes"],
             h2d_bytes=moved["h2d_bytes"], b1a=counts["B1a"], b1b=counts["B1b"])
    (l0, g0, p0, _), (l1, g1, p1, moved) = runs.values()
    err = _grad_error_over_rms(g1, g0)
    emit(phase="perceiver_ar_faces", part="symbolic_audio_train", losses_bits_equal=bool(torch.equal(l0, l1)),
         max_grad_err_over_rms=err, grads_bit_identical=all(torch.equal(a, b) for a, b in zip(g0, g1)),
         peak_dots=p0, peak_offload=p1, offloaded_bytes=moved["d2h_bytes"])
    if not (torch.equal(l0, l1) and err <= 1e-3 and p1 < p0 and moved["d2h_bytes"] > 0):
        raise AssertionError(f"symbolic_audio train: losses {l0.item()} / {l1.item()}, gradient error {err} x RMS, "
                             f"peaks {p0} / {p1}")
    del runs, g0, g1, model
    offload.POOL.clear()
    torch.cuda.empty_cache()
    return {"B2": b2}


def perceiver_ar_faces(flagship, init):
    """Phase perceiver_ar_faces: (a) faces_remat on the flagship, (b)
    faces_text, (c) faces_audio; prints the phase's seconds. Returns the
    launches of its main paths, counted from 0 before each."""
    t0 = time.perf_counter()
    launches = faces_remat(flagship, init)
    with tempfile.TemporaryDirectory() as tmp:
        text = faces_text(tmp)
        audio = faces_audio(tmp)
    for k, v in text.items():
        launches[k] = launches.get(k, 0) + v
    launches["B2"] += audio["B2"]
    emit(phase="perceiver_ar_faces", seconds=time.perf_counter() - t0, launches=launches, nvidia_smi=card_line())
    return launches


def card_vs_cpu_train():
    """The flagship at full width with 2 layers, float32 parameters and
    compute (TF32 off), batch 2, no dropout: the card's loss within 1e-5
    relative of the port's CPU run, every gradient within 1e-3 x its RMS,
    then 3 AdamW steps (1e-3, clipping at 1.0) whose losses agree to 1e-4
    relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 7))
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    prefix = cfg.max_seq_len - cfg.max_latents

    def loss_and_grads(model, b):
        model.train()
        loss = cross_entropy(model(b["input_ids"], prefix), b["labels"][:, prefix:])
        return loss, torch.autograd.grad(loss, trainable(model))

    l_cpu, g_cpu = loss_and_grads(cpu, batch)
    l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
    loss_rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    names = [n for n, p in cpu.named_parameters() if p.requires_grad]
    grad_ratio = {n: ((a.cpu() - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-30)).item()
                  for n, a, b in zip(names, g_gpu, g_cpu)}
    worst = max(grad_ratio, key=grad_ratio.get)
    del g_cpu, g_gpu

    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
        tx = build_optimizer(1e-3, max_grad_norm=1.0)
        state = TrainState.create(model, tx, seed=SEED)
        step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
        runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="train", layers=2, batch=2, loss_rel_err=loss_rel, loss_rtol=1e-5,
         max_grad_err_over_rms=grad_ratio[worst], worst_grad=worst, grad_limit=1e-3, step_losses=runs,
         step_loss_rel_err=step_rel, step_rtol=1e-4)
    if not (loss_rel <= 1e-5 and grad_ratio[worst] <= 1e-3 and step_rel <= 1e-4):
        raise AssertionError(f"train card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {grad_ratio[worst]} "
                             f"x RMS (1e-3), steps {step_rel} (1e-4)")


# ------------------------------------- phase 6b: sequence-parallel training
SP_AXES = {"seq": 4}
BENCH_LR = 1e-3  # bench.py's learning rate for clm_8k
# at BENCH_LR the loss on this fixed batch rises after the third step, through
# the ring and through the plain path alike (sp_lr_check shows both), so the
# phase that must see the loss fall takes 3e-4
SP_LR = 3e-4
SP_CHECK_STEPS = 6
SP_CHECK_RTOL = 2e-2


def clm_8k_sp_config(layers: int = 8) -> CausalSequenceModelConfig:
    """clm_8k (bench.py's clm_8k_bench_config: the Perceiver AR paper's 8k
    regime on the 30M-class architecture) with ``sequence_parallel_axis="seq"``
    and ``layers`` self-attention layers."""
    return dataclasses.replace(clm_8k_config(), num_self_attention_layers=layers, sequence_parallel_axis="seq")


def card_mesh(device=None):
    """``SP_AXES`` with one device (the card) standing at every position."""
    return make_mesh(SP_AXES, devices=[torch.device(device or DEVICE)] * math.prod(SP_AXES.values()))


def ring_schedule(cfg: CausalSequenceModelConfig, batch_seq_len: int):
    """Per train step of ``cfg`` under ``SP_AXES``: the fully visible,
    diagonal and hidden (query position, key block) pairs of the
    cross-attention ring (latents over the kept prefix and the latents) and
    of one self-attention ring, and the B5 launches and forward einsum blocks
    a step makes: each visible pair is one launch, once for the
    cross-attention and twice for each self-attention layer (the dots policy
    recomputes it). Counted from the full right-aligned causal mask (query i
    of Nq sees keys 0..Nk - Nq + i), cut into the mesh's blocks, not from the
    ring's own classifier."""
    n_seq = SP_AXES["seq"]
    prefix = batch_seq_len - cfg.max_latents
    keys = prefix - int(prefix * cfg.cross_attention_dropout) + cfg.max_latents

    def kinds(nq, nk):
        seen = torch.arange(nk)[None, :] <= (nk - nq + torch.arange(nq))[:, None]
        blocks = seen.reshape(n_seq, nq // n_seq, n_seq, nk // n_seq).transpose(1, 2).flatten(2)
        whole, some = blocks.all(-1), blocks.any(-1)
        return dict(visible=int(whole.sum()), diagonal=int((some & ~whole).sum()), hidden=int((~some).sum()))

    cross, self_ = kinds(cfg.max_latents, keys), kinds(cfg.max_latents, cfg.max_latents)
    runs = 1 + (cfg.activation_checkpointing and cfg.remat_policy is not None)
    layers = cfg.num_self_attention_layers
    return dict(
        cross_keys=keys, cross_visible=cross["visible"], cross_diagonal=cross["diagonal"],
        self_visible=self_["visible"], self_diagonal=self_["diagonal"], self_hidden=self_["hidden"],
        self_attention_runs_per_layer=runs,
        b5_per_step=cross["visible"] + layers * runs * self_["visible"],
        diagonal_blocks_per_step=cross["diagonal"] + layers * runs * self_["diagonal"],
    )


def sp_counts():
    return {"B5": fl.block_launches, "B1a": fl.forward_launches, "B1b": fl.backward_launches}


def zero_counts():
    fl.forward_launches = fl.backward_launches = fl.block_launches = 0
    fl.forward_launches_by_dtype.clear()
    fl.backward_launches_by_dtype.clear()
    dk.launches = pk.launches = rk.launches = 0


def train_sp():
    """clm_8k at full width and depth with sequence_parallel_axis="seq"
    under a {"seq": 4} mesh of the one card: bf16 compute over f32
    parameters, batch 4 (bench.py's clm_8k batch), random ids from SEED with
    labels rolled by one, AdamW at SP_LR with clipping at 1.0. 2 warm-up steps,
    then REPEATS windows of TRAIN_STEPS steps; every attention runs as ring
    attention (B5 for the fully visible blocks, einsum for the diagonal
    ones, the backward ring in plain PyTorch), so B1 is never launched. The
    batch is fixed, so the loss must fall."""
    cfg = clm_8k_sp_config()
    batch = 4
    sched = ring_schedule(cfg, cfg.max_seq_len)
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    tx = build_optimizer(SP_LR, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    peak = detect_peak_flops()
    with set_mesh(card_mesh()):
        first = None
        for _ in range(2):
            state, metrics = step(state, data)
            first = float(metrics["loss"]) if first is None else first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        ms_per_step, step_losses = [], []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, data)
                step_losses.append(metrics["loss"])
            float(metrics["loss"])  # the window's one host read; steps depend on each other
            ms_per_step.append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
        counts = sp_counts()
    steps = REPEATS * TRAIN_STEPS
    losses = [float(v) for v in step_losses]
    expected = {"B5": sched["b5_per_step"] * steps, "B1a": 0, "B1b": 0}
    tokens_per_s = [flops.tokens_per_step(batch) / (ms / 1e3) for ms in ms_per_step]
    emit(phase="train_sp", model="clm_8k", mesh=SP_AXES, devices="one card at every position", batch=batch,
         layers=cfg.num_self_attention_layers, dtype="bfloat16 compute, float32 params", remat_policy=cfg.remat_policy,
         lr=SP_LR, steps=steps, launches=counts, expected_launches=expected, schedule=sched,
         b5_launch_is="one (query position, fully visible key block) pair of one ring forward: per step "
                      f"{sched['cross_visible']} cross-attention + {cfg.num_self_attention_layers} layers x "
                      f"{sched['self_attention_runs_per_layer']} runs (forward and checkpoint recompute) x "
                      f"{sched['self_visible']} self-attention",
         ms_per_step=spread(ms_per_step), latent_tokens_per_s=spread(tokens_per_s),
         mfu=None if peak is None else spread([flops.train_flops_per_step(batch) / (ms / 1e3) / peak
                                               for ms in ms_per_step]),
         peak_flops=peak, train_flops_per_step=flops.train_flops_per_step(batch),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, first_loss=first, step_losses=losses)
    if counts != expected:
        raise AssertionError(f"clm_8k SP train: launches {counts}, expected {expected} for {steps} steps")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < first:
        raise AssertionError(f"clm_8k SP train: the loss did not fall from {first}: {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


def sp_lr_check():
    """train_sp's model, batch and generator seed at full width and depth
    (bf16 compute over f32 parameters, batch 4), SP_CHECK_STEPS steps from
    the same weights and optimizer state through the ring under {"seq": 4}
    (B5 and einsum blocks) and through the same model without the seq axis
    (B1), at BENCH_LR and at SP_LR: the two paths' losses within
    SP_CHECK_RTOL relative at every step (bf16 rounds the two paths'
    attention apart, and Adam's steps carry that on), and both falling at
    SP_LR. All four trajectories are printed, so whether the loss rises at
    BENCH_LR is read for both paths."""
    cfg = clm_8k_sp_config()
    batch = 4
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    init = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED).state_dict()
    runs, counts = {}, {}
    for lr in (BENCH_LR, SP_LR):
        for path, axis in (("ring", "seq"), ("plain", None)):
            model = CausalSequenceModel(dataclasses.replace(cfg, sequence_parallel_axis=axis), device=DEVICE,
                                        dtype=torch.bfloat16, seed=SEED + 99)
            model.load_state_dict(init)
            tx = build_optimizer(lr, max_grad_norm=1.0)
            state = TrainState.create(model, tx, seed=SEED)
            step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
            zero_counts()
            losses = []
            with set_mesh(card_mesh()) if axis else contextlib.nullcontext():
                for _ in range(SP_CHECK_STEPS):
                    state, metrics = step(state, data)
                    losses.append(metrics["loss"])
            runs[f"{path}@{lr:g}"] = [float(v) for v in losses]
            counts[f"{path}@{lr:g}"] = sp_counts()
            del model, state, step
    rel = {f"{lr:g}": max(abs(a - b) / abs(b) for a, b in zip(runs[f"ring@{lr:g}"], runs[f"plain@{lr:g}"]))
           for lr in (BENCH_LR, SP_LR)}
    emit(phase="sp_lr_check", model="clm_8k", mesh=SP_AXES, batch=batch, layers=cfg.num_self_attention_layers,
         dtype="bfloat16 compute, float32 params", steps=SP_CHECK_STEPS, step_losses=runs, launches=counts,
         max_step_loss_rel_err=rel, rtol=SP_CHECK_RTOL,
         rises_at_bench_lr={p: max(runs[f"{p}@{BENCH_LR:g}"][1:]) > runs[f"{p}@{BENCH_LR:g}"][0]
                            for p in ("ring", "plain")})
    torch.cuda.empty_cache()
    for key, c in counts.items():
        took_own = (c["B5"] and not c["B1a"]) if key.startswith("ring") else (c["B1a"] and not c["B5"])
        if not took_own:
            raise AssertionError(f"sp_lr_check: {key} took {c}")
    if not all(math.isfinite(v) for r in runs.values() for v in r) or max(rel.values()) > SP_CHECK_RTOL:
        raise AssertionError(f"sp_lr_check: ring vs plain losses differ by {rel} (rtol {SP_CHECK_RTOL}): {runs}")
    for p in ("ring", "plain"):
        r = runs[f"{p}@{SP_LR:g}"]
        if not r[-1] < r[0]:
            raise AssertionError(f"sp_lr_check: the {p} path's loss did not fall at {SP_LR}: {r}")


def _grad_ratios(model, got, want):
    """max |got - want| / RMS(want) per trainable parameter (name -> ratio)."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {n: ((a.cpu() - b.cpu()).abs().max() / b.cpu().pow(2).mean().sqrt().clamp_min(1e-30)).item()
            for n, a, b in zip(names, got, want)}


def card_vs_card_sp():
    """clm_8k at full width and sequence with 2 layers, f32 (TF32 off),
    batch 2, training mode: the ring under {"seq": 4} (B5 and einsum blocks)
    against the same weights without the seq axis (B1), with the same
    generator seed (so the same prefix-dropout draws on the card): loss
    within 1e-5 relative, every gradient within 1e-3 x its RMS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = clm_8k_sp_config(layers=2)
    sp = CausalSequenceModel(cfg, device=DEVICE, seed=SEED)
    plain = CausalSequenceModel(dataclasses.replace(cfg, sequence_parallel_axis=None), device=DEVICE, seed=SEED + 99)
    plain.load_state_dict(sp.state_dict())
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 8))
    x, labels = x.to(DEVICE), torch.roll(x, -1, dims=1).to(DEVICE)
    prefix = cfg.max_seq_len - cfg.max_latents

    def loss_and_grads(model):
        model.train()
        zero_counts()
        loss = cross_entropy(model(x, prefix, generator=torch.Generator().manual_seed(SEED)), labels[:, prefix:])
        grads = torch.autograd.grad(loss, trainable(model))
        torch.cuda.synchronize()
        return loss.item(), grads, sp_counts()

    with set_mesh(card_mesh()):
        l_ring, g_ring, ring_counts = loss_and_grads(sp)
    l_plain, g_plain, plain_counts = loss_and_grads(plain)
    loss_rel = abs(l_ring - l_plain) / abs(l_plain)
    ratio = _grad_ratios(sp, g_ring, g_plain)
    worst = max(ratio, key=ratio.get)
    emit(phase="card_vs_card", path="train_sp", model="clm_8k", layers=2, batch=2, mesh=SP_AXES,
         ring_loss=l_ring, plain_loss=l_plain, loss_rel_err=loss_rel, loss_rtol=1e-5,
         max_grad_err_over_rms=ratio[worst], worst_grad=worst, grad_limit=1e-3, ring_launches=ring_counts,
         plain_launches=plain_counts)
    if not (ring_counts["B5"] and not ring_counts["B1a"] and plain_counts["B1a"] and not plain_counts["B5"]):
        raise AssertionError(f"card vs card: the ring took {ring_counts}, the plain model {plain_counts}")
    if not (loss_rel <= 1e-5 and ratio[worst] <= 1e-3):
        raise AssertionError(f"ring vs plain on the card: loss {loss_rel} (1e-5), gradient {worst} {ratio[worst]} "
                             "x RMS (1e-3)")


def card_vs_cpu_sp():
    """The clm_8k ring at full width and sequence with 2 layers, f32 (TF32
    off), batch 1, under {"seq": 4} on the card (the card at every position)
    and on the CPU (the CPU at every position): loss within 1e-5 relative,
    every gradient within 1e-3 x its RMS, 3 AdamW steps' losses within 1e-4
    relative (the limits of card_vs_cpu_train). Both sides take the prefix
    dropout's uniforms from a CPU generator with the seed of the model's
    (the card's generator draws other numbers from the same seed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = clm_8k_sp_config(layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 10))
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    prefix = cfg.max_seq_len - cfg.max_latents
    meshes = {"cpu": make_mesh(SP_AXES, devices=["cpu"] * math.prod(SP_AXES.values())), "card": card_mesh()}
    real_draws = tpar.prefix_dropout_draws

    def cpu_draws(mode, rate, shape, generator, device):
        return real_draws(mode, rate, shape, torch.Generator().manual_seed(generator.initial_seed()), "cpu").to(device)

    def loss_and_grads(model, b):
        model.train()
        loss = cross_entropy(model(b["input_ids"], prefix, generator=torch.Generator().manual_seed(SEED)),
                             b["labels"][:, prefix:])
        return loss.item(), torch.autograd.grad(loss, trainable(model))

    tpar.prefix_dropout_draws = cpu_draws
    try:
        with set_mesh(meshes["cpu"]):
            l_cpu, g_cpu = loss_and_grads(cpu, batch)
        with set_mesh(meshes["card"]):
            l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
        ratio = _grad_ratios(cpu, g_gpu, g_cpu)
        del g_cpu, g_gpu
        runs = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
            tx = build_optimizer(1e-3, max_grad_norm=1.0)
            state = TrainState.create(model, tx, seed=SEED)
            step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
            with set_mesh(meshes[name]):
                runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    finally:
        tpar.prefix_dropout_draws = real_draws
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = max(ratio, key=ratio.get)
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="train_sp", model="clm_8k", layers=2, batch=1, mesh=SP_AXES,
         loss_rel_err=loss_rel, loss_rtol=1e-5, max_grad_err_over_rms=ratio[worst], worst_grad=worst,
         grad_limit=1e-3, step_losses=runs, step_loss_rel_err=step_rel, step_rtol=1e-4)
    if not (loss_rel <= 1e-5 and ratio[worst] <= 1e-3 and step_rel <= 1e-4):
        raise AssertionError(f"ring card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {ratio[worst]} x RMS "
                             f"(1e-3), steps {step_rel} (1e-4)")


# ---------------------------------- phase 3: B1a at the image classifier's shape
# vision_perceiver_fourier_config's latent self-attention at the classifier
# phase's batch: 8 heads of 128 over 512 latents, full mask, no pads, run
# 6 layers x 8 blocks = 48 times a forward
CLASSIFIER_FLASH_SHAPE = (32, 8, 512, 512, 128)  # (batch, heads, queries, keys, head dim)


def check_classifier_flash_kernel():
    """B1a as the 48.4M image classifier's inference calls it (no
    gradients: in bf16 P in one term, csrc/flash_forward_mma.cu; float32
    csrc/flash_forward_f32.cu), against its plain version: bf16 within 0.03
    x the plain output's RMS plus one bf16 step (flash_limit), float32
    within 1e-4 and float32-class (f32_class_check); two runs the same
    bits; the kernel, the plain version and the library call
    (F.scaled_dot_product_attention, its kernels named) timed, with the
    bound (float32: beside it the CUDA cores' bound)."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 17)
    b, h, nq, nk, d = CLASSIFIER_FLASH_SHAPE
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        q, k, v, _, _ = flash_case(b, h, nq, nk, d, None, dtype, g)
        with torch.no_grad():
            got, again = fl.splash_mha(q, k, v), fl.splash_mha(q, k, v)
        want = fl.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again) or got.dtype != dtype:
            raise AssertionError(f"flash image_classifier {dtype}: two runs differ, or the output is {got.dtype}")
        del again
        atol, rtol = flash_limit(want, dtype)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if not (diff <= atol + rtol * want.float().abs()).all():
            raise AssertionError(f"flash image_classifier {dtype}: kernel vs plain max error {err} (atol {atol}, "
                                 f"rtol {rtol})")
        del diff
        f32_class = (f32_class_check("image_classifier_self_attention", got, want, q, k, v, None, False)
                     if dtype == torch.float32 else {})
        del got, want
        esize = torch.finfo(dtype).bits // 8
        library = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
        rec = dict(kernel="splash_mha", shape="image_classifier_self_attention", dtype=str(dtype).removeprefix("torch."),
                   batch=b, heads=h, queries=nq, keys=nk, head_dim=d, mask="full", max_abs_err=err,
                   limits=(atol, rtol), bit_identical=True,
                   ms=time_ms(lambda: fl._launch_forward(q, k, v, None, False, split_p=False)),
                   plain_ms=time_ms(lambda: fl.flash_attention_reference(q, k, v), reps=10),
                   library_ms=time_ms(library), library_kernels=cuda_kernel_names(library), **f32_class)
        rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, esize, inference=True)
        if dtype == torch.float32:
            rec["bound_ms_cuda_cores"] = cuda_core_bound_ms(rec["bound_ms"], 4 * d * b * h * nq * nk)
        emit(phase="kernel_check", **rec, wall_s=time.perf_counter() - t0, card=card_line())
        records.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return records


# ---------------------------------------- phase 6: the Perceiver IO image classifier
CLASSIFIER_BATCH = 32  # images a forward
CLASSIFIER_TRAIN_BATCH = 16
CLASSIFIER_TRAIN_STEPS = 3
CLASSIFIER_PARAMS = 48_440_627  # deepmind/vision-perceiver-fourier's count
# run_digits("glyphs") at half its 3,000-step default (the card's time limit);
# the 0.98 bar is the same
DIGITS_STEPS = 500


def classifier_images(n, seed):
    """``n`` seeded 224 x 224 x 3 inputs: seeded uint8 images of 256 x 320
    through ImageNetPreprocessor where PIL imports, else seeded normalised
    floats. Returns (images float32 numpy, how they were made)."""
    rng = np.random.default_rng(seed)
    raw = [rng.integers(0, 256, (256, 320, 3)).astype(np.uint8) for _ in range(n)]
    try:
        return ImageNetPreprocessor().preprocess_batch(raw), "seeded uint8 256 x 320 images through ImageNetPreprocessor"
    except ImportError as e:
        return (rng.standard_normal((n, 224, 224, 3), dtype=np.float32),
                f"seeded normalised floats: PIL is absent ({e}), so ImageNetPreprocessor cannot resize")


def _classifier_kind(name: str) -> str:
    if "flash_fwd_mma" in name or "flash_fwd_f32" in name or "flash_f32_split" in name:
        return "B1a"
    low = name.lower()
    if "layer_norm" in low or "layernorm" in low:
        return "LayerNorm"
    if "softmax" in low:
        return "softmax (the masked softmax's normalisation)"
    if any(part in low for part in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matrix products"
    return "other (elementwise, casts, masks, copies)"


def classifier_forward_profile(model, x):
    """One inference forward of ``model`` on ``x`` under torch.profiler:
    device ms by kind (B1a, matrix products, the softmax, LayerNorm, the
    rest), the top kernels, and the masked softmax's own ms (the encoder's
    cross-attention and the decoder, CUDA events around each call of the
    attention's masked-softmax path, products included)."""
    from torch.profiler import ProfilerActivity, profile

    masked_ms = []
    attns = [model.encoder.cross_attn_1.cross_attn.attention, model.decoder.cross_attn.cross_attn.attention]
    originals = [a._masked_softmax for a in attns]

    def timed(fn):
        def wrapped(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            masked_ms.append((start, end))
            return out
        return wrapped

    for a, fn in zip(attns, originals):
        a._masked_softmax = timed(fn)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.inference_mode():
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for a, fn in zip(attns, originals):
            a._masked_softmax = fn
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kind = {}
    for e in kernels:
        k = by_kind.setdefault(_classifier_kind(e.key), {"ms": 0.0, "launches": 0})
        k["ms"] += e.self_device_time_total / 1e3
        k["launches"] += e.count
    for k in by_kind.values():
        k["share_of_device_time"] = k["ms"] / device_ms if device_ms else "not measured"
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return dict(profiled_wall_ms=wall_ms, device_kernel_ms=device_ms or "not measured",
                device_idle_share=1 - device_ms / wall_ms if device_ms else "not measured", by_kind=by_kind,
                masked_softmax_path_ms=[s.elapsed_time(e) for s, e in masked_ms],
                top_kernels=[{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                             for e in top])


def _timed_classifier_forwards(model, x):
    """REPEATS synced inference forwards after one warm-up, every count
    zeroed just before: (ms a forward, the B1a launches by width and by
    type, the other kernels' launches, peak GiB, the last logits)."""
    with torch.inference_mode():
        model(x)  # warm-up: cuBLAS handles, the kernel libraries
    torch.cuda.synchronize()
    zero_counts()
    fl.forward_launches_by_width.clear()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = model(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    others = {"B1b": fl.backward_launches, "B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    return (walls, dict(fl.forward_launches_by_width), dict(fl.forward_launches_by_dtype), others,
            torch.cuda.max_memory_allocated() / 2**30, logits)


def image_classifier():
    """The 48.4M ImageNet classifier (vision_perceiver_fourier_config:
    48,440,627 parameters, random weights from SEED) on CLASSIFIER_BATCH
    seeded 224 x 224 x 3 images (classifier_images). One set of weights
    (made on the CPU) runs in bf16 over float32 parameters and in float32
    (TF32 off) on the card: REPEATS synced forwards each (ms a forward,
    images/s, peak memory), B1a exactly 48 launches a forward at D = 128 in
    the input's type and no other kernel of the port; the logits finite of
    shape (32, 1000); one profiled forward each (device ms by kind, the
    masked softmax's own ms); bf16's top-1 against float32's; then the card's
    float32 logits at batch 2 against the port's CPU run within 1e-3 with the
    same top-1. Returns the B1a launches by type."""
    t0 = time.perf_counter()
    cfg = vision_perceiver_fourier_config()
    layers = cfg.encoder.num_self_attention_layers_per_block * cfg.encoder.num_self_attention_blocks
    cpu = ImageClassifier(cfg, device="cpu", seed=SEED)
    n_params = sum(p.numel() for p in cpu.parameters())
    if n_params != CLASSIFIER_PARAMS:
        raise AssertionError(f"image classifier: {n_params} parameters, expected {CLASSIFIER_PARAMS}")
    images, source = classifier_images(CLASSIFIER_BATCH, SEED + 21)
    x = torch.from_numpy(images).to(DEVICE)
    launches, logits = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        model = ImageClassifier(cfg, device=DEVICE, dtype=dtype, seed=SEED)
        model.load_state_dict(cpu.state_dict())
        walls, by_width, by_dtype, others, peak, out = _timed_classifier_forwards(model, x)
        expected = {128: layers * REPEATS}
        rec = dict(phase="image_classifier", model="vision_perceiver_fourier_config", params=n_params,
                   dtype=f"{name} compute, float32 params", batch=CLASSIFIER_BATCH, images=source,
                   forward_ms=spread(walls), images_per_s=spread([CLASSIFIER_BATCH / (t / 1e3) for t in walls]),
                   max_memory_allocated_gib=peak, b1a_launches_by_head_dim=by_width, b1a_launches_by_dtype=by_dtype,
                   expected_b1a_launches_by_head_dim=expected, other_launches=others,
                   logits_shape=list(out.shape), logits_finite=bool(torch.isfinite(out).all()))
        rec.update(profile=classifier_forward_profile(model, x), card=card_line())
        emit(**rec)
        if by_width != expected or by_dtype != {name: layers * REPEATS} or any(others.values()):
            raise AssertionError(f"image classifier {name}: B1a launches {by_width} ({by_dtype}), expected {expected}"
                                 f"; others {others}")
        if tuple(out.shape) != (CLASSIFIER_BATCH, 1000) or not rec["logits_finite"]:
            raise AssertionError(f"image classifier {name}: logits {tuple(out.shape)}, finite {rec['logits_finite']}")
        launches[name], logits[name] = by_dtype[name], out.float()
        if dtype == torch.float32:
            gpu = model
        else:
            del model
        torch.cuda.empty_cache()
    agree = (logits["bfloat16"].argmax(-1) == logits["float32"].argmax(-1)).float().mean().item()
    with torch.inference_mode():
        want = cpu(x[:2].cpu())
        got = gpu(x[:2]).cpu()
    err = (got - want).abs().max().item()
    same_top1 = torch.equal(got.argmax(-1), want.argmax(-1))
    emit(phase="card_vs_cpu", path="image_classifier", batch=2, dtype="float32 (TF32 off)", max_logit_err=err,
         atol=1e-3, same_top1=same_top1, logit_rms=want.pow(2).mean().sqrt().item(),
         bf16_vs_f32_top1_agreement=agree, bf16_vs_f32_batch=CLASSIFIER_BATCH,
         bf16_vs_f32_max_logit_diff=(logits["bfloat16"] - logits["float32"]).abs().max().item(),
         image_classifier_wall_s=time.perf_counter() - t0)
    if not err <= 1e-3 or not same_top1:
        raise AssertionError(f"image classifier card vs CPU: logit error {err} (atol 1e-3), same top-1 {same_top1}")
    del gpu, cpu, x
    torch.cuda.empty_cache()
    return launches


def train_image_classifier():
    """The same model in bf16 over float32 parameters at the config's
    dropout (0.1), batch CLASSIFIER_TRAIN_BATCH of seeded images and labels:
    CLASSIFIER_TRAIN_STEPS steps of make_classifier_train_step (AdamW 1e-4,
    clipping at 1.0), ms a step and the loss finite; then as many with
    scripts/common.py's build_tx(freeze_encoder=True): every encoder
    parameter bit-identical after them and the decoder's changed. Attention
    dropout keeps every attention off B1 (as in the JAX package): B1a and
    B1b must not launch."""
    t0 = time.perf_counter()
    cfg = vision_perceiver_fourier_config()
    model = ImageClassifier(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    images, source = classifier_images(CLASSIFIER_TRAIN_BATCH, SEED + 22)
    labels = np.random.default_rng(SEED + 23).integers(0, 1000, CLASSIFIER_TRAIN_BATCH)
    batch = {"image": torch.from_numpy(images).to(DEVICE), "label": torch.from_numpy(labels).to(DEVICE)}
    records = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    for mode in ("all", "freeze_encoder"):
        if mode == "all":
            tx = build_optimizer(1e-4, max_grad_norm=1.0)
        else:
            tx = build_tx(OptimizerFlags(lr=1e-4, warmup_steps=0, schedule="constant", max_grad_norm=1.0,
                                         freeze_encoder=True), CLASSIFIER_TRAIN_STEPS)
        state = TrainState.create(model, tx, seed=SEED)
        step = make_classifier_train_step(model, tx)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        walls, losses = [], []
        for _ in range(CLASSIFIER_TRAIN_STEPS):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            walls.append((time.perf_counter() - t_step) * 1e3)
        changed = {n: not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()}
        encoder_changed = sum(v for n, v in changed.items() if n.startswith("encoder."))
        decoder = [v for n, v in changed.items() if n.startswith("decoder.")]
        records[mode] = dict(step_ms=walls, losses=losses, encoder_tensors_changed=encoder_changed,
                             decoder_tensors_changed=sum(decoder), decoder_tensors=len(decoder))
        del before
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"image classifier training ({mode}): losses {losses}")
        if mode == "freeze_encoder" and (encoder_changed or not any(decoder)):
            raise AssertionError(f"image classifier training with freeze_encoder: {encoder_changed} encoder tensors "
                                 f"changed, decoder changed {sum(decoder)} of {len(decoder)}")
    b1 = {"B1a": fl.forward_launches, "B1b": fl.backward_launches}
    emit(phase="train_image_classifier", model="vision_perceiver_fourier_config", dtype="bfloat16 compute, float32 "
         "params", dropout=cfg.encoder.dropout, batch=CLASSIFIER_TRAIN_BATCH, images=source, **records,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, b1_launches=b1,
         wall_s=time.perf_counter() - t0, card=card_line())
    if any(b1.values()):
        raise AssertionError(f"image classifier training at dropout 0.1 launched B1: {b1}")
    del model, state, batch
    torch.cuda.empty_cache()


def digits_convergence():
    """scripts/convergence.py's run_digits("glyphs") on the card, float32, at
    its DIGITS_STEPS steps through Trainer.fit (the MNIST recipe: 907,212
    parameters on 20,000 rendered digits at batch 128): raises unless
    ``met`` (best validation accuracy >= 0.98). The linear-probe baseline is
    printed where scikit-learn imports, else null with the reason; the gate
    does not read it. The recipe's attention (one 131-channel head over 784
    pixels, 16-channel heads over 32 latents) never reaches a kernel."""
    zero_counts()
    t0 = time.perf_counter()
    result = run_digits("glyphs", DIGITS_STEPS, "digits_glyphs", device=DEVICE, log_fn=lambda line: None)
    torch.cuda.synchronize()
    emit(phase="digits_convergence", steps=DIGITS_STEPS, wall_s=time.perf_counter() - t0,
         **{k: v for k, v in result.items() if k != "history"},
         val_acc_curve=[h["val_acc"] for h in result["history"] if "val_acc" in h], launches=flash_counts())
    if not result["met"]:
        raise AssertionError(f"digits_glyphs: best validation accuracy {result['achieved']} is under 0.98")


SCRIPTS_STOP_STEP = 2  # (a): the stopped run's steps; the resumed run goes on to SCRIPTS_STOP_STEP + 2
SCRIPTS_AUDIO_STEPS = 2  # (b): the symbolic CLI's steps
SCRIPTS_MARKOV_STEPS = 400  # (c): run_clm("markov") on the gpu profile (300 cleared the gate by 0.15 nats, at the curve's knee)
SCRIPTS_AUDIO_FILES = 8


def _recording_train_step(make_step, record):
    """``make_step`` whose steps append (step, loss tensor) to ``record``."""

    def make(model, tx, **kw):
        step = make_step(model, tx, **kw)

        def train_step(state, batch):
            state, metrics = step(state, batch)
            record.append((state.step, metrics["loss"]))
            return state, metrics

        return train_step

    return make


def _cli_run(main, argv, record):
    """``main(argv, device=DEVICE)`` with its train steps' losses recorded
    and its standard output captured; returns (the JSON lines it printed,
    the losses by step as floats)."""
    out = io.StringIO()
    del record[:]
    with contextlib.redirect_stdout(out):
        main(argv, device=DEVICE)
    torch.cuda.synchronize()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return lines, {int(s): float(loss) for s, loss in record}


def scripts_clm(tmp):
    """(a) scripts/text/clm.py's main at its defaults (the 30.7M recipe:
    sequence 4096, 512 latents, 512 channels in 8 heads of 64, 8 layers,
    batch 20, bf16 compute), its data group a TextDataModule over the
    python-source corpus (_PythonSourceText), the constant schedule (a
    cosine horizon would differ between a run and its resume), logged every
    step and evaluated at step SCRIPTS_STOP_STEP + 2 with its sample. An
    uninterrupted run of SCRIPTS_STOP_STEP + 2 steps, a run stopped at
    SCRIPTS_STOP_STEP (its final checkpoint), and that run resumed with
    --resume to SCRIPTS_STOP_STEP + 2. Gates: finite losses, the resumed
    run's losses the uninterrupted run's bits, B1a and B1b launched at D 64
    in bf16, B2 launched by the samples. Returns the launches."""
    import perceiver_io_torch.scripts.text.clm as clm

    full = SCRIPTS_STOP_STEP + 2
    common = [f"--data.dataset_dir={tmp}/text", "--optimizer.schedule=constant", "--trainer.log_every=1",
              f"--trainer.eval_every={full}"]
    record = []
    with mock.patch.multiple(clm, WikiTextDataModule=_PythonSourceText,
                  make_causal_lm_train_step=_recording_train_step(make_causal_lm_train_step, record)):
        zero_counts()
        fl.forward_launches_by_width.clear()
        fl.backward_launches_by_width.clear()
        t0 = time.perf_counter()
        lines, uninterrupted = _cli_run(clm.main, common + [f"--trainer.checkpoint_dir={tmp}/full",
                                                            f"--trainer.max_steps={full}"], record)
        full_s = time.perf_counter() - t0
        _, stopped = _cli_run(clm.main, common + [f"--trainer.checkpoint_dir={tmp}/stopped",
                                                  f"--trainer.max_steps={SCRIPTS_STOP_STEP}"], record)
        t1 = time.perf_counter()
        resumed_lines, resumed = _cli_run(clm.main, common + [f"--trainer.checkpoint_dir={tmp}/stopped",
                                                              f"--trainer.max_steps={full}", "--resume"], record)
        resume_s = time.perf_counter() - t1
    counts = flash_counts()
    by = {"B1a": {"width": dict(fl.forward_launches_by_width), "dtype": dict(fl.forward_launches_by_dtype)},
          "B1b": {"width": dict(fl.backward_launches_by_width), "dtype": dict(fl.backward_launches_by_dtype)}}
    b2 = dk.launches
    params = next(ln["model_params"] for ln in lines if "model_params" in ln)
    sizes = next(ln for ln in lines if "flops_per_step" in ln)
    logged = [ln for ln in lines if "loss" in ln and "step" in ln]
    samples = [ln["sample"] for ln in lines + resumed_lines if "sample" in ln]
    val = [ln["val_loss"] for ln in lines if "val_loss" in ln]
    resumed_from = next((ln["resumed_from_step"] for ln in resumed_lines if "resumed_from_step" in ln), None)
    same = sorted(resumed) == list(range(SCRIPTS_STOP_STEP + 1, full + 1)) and all(
        float.hex(resumed[s]) == float.hex(uninterrupted[s]) for s in resumed)
    emit(phase="training_scripts", part="clm_cli", model="clm_30m", model_params=params, **sizes,
         steps=full, full_s=full_s, resume_s=resume_s, losses=[uninterrupted[s] for s in sorted(uninterrupted)],
         logged_losses=[ln["loss"] for ln in logged], mfu=[ln.get("mfu") for ln in logged],
         tokens_per_sec=[ln.get("tokens_per_sec") for ln in logged], val_loss=val,
         stopped_losses=[stopped[s] for s in sorted(stopped)], resumed_from_step=resumed_from,
         resumed_losses=[resumed[s] for s in sorted(resumed)], resumed_equal_bits=same, samples=samples,
         launches=counts, launches_by=by, b2=b2)
    losses = list(uninterrupted.values()) + list(stopped.values()) + list(resumed.values()) + val
    if not (len(uninterrupted) == full and all(math.isfinite(v) for v in losses) and len(samples) == 2):
        raise AssertionError(f"clm_cli: losses {uninterrupted} {stopped} {resumed}, eval {val}, samples {samples}")
    if not (same and resumed_from == SCRIPTS_STOP_STEP and all(stopped[s] == uninterrupted[s] for s in stopped)):
        raise AssertionError(f"clm_cli: resumed from {resumed_from}: {resumed} against {uninterrupted}")
    if not (by["B1a"]["width"].get(64) and by["B1b"]["width"].get(64)
            and by["B1a"]["dtype"] == {"bfloat16": counts["B1a"]}
            and by["B1b"]["dtype"] == {"bfloat16": counts["B1b"]} and b2):
        raise AssertionError(f"clm_cli: B1 {by}, B2 {b2}")
    if not any(m for m in (ln.get("mfu") for ln in logged)):
        raise AssertionError(f"clm_cli: the fit loop reported no MFU (peak {sizes['peak_flops']})")
    return {"B1a": counts["B1a"], "B1b": counts["B1b"], "B2": b2}


def scripts_symbolic(tmp):
    """(b) scripts/audio/symbolic.py's main at its defaults (the 134M
    GiantMIDI recipe: sequence 6,144, 2,048 latents, 768 channels in 8 heads
    of 96, 18 layers, checkpointing, batch 8, bf16 compute) for
    SCRIPTS_AUDIO_STEPS steps, its data group a GiantMidiPianoDataModule
    over SCRIPTS_AUDIO_FILES seeded .mid files written by write_smf. Gates:
    finite losses, one a step; the peak memory is printed."""
    import perceiver_io_torch.scripts.audio.symbolic as symbolic

    rng = np.random.default_rng(SEED + 25)
    source = {}
    for split, n in (("train", SCRIPTS_AUDIO_FILES), ("valid", 2)):
        d = os.path.join(tmp, "midi", split)
        os.makedirs(d)
        for i in range(n):
            write_smf(os.path.join(d, f"{i}.mid"), *_audio_notes(rng, 1500))
        source[split] = d

    class LocalGiantMidi(symbolic.GiantMidiPianoDataModule):
        def load_source_dataset(self):
            return source

    record = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.multiple(symbolic, GiantMidiPianoDataModule=LocalGiantMidi,
                  make_causal_lm_train_step=_recording_train_step(make_causal_lm_train_step, record)):
        lines, losses = _cli_run(symbolic.main, [f"--data.dataset_dir={tmp}/giantmidi", "--trainer.log_every=1",
                                                 f"--trainer.max_steps={SCRIPTS_AUDIO_STEPS}",
                                                 f"--trainer.checkpoint_dir={tmp}/sam"], record)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = next(ln["model_params"] for ln in lines if "model_params" in ln)
    sizes = next(ln for ln in lines if "flops_per_step" in ln)
    logged = [ln for ln in lines if "loss" in ln and "step" in ln]
    emit(phase="training_scripts", part="symbolic_cli", model="giantmidi_134m", model_params=params, **sizes,
         steps=SCRIPTS_AUDIO_STEPS, wall_s=wall, losses=[losses[s] for s in sorted(losses)],
         mfu=[ln.get("mfu") for ln in logged], max_memory_allocated_bytes=peak)
    if not (sorted(losses) == list(range(1, SCRIPTS_AUDIO_STEPS + 1))
            and all(math.isfinite(v) for v in losses.values())):
        raise AssertionError(f"symbolic_cli: losses {losses}")


def order1_entropy(src) -> float:
    """H(X_t | X_{t-1}) of an order-2 Markov source in nats: from its
    stationary pair distribution pi(b, c) (which the chain's transitions
    keep: pi(b, c) = sum_a pi(a, b) T[a, b, c]), -sum pi(b, c) log(pi(b, c)
    / pi(b)). A model that reads only the last token cannot beat it."""
    pi = src.stationary_pairs()
    held = np.einsum("ab,abc->bc", pi, src.transitions())
    if not np.allclose(held, pi, atol=1e-12):
        raise AssertionError("the pair distribution is not stationary")
    prev = pi.sum(axis=1, keepdims=True)
    return float(-(pi * np.log(np.where(pi > 0, pi / prev, 1.0))).sum())


def scripts_markov():
    """(c) scripts/convergence.py's run_clm("markov") on the gpu profile
    (sequence 512, 256 latents, 256 channels in 8 heads of 32, 4 layers,
    vocabulary 64, batch 16, float32) for SCRIPTS_MARKOV_STEPS steps. Gate:
    the best validation CE below the corpus's order-1 conditional entropy
    H(X_t | X_{t-1}) (order1_entropy), which only a model that reads both
    context tokens beats; ``met`` (within 0.05 nats of the order-2 floor)
    and the gap are printed beside it."""
    from perceiver_io_torch.scripts.convergence import run_clm

    h1 = order1_entropy(MarkovByteSource(vocab_size=64))
    zero_counts()
    t0 = time.perf_counter()
    result = run_clm("markov", SCRIPTS_MARKOV_STEPS, "clm_markov", device=DEVICE, log_fn=lambda line: None)
    torch.cuda.synchronize()
    curve = [h["val_loss"] for h in result["history"] if "val_loss" in h]
    emit(phase="training_scripts", part="clm_markov", steps=SCRIPTS_MARKOV_STEPS, wall_s=time.perf_counter() - t0,
         **{k: v for k, v in result.items() if k != "history"}, order1_entropy_nats=h1, val_loss_curve=curve,
         launches=flash_counts())
    if not (result["profile"] == "gpu" and result["achieved_val_ce_nats"] is not None
            and result["achieved_val_ce_nats"] < h1):
        raise AssertionError(f"clm_markov: best val CE {result['achieved_val_ce_nats']} is not below the order-1 "
                             f"entropy {h1} (profile {result['profile']})")


def training_scripts():
    """Phase training_scripts: (a) scripts_clm, (b) scripts_symbolic, (c)
    scripts_markov; prints the phase's seconds. Returns (a)'s launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = scripts_clm(tmp)
        scripts_symbolic(tmp)
    torch.cuda.empty_cache()
    scripts_markov()
    emit(phase="training_scripts", seconds=time.perf_counter() - t0, launches=launches, nvidia_smi=card_line())
    return launches


def wide_ptxas(source, lines):
    """The ptxas report of a wide flash source (flash_forward_wide or
    flash_backward_wide): registers and spill bytes of each kernel
    instantiation (its name, head width and, in the forward, P's terms), and
    the count of ptxas notes that it serialised wgmma (C7513/C7518/C7520),
    emitted as one line; a spill fails the run (an empty report: the library
    was already built, nothing to read)."""
    kernels, current = [], None
    for line in lines:
        found = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]*kernel)(?:ILi(\d+)E)?(?:Lb([01])E)?", line)
        if "Compiling entry function" in line and found:
            current = dict(kernel=found.group(1))
            if found.group(2):
                current["head_dim"] = int(found.group(2))
            if found.group(3):
                current["split_p"] = found.group(3) == "1"
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            current["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif current is not None and "Used" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    serialised = [line for line in lines if "serialized" in line]
    emit(phase="build", source=f"perceiver_io_torch/csrc/{source}.cu", instantiations=kernels,
         wgmma_serialised=len(serialised))
    if any(k.get("spill_bytes", 0) for k in kernels):
        raise AssertionError(f"{source}.cu spills registers: {kernels}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--journal-child"]:
        return journal_child(sys.argv[2])
    if sys.argv[1:2] == ["--router-child"]:
        return router_child(sys.argv[2])
    if sys.argv[1:2] == ["--train-child"]:
        return train_child(sys.argv[2])
    cap = torch.cuda.get_device_capability(0)
    card = card_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), capability=list(cap), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card has compute capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain float32 versions stay float32 throughout
    torch.backends.cudnn.allow_tf32 = False

    built = cuda_build.build()
    for source, rec in built.items():
        emit(phase="build", source=f"perceiver_io_torch/csrc/{source}.cu", **rec)
    for source in ("flash_forward_wide", "flash_backward_wide", "flash_forward_f32", "flash_backward_f32"):
        wide_ptxas(source, built[source]["ptxas"])

    decode_results = check_decode_kernel()
    paged_results = check_paged_kernels()
    decode_host_times()
    flash_results = check_flash_kernel()
    ring_results = check_ring_block_kernel()
    flow_flash_results = check_flow_flash_kernel()
    wide_forward_results = check_wide_forward_kernel()
    wide_backward_results = check_wide_backward_kernel()
    f32_backward_results = check_f32_backward_kernel()
    classifier_flash_results = check_classifier_flash_kernel()
    launches = {"B2": main_path()}
    if launches["B2"] == 0:
        raise AssertionError("the generation path never launched B2")
    for k, v in serving().items():
        launches[k] = launches.get(k, 0) + v
    if not all(launches[k] for k in ("B2", "B3", "B4")):
        raise AssertionError(f"a kernel of the serving path was never launched: {launches}")
    lifecycle = serving_lifecycle()
    if not all(lifecycle[k] for k in ("B2", "B3", "B4")):
        raise AssertionError(f"a kernel of the serving lifecycle path was never launched: {lifecycle}")
    for k, v in lifecycle.items():
        launches[k] += v
    journal_launches, model, stream, reference = serving_journal()
    recovery_launches = serving_recovery(model, stream, reference)
    process_fleet = _FleetBehind(model)  # serving_router_process's first fleet starts while serving_router runs
    router_launches, references, router_stats = serving_router(model, stream)
    process_launches = serving_router_process(model, stream, references[PROCESS_MODE], router_stats, process_fleet)
    fleet_launches = serving_router_fleet(model, stream, references)
    telemetry_launches = telemetry_serving(model, stream)
    del model
    torch.cuda.empty_cache()
    weight_launches = weight_serving()
    for phase, counts in (("serving_journal", journal_launches), ("serving_recovery", recovery_launches),
                          ("serving_router", router_launches), ("serving_router_process", process_launches),
                          ("serving_router_fleet", fleet_launches), ("telemetry", telemetry_launches),
                          ("weight_serving", weight_launches)):
        if not counts["B2"] or not counts["B3"] or (phase in ("serving_journal", "serving_router",
                                                              "serving_router_fleet", "telemetry")
                                                     and not counts["B4"]):
            raise AssertionError(f"a kernel of the {phase} path was never launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
    flagship = CausalSequenceModel(flagship_455m_config(), device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    init = {k: v.detach().clone() for k, v in flagship.state_dict().items()}  # the seeded weights, for each run
    resilient = train_resilient_start(flagship, init)
    try:  # checks that read no clock, while train_resilient's child starts
        card_vs_cpu()
        card_vs_cpu_serving()
        card_vs_cpu_chunked()
        card_vs_cpu_train()
    except BaseException:
        train_resilient_cleanup(resilient)
        raise
    for k, v in train_resilient_finish(resilient).items():
        launches[k] = launches.get(k, 0) + v
    flagship.load_state_dict(init)
    for k, v in train_flagship(flagship).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in telemetry_training(flagship, init).items():
        launches[k] += v
    faces = perceiver_ar_faces(flagship, init)
    if not (faces["B1a"] and faces["B1b"] and faces["B2"]):
        raise AssertionError(f"a kernel of the perceiver_ar_faces path was never launched: {faces}")
    for k, v in faces.items():
        launches[k] += v
    del flagship, init
    for k, v in train_30m().items():
        launches[k] = launches.get(k, 0) + v
    if not (launches["B1a"] and launches["B1b"]):
        raise AssertionError(f"a kernel of the training path was never launched: {launches}")
    launches["B5"] = train_sp()["B5"]
    if not launches["B5"]:
        raise AssertionError("the sequence-parallel training path never launched B5")
    flow_launches, flow_f32_launches = optical_flow()
    if not (flow_launches.get(64) and flow_launches.get(512)):
        raise AssertionError(f"the optical-flow path did not launch B1a at D = 64 and D = 512: {flow_launches}")
    flow_train_launches = train_flow()
    if not all(flow_train_launches[k].get(d) for k in ("B1a", "B1b") for d in (64, 512)):
        raise AssertionError(f"the flow training path did not launch B1a and B1b at D = 64 and 512: "
                             f"{flow_train_launches}")
    for key in ("B1a", "B1b"):
        launches[key] += flow_train_launches[key][64]
    flow_train_f32_launches = train_flow(torch.float32, patches=1)  # the model's default dtype, one patch
    if not all(flow_train_f32_launches[k].get(d) for k in ("B1a", "B1b") for d in (64, 512)):
        raise AssertionError(f"the float32 flow training path did not launch B1a and B1b at D = 64 and 512: "
                             f"{flow_train_f32_launches}")
    sp_lr_check()
    card_vs_card_sp()
    card_vs_cpu_sp()
    card_vs_cpu_flow()
    card_vs_cpu_flow_train()
    convergence_launches = flow_convergence()
    classifier_launches = image_classifier()
    if not (classifier_launches.get("bfloat16") and classifier_launches.get("float32")):
        raise AssertionError(f"the image classifier path did not launch B1a in bf16 and float32: {classifier_launches}")
    train_image_classifier()
    digits_convergence()
    scripts_launches = training_scripts()
    if not all(scripts_launches.values()):
        raise AssertionError(f"a kernel of the training_scripts path was never launched: {scripts_launches}")
    for k, v in scripts_launches.items():
        launches[k] += v

    head = decode_results[("flagship_cross_attention", "bfloat16", 1)]
    kernels = [dict(
        name="fused_decode_attention", route="cuda", source="perceiver_io_torch/csrc/decode_attention.cu",
        replaces="perceiver_io_tpu/ops/decode_kernel.py:251", launches=launches["B2"],
        max_abs_err=max(r["max_abs_err"] for r in decode_results.values()), ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    )]
    for key, kernel, pool, replaces in (
            ("B3", "fused_paged_decode_attention", "bf16", "perceiver_io_tpu/ops/paged_decode_kernel.py:608"),
            ("B4", "fused_ragged_paged_attention", "int4", "perceiver_io_tpu/ops/ragged_paged_kernel.py:231")):
        mine = [r for r in paged_results if r["kernel"] == kernel]
        head = next(r for r in mine if r["shape"] == "flagship_cross_attention" and r["pool"] == pool)
        kernels.append(dict(
            name=kernel, route="cuda", source="perceiver_io_torch/csrc/paged_attention.cu", replaces=replaces,
            launches=launches[key], max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
        ))
    head = next(r for r in flash_results if r["shape"] == "flagship_cross_attention" and r["dtype"] == "bfloat16")
    for key, name, err_keys, prefix, source in (
            ("B1a", "splash_mha_forward", ("o",), "", "flash_forward_mma.cu"),
            ("B1b", "splash_mha_backward", ("dq", "dk", "dv"), "backward_", "flash_backward_mma.cu")):
        kernels.append(dict(
            name=name, route="cuda", source=f"perceiver_io_torch/csrc/{source}",
            replaces="perceiver_io_tpu/ops/flash.py:164", launches=launches[key],
            max_abs_err=max(r["max_abs_err"][e] for r in flash_results for e in err_keys),
            ms=head["ms" if not prefix else "backward_ms"], plain_ms=head[f"plain_{prefix}ms"],
            bound_ms=head[f"{prefix}bound_ms"], bound_by=head[f"{prefix}bound_by"],
            library_ms=head[f"library_{prefix}ms"],
        ))
    head = next(r for r in ring_results if r["shape"] == "clm_8k_cross_block" and r["dtype"] == "bfloat16")
    kernels.append(dict(
        name="ring_block_forward", route="cuda", source="perceiver_io_torch/csrc/flash_forward_mma.cu",
        replaces="perceiver_io_tpu/parallel/ring_attention.py:102", launches=launches["B5"],
        max_abs_err=max(e for r in ring_results for e in r["max_abs_err"].values()), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    ))
    for shape, d, name, source in (
            ("flow_decoder_cross_attention", 512, "splash_mha_forward_wide_flow_decoder", "flash_forward_wide.cu"),
            ("flow_self_attention", 64, "splash_mha_forward_flow_self_attention", "flash_forward_mma.cu")):
        mine = [r for r in flow_flash_results if r["shape"] == shape]
        head = next(r for r in mine if r["dtype"] == "bfloat16")
        errs = [r["max_abs_err"] for r in mine]
        if d == 512:  # the wide kernel's other checks: the train step's call, D 192 and 256
            errs += [e for r in wide_forward_results for e in r["max_abs_err"].values()]
        kernels.append(dict(
            name=name, route="cuda", source=f"perceiver_io_torch/csrc/{source}",
            replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_launches[d],
            max_abs_err=max(errs), ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        ))
    head = next(r for r in wide_backward_results if r["shape"] == "flow_decoder_cross_attention")
    kernels.append(dict(
        name="splash_mha_backward_wide_flow_decoder", route="cuda",
        source="perceiver_io_torch/csrc/flash_backward_wide.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_train_launches["B1b"][512],
        max_abs_err=max(e for r in wide_backward_results for e in r["max_abs_err"].values()), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    ))
    # float32: the forward (B1a and B5) on the default-dtype flow path and the
    # float32 epe task, the backward on the epe task; times at the flow
    # decoder's patch and (backward) the flagship cross-attention
    head = next(r for r in flow_flash_results
                if r["shape"] == "flow_decoder_cross_attention" and r["dtype"] == "float32")
    f32_forward_errs = [r["max_abs_err"]["o"] for r in flash_results if r["dtype"] == "float32"]
    f32_forward_errs += [r["max_abs_err"] for r in flow_flash_results if r["dtype"] == "float32"]
    f32_forward_errs += [e for r in ring_results if r["dtype"] == "float32" for e in r["max_abs_err"].values()]
    f32_forward_errs += [e for r in wide_backward_results for e in r.get("forward_max_abs_err", {}).values()]
    kernels.append(dict(
        name="splash_mha_forward_f32", route="cuda", source="perceiver_io_torch/csrc/flash_forward_f32.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_f32_launches + convergence_launches["B1a"],
        max_abs_err=max(f32_forward_errs), ms=head["ms_checked_batch"], plain_ms=head["plain_ms_checked_batch"],
        bound_ms=head["bound_ms_checked_batch"], bound_by=head["bound_by_checked_batch"],
        library_ms=head["library_ms_checked_batch"],
    ))
    # the float32 backward on the float32 flow train step and the epe task;
    # times at the flagship cross-attention
    head = next(r for r in f32_backward_results if r["shape"] == "flagship_cross_attention")
    f32_backward = [r for r in flash_results + wide_backward_results + f32_backward_results
                    if r["dtype"] == "float32"]
    kernels.append(dict(
        name="splash_mha_backward_f32", route="cuda", source="perceiver_io_torch/csrc/flash_backward_f32.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164",
        launches=convergence_launches["B1b"] + sum(flow_train_f32_launches["B1b"].values()),
        max_abs_err=max(r["max_abs_err"][e] for r in f32_backward for e in ("dq", "dk", "dv")),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"],
    ))
    # B1a at the image classifier's latent self-attention, bf16 and float32
    for dtype, name, source in (("bfloat16", "splash_mha_forward_image_classifier", "flash_forward_mma.cu"),
                                ("float32", "splash_mha_forward_f32_image_classifier", "flash_forward_f32.cu")):
        head = next(r for r in classifier_flash_results if r["dtype"] == dtype)
        kernels.append(dict(
            name=name, route="cuda", source=f"perceiver_io_torch/csrc/{source}",
            replaces="perceiver_io_tpu/ops/flash.py:164", launches=classifier_launches[dtype],
            max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
        ))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
