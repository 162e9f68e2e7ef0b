#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--phases 20|21|22|23|24|25]

Phases (``--phases 20``, ``21``, ``22``, ``23``, ``24`` or ``25``: that phase alone); any failure raises,
so the exit code is not 0 and no result line is printed:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   six CUDA libraries built in parallel from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (build seconds and
   the ptxas report).
2. ``bsr_spmm`` against its plain PyTorch version on the serving
   configuration's real layer-0/1/2 bucket operands, through each
   operand's nonzero columns built as the serving path builds them (build
   ms and host syncs beside the kernel's ms), a repeat bitwise equal; the
   three SpMM kernels on edge cases (padding blocks, a block-row without
   blocks, F=1/33/40/70/256, rows misaligned for float4, a hub row cut
   into segments) and with inf/NaN in X rows that no nonzero multiplies
   (the sparse product, finite; the plain versions give NaN).
3. Serving at full width: the ogbn-arxiv analog (169,343 nodes), GCN
   [128, 256, 256, 40], fanouts (15, 10, 5), 256-seed batches, through
   ``repro_torch.launch.serve``'s engine on the ``cuda`` backend and, with
   the same weights and request stream, on the ``torch`` reference backend:
   logits within 1e-4, ``bsr_spmm`` launched 3 times per batch, a cache-on
   pass whose hits equal its misses bitwise; latency, throughput and where
   a batch's time goes.
4. Full-batch training, the main path (paper Listing 1): the same
   dataset and GCN through ``GNNProgram ... compile(engine="cuda",
   fused_optimizer=True) ... train_epoch`` for 10 epochs, against the
   ``torch`` program (plain versions, plain Adam) from the same weights:
   both programs' gradients at the first step and after the last epoch
   within 1e-3 a leaf (norm of the difference over the leaf's), with
   every ReLU decision the two part on within 1e-5 of 0 and taken from
   the cuda program; the parameters after the last epoch within 5e-2,
   finite losses within 1e-3 relative at every epoch and falling, exactly fused 3 /
   masked 2 / bsr_spmm 1 / Adam 1 (the step's 6 leaves in one launch)
   launches per epoch; the median epoch
   time, device ms per kernel and for the matmuls from a profiled epoch
   that recorded every launch, the idle share, peak memory, the
   operands' host build time and the build time and size of their
   nonzero columns (the fused-epilogue and masked kernels' operand), and
   the host time of one ``opt.update`` over the program's tree
   (synchronised host clock, median of 30).
5. The fused-epilogue and masked kernels against their plain versions
   on the main path's real operands (A and Aᵀ of the full graph, the
   fused and masked kernels through their nonzero columns): five
   epilogue specs at F=256 and F=40, a repeat launch bitwise equal, masks
   compared where |pre-activation| > 1e-5; the masked kernel on Aᵀ with a
   real ReLU mask; ``bsr_spmm`` on Aᵀ at F=40 (and the non-finite case
   there); edge cases (phase 2's: ragged F, rows misaligned for float4, a
   hub row longer than a CTA's split). Time per call from CUDA
   events (these full-graph calls keep the card busy far longer than their
   launches take; ``bsr_spmm``'s short calls from ``torch.profiler``), plain
   ms, library ms
   (``torch.sparse.mm`` + the epilogue's torch ops), the least time the
   card could take (bytes over 3.35 TB/s
   or fp32 operations over 67 TFLOP/s, whichever is larger; ``bound_ms``
   counted over the nonzeros alone, the bound the three SpMM kernels
   answer to, and ``layout_bound_ms`` over the BSR layout's blocks), and
   the hub row's cost against a mean row's and the whole call's, on A
   (fused) and Aᵀ (masked), each over the same clock as the call.
6. The quickstart at full scale: the corafull analog (19,793 nodes, 8,710
   features, 95% zeros), GCN [8710, 32, 70], layer 0 on
   ``cuda.feature_matmul_sparse``; 10 epochs of cuda against torch with the
   same checks and exactly 2 / 1 / 3 / 1 launches per epoch (and a second
   pass for each ``bsr_spmm`` call on a split operand); the fused pair's
   forward and backward on A and Aᵀ with unequal paddings (19,800 rows,
   19,840 columns), cuda against torch; ``bsr_spmm`` on all three of its
   operands there, BSR(X) and BSR(Xᵀ) at F=32 and Aᵀ at F=70, as in
   phase 5 (checked, a repeat bitwise equal, timed beside
   ``torch.sparse.mm``, bounded), the non-finite case on BSR(X), and the
   hub segment's cost on BSR(Xᵀ).

7. GAT training, the attention path's main run: the arxiv analog, GAT
   [128, 750, 750, 40] with 3 heads (DGL's ogbn-arxiv GAT widths: 250 per
   head, the last layer's 13 projected to 40) and that example's Adam (lr
   0.002), ``compile(engine="cuda", fused_optimizer=True)`` against the
   ``torch`` program from the same weights, 7 epochs (``gat_epochs``; cut from
   10 for the command's time) with phase 4's checks (at 5 the loss has not yet come
   back below its first value)
   and exactly 3 / 3 / 3 attention launches (forward, row pass, column
   pass; the forward and the row pass over A's nonzero columns, the
   column pass over Aᵀ's, both built when the layer is bound, each with
   its split rows' second pass once a call) and 1 Adam launch per
   epoch (15 leaves), no BSR SpMM; every layer bound to
   ``cuda.spmm_attention``.
8. The three attention kernels against their plain versions on phase 7's
   real A and Aᵀ with the layers' real inputs (z, a_src, a_dst and the
   loss's cotangent dy, captured in one training step), each through its
   operand's nonzero columns: Dh 250, 250 and 13 at 3 heads, out / m / l
   / dc / dzv / dd within 1e-4, a repeat launch bitwise equal; edge cases
   (a block-row without blocks, a padding tail, a row whose max lies in
   its second block, H·Dh not a multiple of 32, and, with SPLIT_COLUMNS
   lowered, a row split into segments whose max lies in a later one);
   per call CUDA-event ms, plain ms, the bounds (``attention_bound``: the
   nonzeros', with the layout's beside it) and the segment path's ms
   (``segment_softmax_aggregate`` forward and backward: gather,
   ``scatter_reduce``, ``index_add_``; a composition of library calls, no
   single one computes edge-softmax attention, so ``library_ms`` is
   null); the hub row's cost against a mean row's, each pass's after
   the split (its segments and second-pass launches beside it).
9. GT on the quickstart at full scale: GT [8710, 32, 70], 4 heads, layer 0
   on ``cuda.feature_matmul_sparse``; 10 epochs cuda against torch with
   the same checks and exactly 2 / 2 / 2 attention, 2 ``bsr_spmm`` and 1
   Adam launch (12 leaves) per epoch; the attention pair's forward and backward on
   corafull's unequal paddings, cuda against torch; one epoch of the
   program compiled with ``fuse_attention=False`` (the segment path on the
   card), its loss within 2e-4 of the fused first epoch's.
10. LM serving at full width: llama3.2-1b (16 layers, d_model 2048, 32
    heads with 8 KV heads of 64, vocab 128,256; 1,235,814,400 parameters,
    random from a seeded generator on the card) through
    ``ServingEngine(batch_slots=4, max_seq=1056)`` on the ``cuda`` model:
    8 requests of 128-1,024 prompt tokens (seed 0, the longest 1,024), 32
    new tokens each, two waves, after one untimed warmup run of the same
    requests. Exactly 16 ``flash_attention`` launches a wave, none in
    decode. The ``torch`` model (the plain version) fed the same inputs
    call by call: last-position logits within 1e-4 at every step, greedy
    tokens equal wherever the cuda program's top-2 margin exceeds 1e-3.
    Prefill ms a wave, decode ms a step, tokens/s, the run's peak memory,
    and device ms by kernel class and idle share of one prefill and one
    decode step (profiler).
11. The flash kernel against its plain version on each layer's real q, k,
    v from phase 10's 1,024-token prefill (B 4, H 32, Hkv 8, T 1024, D
    64), float32 within 2e-5 and bfloat16 copies within 5e-2, a repeat
    bitwise equal; edge cases (Tq != Tk causal and not, T = 1, 33, 1000, D
    = 8 and 128, K padding inside a tile, Hkv == H; every D and KV groups
    of 1-8 heads on ragged tiles, strided and misaligned views bitwise
    equal to the aligned call). Per call at layer 0's inputs: the
    kernel's, the plain version's and ``scaled_dot_product_attention``'s
    CUDA-event ms (on K/V repeated to 32 heads, and with
    ``enable_gqa=True``), the kernel's over SDPA's (``vs_library``), and
    the bound (fp32 operations over 67 TFLOP/s against bytes over 3.35
    TB/s).
12. ``fused_adam_multi`` against its plain version at 1e-6, weight decay 0
    and 0.01: on phase 4's six GCN leaves and phase 7's fifteen GAT
    leaves (random gradients and moments), each in one launch; on a mixed
    list (empty, 0-d, 1, 3, 4, 5, 1,000, 2,053 and 1,000,003 values, and a
    view at a 4-byte offset) in one launch; on 2 * CAPACITY + 5 leaves in
    ceil(leaves / CAPACITY) launches; outputs contiguous, inputs kept. On
    both paths' leaves the kernel's device time (profiler), its plain
    version, ``torch.optim.Adam(fused=True)``'s step and the bound (28
    bytes a parameter over 3.35 TB/s); beside them each training path's
    ``opt.update`` host time from phases 4, 6, 7 and 9.
13. GAT serving on the sampled path: phase 7's GAT [128, 750, 750, 40]
    with 3 heads, untrained, through ``build_engine(arch="GAT")`` with
    phase 3's fanouts, batches and request stream, cuda against the
    torch engine with the same weights: logits within 1e-4, exactly one
    ``bsr_attention_fwd`` launch a layer and batch and nothing else
    (the batch's A, built on the card where the forward runs; its rows
    hold at most fanout + 1 columns, so none splits), a cache-on pass
    whose hits equal its misses bitwise; latency, throughput, a batch's
    time by part and idle share, its column builds, and the forward
    kernel on one 256-seed batch's real operands against its plain
    version (checked, a repeat bitwise equal, device ms, bounds).
14. Sampled training at full width, 1,024-seed batches, fanouts (15,
    10, 5), ``MiniBatchTrainer`` on cuda (fused Adam) against torch
    (plain versions, plain Adam) from the same weights over the same
    batches, with phase 4's gates (the ReLU here is torch's, after the
    aggregation: ``decided_sampled_grads``): (a) SAGE-mean [128, 256,
    256, 40], Adam 0.01, the train mask cut to 4,096 nodes (from 8,192,
    for the command's time), 2 epochs of 4 steps, exactly 6 ``bsr_spmm`` launches a step (each layer's
    forward and backward product) and 1 Adam launch, and ``bsr_spmm`` on
    one batch's A and Aᵀ at the layers' widths against its plain version
    and ``torch.sparse.mm``; (b) GAT as phase 13, lr 0.002, 4 steps over
    one 1,024-seed batch, exactly 3 / 3 / 3 attention launches and 1
    Adam launch a step, and the three passes on one batch's real
    operands and cotangents (dy rescaled) against their plain versions;
    (c) one step each of GT [8710, 32, 70] with 4 heads on the corafull
    analog (layer 0 on ``gather.feature_matmul_sparse``, fanouts (10,
    5)) and of SAGE-max [128, 256, 256, 40]. Per path the host sampling
    and copy ms and the step's ms a batch, the column builds, and a
    profiled step's device ms by kernel and idle share.
15. gemma3-1b served at its published widths and depth (26 layers,
    d_model 1152, 4 heads with 1 KV head of 256, d_ff 6912, vocab
    262,144; a 512-token window on 22 layers, layers 5, 11, 17 and 23
    global; 792,994,176 parameters), phase 10's requests and checks:
    exactly 4 ``flash_attention`` launches a wave (the global layers; a
    windowed layer always takes the masked core) and none in decode; the
    1,024-token wave and every decode step past position 512 make the
    window bite. Then phase 11's checks of the kernel at D = 256 on the
    four global layers' real q, k, v (B 4, H 4, Hkv 1, T 1024) and on
    ragged D = 256 shapes (``d256_edge_cases``), its time beside SDPA's
    and the bound.
16. LM training at full width: llama3.2-1b (1,235,814,400 parameters in
    11 leaves) through ``make_train_step(build_model(cfg, remat="layer"),
    adamw(warmup_cosine(3e-4, 2, 10), fused=True))`` at bfloat16 compute,
    10 steps over one fixed ``make_dummy_batch`` of 4 x 1,024 tokens:
    exactly one ``fused_adam`` launch a step and no other kernel of the
    port, a falling loss; the ``torch`` program (plain Adam) from the same
    weights and batch after the first program's optimizer state is freed:
    losses within 1e-3 relative at every step, parameters within 1e-2 a
    leaf. The step's synchronised ms, tokens/s, the run's peak memory, a
    profiled step by kernel class; the Adam kernel on the LM's leaves
    against its plain version (1e-6), its CUDA-event ms beside
    ``torch.optim.AdamW(fused=True)``'s and the bound.
17. The layout stage and γ, with a fresh layout cache: (a)
    ``plan_layout`` on phase 4's graph at width 256, ``cuda``, fused:
    each order's block count beside its column-stream length, each timed
    candidate (one ``bc`` a block height) beside its cost-model score,
    the winner, measured; a second call a cache hit that measures
    nothing; then phase 4's program at ``layout="auto"`` from phase 4's
    weights with phase 4's gates against the torch program at the same
    layout, its first step's logits in user order within 1e-4 of phase
    4's, its losses within 1e-3 relative of phase 4's at every epoch,
    the median epoch and a profiled epoch beside phase 4's; (b) the same
    for the quickstart at width 32; (c) γ measured (``measure_gamma``,
    the microbenchmark of ``calibrate_gamma``: the Hopper ``bsr_spmm``
    over X's nonzero columns against fp32 ``torch.matmul``, CUDA events)
    at the JAX package's default shape (1,024 x 1,024 -> 64, launch-bound
    on this card) and at the quickstart's layer 0 (corafull's X ->
    32), the decision each γ gives the quickstart's and GT's layer 0,
    and the quickstart's epoch with layer 0 forced sparse (γ 0.20, the
    default, which stays) and dense (γ 0.01), in turns, losses within
    1e-3 relative.
18. The runtime: (a) phase 4's GCN and weights through
    ``FullBatchTrainer`` under ``GuardPolicy()`` with epoch 3's
    gradients poisoned with NaN: that epoch's params bitwise those before
    it, every loss finite; the epoch-10 save killed (``checkpoint_kill``)
    leaves step 5 the newest checkpoint, from which a fresh trainer
    resumes to the uninterrupted run's params bit for bit; the host ms
    of a save and a restore, the guarded epoch beside phase 4's; (b)
    phase 14's SAGE-mean over the train mask cut to 4,096 nodes (4
    steps an epoch), interrupted after epoch 1 and resumed to epoch 2:
    every batch's seed ids, the losses and the params bitwise the
    uninterrupted run's (where they are not, the uninterrupted run is
    repeated and the resume held to the repeat's difference).
19. The plan-contract verifier (``core/verify.py``) and the chaos soak.
    Every lowering above ran ``validate="fast"``, the default. (a) Each
    plan that phases 3-17 lowered (serving, the arxiv GCN, the
    quickstart, GAT, GT, sampled GAT serving, sampled SAGE, GAT, GT and
    SAGE-max, both ``layout="auto"`` plans) verified in fast and in full
    mode where its phase holds it, against its exec graph: zero
    violations, each mode's ms (synchronised, median of 3); full mode's
    value checks are reductions on the card, and a sampled plan's
    template batch builds its column streams there. (b) One ``lower`` of
    the arxiv GCN and one ``lower_sampled`` of the sampled SAGE plan with
    ``validate="off"``, and the shares that (a)'s fast and full checks of
    those plans add to it. (c) The quickstart GCN lowered at
    ``layout="degree"`` on the card passes full mode; six corruptions of
    its card-resident operands are each flagged by name through
    ``check_plan``: an unsorted block column, a NaN block, an item
    dropped from A's column stream, a stale stream after
    ``dataclasses.replace(blocks=...)``, a swapped ``perm`` pair, a
    block-row with twice its mass. (d) ``tools/chaos_soak.py``'s 24
    schedules on the card but its 6 distributed ones (phase 24 (e) runs
    those): guarded full-batch and sampled training with poisoned
    gradients and killed checkpoint writers, the serving engine's
    degradation rungs; every end-state property holds; its launches are
    the kernels line's ``chaos`` path, and every kernel call it made is
    held against its plain version on the same inputs within 1e-4 (the
    inputs and outputs recorded as it ran, the plain versions run after
    the counts are read).
20. The MoE family, after phases 2-19 have returned and freed the card.
    (a) dbrx-132b served at its published widths (d_model 6,144; 48
    heads over 8 KV heads of 128; 16 experts of 10,752, top-4, capacity
    factor 1.25; vocab 100,352), cut to 2 layers (one scanned segment of
    2): 7,751,331,840 parameters, phase 10's requests and checks: exactly
    2 ``flash_attention`` launches a wave (D = 128) and none in decode,
    no other kernel of the port; both programs' MoE routing recorded
    (``RoutingLog``), the logits held within 1e-4 and the greedy tokens
    where the top-2 margin exceeds ``TOKEN_MARGIN`` on every call of a
    wave before its routing parts, and no token parted at a top-k margin
    above ``ROUTE_MARGIN``; a profiled prefill and decode step by class
    (expert bmm, dispatch/combine, flash, other products, elementwise).
    (b) Phase 11's checks of the kernel at D = 128 on (a)'s 1,024-token
    wave (B 4, H 48, Hkv 8, T 1024) and ragged D = 128 shapes
    (``d128_edge_cases``), its time beside SDPA's and the bound. (c)
    deepseek-v3-671b served at its published widths (d_model 7,168; 128
    MLA heads, q rank 1,536, kv rank 512, qk 128 + 64, v 128; 256
    experts of 2,048, top-8, 1 shared; dense FFN 18,432; vocab 129,280),
    cut to 2 layers (one dense, one MoE) without MTP: 13,944,130,560
    parameters, the same requests and checks with no kernel of the port
    launched (MLA takes the masked core), and its latent cache's bytes
    beside a full K/V cache's. (d) deepseek-v3-671b trained at a width cut
    (d_model 2,048, 16 heads, vocab 32,768, 3 layers: one dense, then a
    scanned segment of 2 MoE layers of ``MOE_TRAIN_EXPERTS`` experts;
    MLA, the FFN widths, top-8, the shared expert and MTP as published:
    1,563,119,616 parameters) through phase 16's checks, after two runs
    of the first step's backward that must be bitwise equal. Each part's
    peak allocation.
21. The recurrent families, after phase 20 has returned and freed the
    card. (a) zamba2-7b served at its published widths and depth (81
    layers: 68 Mamba2 blocks of d_inner 7,168, 112 heads of 64, state 64,
    chunk 128; 13 shared sites of one GQA block, 32 heads of 112, and
    MLP 14,336; vocab 32,000; 5,736,924,992 parameters), phase 10's
    requests and checks: exactly 13 ``flash_attention`` launches a wave
    (D = 112, one a shared site) and none in decode, no other kernel of
    the port; its longest prefill timed by block kind. (b) Phase 11's
    checks of the kernel at D = 112 on (a)'s 1,024-token wave (B 4, H 32,
    Hkv 32, T 1024) and on ``d128_edge_cases``' shapes at D = 112, its
    time beside the plain version's, SDPA's and the bound. (c)
    xlstm-1.3b served at its published size (48 layers, 42 mLSTM and 6
    sLSTM, d_model 2,048, 4 heads of 512; 1,283,330,048 parameters),
    the same requests and checks with no kernel of the port launched; its
    longest prefill timed by block kind (the sLSTM loop's share). (d) For
    both, the longest wave prefilled whole against prefilled to T - 4 and
    decoded 4 steps: the last logits within 2e-2. (e) xlstm-1.3b trained
    at its published size through phase 16's checks on a batch of 4 x
    ``HYBRID_TRAIN_SEQ`` tokens (256: two of its mLSTM chunks of 128, so
    the state carried from chunk to chunk runs forward and backward) for
    ``HYBRID_TRAIN_STEPS`` steps
    (2), two ``fused_adam`` launches a step (its 86 leaves fill two
    tables of ``CAPACITY``), after two runs of the first step's backward
    that must be bitwise equal (no profiled step: ~30 launches a time
    step of the sLSTM loop). Each part's peak allocation.
22. The encoder-decoder and the vision frontend, after phase 21 has
    returned and freed the card; the cuda and torch programs share one
    parameter tree a model. (a) whisper-tiny at its published size (4
    encoder layers over 1,500 frames, 4 decoder layers, d_model 384, 6
    heads of 64, vocab 51,865): one wave of 4 prompts of 1,024 tokens
    with frames [4, 1,500, 384] from a seeded generator on the card,
    through ``make_prefill_step``, then 32 greedy ``make_decode_step``s
    (``frontend_wave``): exactly 12 ``flash_attention`` launches in the
    prefill (4 encoder layers non-causal at T 1,500, 4 causal
    self-attentions, 4 non-causal cross attentions at Tq 1,024 x Tk
    1,500) and none in decode, no other kernel, the torch program's
    logits within 1e-4 at every call and its greedy tokens where the
    top-2 margin exceeds ``TOKEN_MARGIN``; then phase 10's requests
    through the engine, text alone as the JAX engine runs them (the cross
    attention over the cache's zeroed encoder output: 8 launches a
    wave), held as phase 10 holds them. (b) Phase 11's checks of the
    kernel on the q, k, v of (a)'s and (c)'s prefills by kind (whisper's
    encoder, self and cross attention; pixtral-12b's B 4, H 32, Hkv 8, T
    1,280, D 128, causal), each kind's CUDA-event ms beside the plain
    version's, SDPA's and the bound. (c) pixtral-12b at its published
    size (40 layers, d_model 5,120, 32 heads over 8 KV heads of 128,
    vocab 131,072; 12,247,782,400 parameters): one wave of 4 prompts of
    1,024 text tokens after 256 patch embeddings [4, 256, 5,120], then
    32 decode steps, the same gates, exactly 40 flash launches in the
    prefill and none in decode; a profiled prefill by kernel class. (d)
    Phase 16's checks on whisper-tiny whole (4 x 1,024 tokens with its
    frames, 10 steps) and on pixtral-12b cut to ``PIXTRAL_TRAIN_LAYERS``
    (2) layers at its published widths (1,887,462,400 parameters, 2 steps
    of 4 x (256 + 768) tokens). Each part's peak allocation.
23. Distributed full-batch training, after phase 22 has returned and
    freed the card: 4 rank processes share the card in one gloo group
    (``launch/mesh.py:run_ranks``) and train through
    ``hierarchical_partition -> build_distributed_graph ->
    lower_distributed -> DistributedGNNTrainer``, from seed 0: (a) phase
    4's GCN [128, 256, 256, 40] on the ogbn-arxiv analog at full scale,
    partitioned 4 ways at ``br=8, bc=32``, Adam 0.01, 5 epochs; (b) phase
    7's GAT [128, 750, 750, 40], 3 heads, Adam 0.002, 7 epochs (as in
    phase 7: the loss leaps at the second step and is back below its
    first value only after 5), on the same partition (its effective
    aggregation is GCN's, so the same ``DistributedGraph``); (c) SAGE-mean [8710, 16, 70] on the corafull
    analog (19,793 nodes), the JAX package's ``examples/distributed_gnn.py``
    model, layer 0 on ``dist_feature_matmul_sparse``, 5 epochs. Two worker
    processes partition, build, lower and verify each plan in fast and
    full mode (timed) and write each rank's slices, while the three
    single-device cuda programs train on the card from the same weights;
    then one spawn runs the three runs on every rank. Gates per run: the
    first step's loss within 1e-4 and each gradient leaf within 1e-3
    norm-relative of the single-device program at the same parameters
    (where the two programs' ReLU decisions part, the single-device one
    takes the distributed one's, each within 1e-5 of 0); the losses over
    the epochs within 1e-3 relative of the single-device program's, and
    falling; the four ranks' losses equal and parameters bitwise equal
    after every epoch; each of the run's kernels launched on every rank
    and nothing else, Adam once a step; every kernel call of rank 0's
    first step within 1e-4 of its plain version on the same operands
    (the interior and boundary streams), and the Adam kernel at 1e-6.
    Printed: per run and rank the epoch ms (synchronised, median) beside
    the single-device epoch, per layer the exchange's pack and copy out,
    wire and copy in (one instrumented step) and whether the interior
    kernel ran inside the wire's window, each kernel's CUDA-event ms on
    the streams beside its plain version's, the library call's and the
    bound, and the host's partition and build seconds.
24. Host-streamed strips on the card and the distributed resilience
    plane, after phase 23 has returned (its 4-way partitions of both
    graphs reused). (a) Phase 4's GCN [128, 256, 256, 40] on the
    ogbn-arxiv analog, first through the resident cuda program (seed 0:
    its first step's loss and gradients, ``STREAM_EPOCHS`` epochs, their
    peak allocation), then on ``build_streamed_operand(graph, "gcn",
    k_shards=4, budget_bytes=128 MiB)`` (halved until A and Aᵀ each cut
    into 8 strips or more) as the JAX package's
    ``examples/host_streamed_demo.py`` trains it: ``LayerOps(aggregate=
    op.aggregate)`` a layer, ``pipelined_value_and_grad``, fused Adam
    0.01, from the same weights. Gates: the first step's loss within
    1e-4 and each gradient leaf within 1e-3 norm-relative of the
    resident program's; exactly 3 x (strips of A + strips of Aᵀ)
    ``bsr_spmm_accumulate`` launches and one Adam launch an epoch, no
    other kernel (no strip reaches a plain version); the losses finite
    and falling; every strip's accumulate call within 1e-4 of its plain
    version on the same y, the block-rows a strip boundary splits
    checked apart. Printed: build seconds, strips, the JAX package's
    block-byte reckoning, the pinned and card bytes of the column
    streams, the peak allocation beside the resident program's, the
    median epoch beside its, per pass and strip the copy and kernel ms
    and whether copy s + 1 ended inside kernel s (CUDA events), a
    profiled epoch, one strip's call (device, plain, ``torch.addmm``,
    bound) and a pass over A's strips in the accumulate mode beside a
    fresh y_s a strip plus ``add_``. (b) The fetch's host half on the
    card (the JAX demo's operand, checksums on): a transient fault
    retries to a bitwise-equal y; a permanent one raises
    ``StreamFetchError`` naming strip, shard and operand; a flipped bit
    in a pinned column stream raises ``StripChecksumError``. (c)
    ``ResilientDistributedTrainer`` on 4 ranks sharing the card, SAGE-mean
    [8710, 16, 70] on the corafull analog: the JAX package's rank-death
    schedule (NaN at step 1, rank 2 dead from step 3, 12 epochs) ends on
    3 ranks after one rescale with the NaN step skipped, a straggler
    schedule (rank 1 8x slower from step 2, 6 epochs) after one
    rebalance with the state carried bitwise; losses finite and falling;
    the group's loss and gradients at the carried params within 1e-4 and
    1e-3 norm-relative of the single-device cuda program's; in every
    segment each rank's launches counted from 0 (each of the SAGE run's
    kernels launched on every rank, path ``resilient``) and rank 0's first
    step's kernel calls (on the 4-rank, the 3-rank and the rebalanced
    operands) held against their plain versions; each event's
    ``recovery_s`` and the segments' epoch ms. (d) ``compressed_psum`` on 4
    ranks against the exact mean (the JAX package's case within its 0.2
    bound). (e) The chaos soak's distributed schedules among its first 8.
25. The one-card dry run held against the card, after phase 24 has
    returned: three ``SHAPES`` cells at full width and length, each first
    reckoned over ``meta`` tensors (``launch/specs.py:build_cell``,
    ``launch/step_cost.py:reckon``), then built on the card from seed 0
    and run through the same step closure: (a) gemma3-1b x long_500k
    whole (a bfloat16 cache of 524,288 positions, one decode step at the
    last); (b) llama3.2-1b x prefill_32k, one of its 32 sequences (flash
    at T = 32,768 in bfloat16 in all 16 layers); (c) llama3.2-1b x
    train_4k, one 4,096-token sequence of its 256 (bfloat16 compute,
    remat, one ``fused_adam`` launch). For each, after a warm-up step: a
    step with the counts set to 0 just before it, which must launch the
    kernels as the dry run counted them, and whose peak allocation over
    what was allocated before it must lie within max(PEAK_RTOL,
    PEAK_SLACK) of the simulated peak; its output checked (finite logits
    of the cell's shape, or a finite loss and new state); then
    DRYRUN_REPS synchronised steps, their median beside the bound, the
    roofline fraction and the MFU. (b)'s layer-0 flash call is held
    against the plain version on its first FLASH_HEAD_ROWS rows and its
    last FLASH_TAIL_ROWS rows over every key (each row within
    FLASH_ROW_RTOL of its own largest value; the check must fail on zeroed
    rows), and timed (CUDA events) beside SDPA on K/V repeated to 32 heads
    and the bound (bf16's peak).

The card's clocks, temperature and power draw are printed before and
after the phases. The last lines are the card's name and power limit,
one JSON object with every kernel's numbers, and ``{"ok": true,
"device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import multiprocessing
import os
import pickle
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import layout as layout_mod  # noqa: E402
from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.core.layout import (  # noqa: E402
    _candidate_grid,
    _load_cache,
    _model_scores,
    column_stream,
    plan_layout,
)
from repro_torch.core.halo import build_distributed_graph  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    effective_aggregation,
    lower,
    lower_distributed,
    lower_sampled,
)
from repro_torch.core.partitioner import hierarchical_partition  # noqa: E402
from repro_torch.core.verify import (  # noqa: E402
    PlanVerificationError,
    check_plan,
    verify_plan,
)
from repro_torch.core.sparsity import (  # noqa: E402
    PAPER_GAMMA_DEFAULT,
    decide_execution_path_from_stats,
    measure_gamma,
)
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.graph.csr import (  # noqa: E402
    REORDER_MODES,
    adaptive_bc,
    bsr_block_count,
    csr_from_dense,
    csr_from_edges,
    csr_to_bsr,
    permute_graph,
    reorder_graph,
)
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    BUILT_BR,
    bsr_spmm,
    bsr_spmm_accumulate,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
    nonzero_columns,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention,
    flash_cost,
)
from repro_torch.kernels.fused_adam import (  # noqa: E402
    CAPACITY,
    fused_adam,
    fused_adam_multi,
)
from repro_torch.kernels.ref import (  # noqa: E402
    bsr_spmm_accum_ref,
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
    flash_attention_ref,
    fused_adam_ref,
)
from repro_torch.models.model_zoo import (  # noqa: E402
    build_model,
    make_decode_step,
    make_dummy_batch,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.transformer import _layer_window  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.models.gnn import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.launch.mesh import RankPool, run_ranks  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    InjectedFault,
    ResilientDistributedTrainer,
    RetryPolicy,
    StreamFetchError,
    StripChecksumError,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.runtime.streaming import build_streamed_operand  # noqa: E402
from repro_torch.core.pipeline import arch_layer_fns, pipelined_value_and_grad  # noqa: E402
from repro_torch.models.gnn import LayerOps  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adam,
    adamw,
    bias_corrected_lr,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.training.schedule import warmup_cosine  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    DistributedGNNTrainer,
    FullBatchTrainer,
    MiniBatchTrainer,
    value_and_grad,
)
from repro_torch.launch.serve import build_engine, drive  # noqa: E402
from repro_torch.launch.roofline import analyze as roofline_of  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon  # noqa: E402
from repro_torch.serving.gnn_engine import GNNServingEngine  # noqa: E402
from tools import chaos_soak  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 dense on the tensor cores
TOL = 1e-4
ADAM_TOL = 1e-6
MASK_MARGIN = 1e-5
#: cuda against torch program, per leaf, the norm of the difference over the
#: leaf's norm: both programs' gradients at the same parameters, and each
#: program's parameters after the last epoch. Where a pre-activation lies
#: within rounding of 0 the programs' ReLU masks may part: the kernels and
#: the plain versions sum in other orders, so such a sum may take either
#: sign in the two.
#: The analog's labels are random, so its gradients nearly cancel: one
#: flip moved layer 0's gradient by 6e-5 (ogbn-arxiv, the first step) and
#: by 1.9e-3 (the quickstart after 10 epochs, |pre| ~1e-7; H100 runs). So
#: the gradient check holds every decision the two part on to |pre| <=
#: MASK_MARGIN and gives the torch program the cuda program's there
#: (``decided_grads``). Adam, which normalises gradients, carries such gaps
#: into the parameters (0.9-1e-2 after 10 epochs; the quickstart's 4e-7)
GRAD_RTOL = 1e-3
PARAM_RTOL = 5e-2
ADAM = ("adam", 0.01, 0.9, 0.999)
#: DGL's ogbn-arxiv GAT example's optimizer (its widths are phase 7's). At
#: lr 0.01 Adam's first steps move every weight of the 750-wide layers by
#: about 0.01 and the loss leaps from 3.70 to 25-35 (an H100 run): in that
#: chaos the two programs' 1e-7 differences grow past 1e-3 by epoch 5
GAT_ADAM = ("adam", 0.002, 0.9, 0.999)
#: phase 14's lengths: SAGE's epochs over the cut train mask, GAT's steps
#: over one batch
SAGE_EPOCHS = 2
GAT_STEPS = 4
#: phase 17: γ below which the quickstart's layer 0 (s = 0.95) runs dense
#: (τ = 1 - γ above s)
DENSE_GAMMA = 0.01
#: phase 18: the guarded GCN's poisoned epoch and its checkpoint interval;
#: the sampled resume's epochs (interrupted after the first)
POISONED_EPOCH = 3
CKPT_EVERY = 5
RESUME_EPOCHS = 2
#: phase 19: repeats of each timed verification (medians)
VERIFY_REPS = 3

#: every kernel wrapper of the port, by the name the kernels line uses
KERNELS = {"bsr_spmm": bsr_spmm,
           "bsr_spmm_accumulate": bsr_spmm_accumulate,
           "bsr_spmm_fused_epilogue": bsr_spmm_fused_epilogue,
           "bsr_spmm_masked": bsr_spmm_masked,
           "fused_adam": fused_adam,
           "bsr_attention_fwd": bsr_attention_fwd,
           "bsr_attention_bwd_row": bsr_attention_bwd_row,
           "bsr_attention_bwd_col": bsr_attention_bwd_col,
           "flash_attention": flash_attention}
#: one call's launches of each timed SpMM call (``timings``' ``expect``):
#: the kernel, its plain version, the library yardstick
SPMM_EXPECT = {"": {"bsr_spmm": 1}, "plain_": {}, "library_": {}}
#: the same on a sampled training batch, whose plain calls (summed in
#: stream order, a host sync a chunk) are long: CUDA events time them
SAMPLED_SPMM_EXPECT = {"": {"bsr_spmm": 1}, "library_": {}}
#: the attention kernels and their plain versions, by pass
ATTENTION = {"fwd": ("bsr_attention_fwd", bsr_attention_fwd, bsr_attention_fwd_ref),
             "row": ("bsr_attention_bwd_row", bsr_attention_bwd_row,
                     bsr_attention_bwd_row_ref),
             "col": ("bsr_attention_bwd_col", bsr_attention_bwd_col,
                     bsr_attention_bwd_col_ref)}
#: the CUDA sources (kernels/csrc/<name>.cu) the kernels are built from
LIBRARIES = ["bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked", "fused_adam",
             "bsr_attention", "flash_attention"]
SOURCES = {
    "bsr_spmm": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:105"),
    "bsr_spmm_accumulate": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                            "src/repro/kernels/bsr_spmm.py:105"),
    "bsr_spmm_fused_epilogue": ("src/repro_torch/kernels/csrc/bsr_spmm_fused.cu",
                                "src/repro/kernels/bsr_spmm.py:245"),
    "bsr_spmm_masked": ("src/repro_torch/kernels/csrc/bsr_spmm_masked.cu",
                        "src/repro/kernels/bsr_spmm.py:312"),
    "fused_adam": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam.py:86"),
    "bsr_attention_fwd": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                          "src/repro/kernels/bsr_attention.py:133"),
    "bsr_attention_bwd_row": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                              "src/repro/kernels/bsr_attention.py:190"),
    "bsr_attention_bwd_col": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                              "src/repro/kernels/bsr_attention.py:267"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:106"),
}

#: the epilogue specs the lowering emits: (self_term, bias, activation)
SPECS = {
    "gcn (bias+relu)": (False, True, "relu"),
    "gcn last (bias)": (False, True, "none"),
    "sage (self+bias+relu)": (True, True, "relu"),
    "gin sparse (self*alpha+bias+relu)": (True, True, "relu"),
    "gin dense (self*alpha)": (True, False, "none"),
}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The configurations; the defaults are the full-width run."""

    dataset: str = "ogbn-arxiv"
    scale: float = 1.0
    hidden: int = 256
    fanouts: tuple = (15, 10, 5)
    batch_size: int = 256
    n_buckets: int = 2
    wave_size: int = 8
    n_requests: int = 64
    # full-batch training: GCN [F, train_hidden..., C] on `dataset`
    train_hidden: tuple = (256, 256)
    epochs: int = 10
    # phase 7's GAT and phase 23's distributed GAT: 7 epochs (cut from 10
    # for the command's time: the plain GAT epoch takes ~10 s; at lr 0.002
    # the loss is back below its first value from epoch 6)
    gat_epochs: int = 7
    # the quickstart: GCN [F, 32, C] on the corafull analog
    quick_dataset: str = "corafull"
    quick_scale: float = 1.0
    quick_hidden: tuple = (32,)
    # attention: GAT [F, gat_hidden..., C] on `dataset`, GT [F,
    # quick_hidden..., C] on `quick_dataset`
    gat_hidden: tuple = (750, 750)
    gat_heads: int = 3
    gt_heads: int = 4
    # LM serving: `lm_arch` (its reduced() variant where `lm_reduced`),
    # `lm_requests` prompts of lm_prompts[0]..lm_prompts[1] tokens (the
    # longest set to lm_prompts[1]), `lm_new_tokens` each, `lm_slots` slots
    lm_arch: str = "llama3.2-1b"
    lm_reduced: bool = False
    lm_requests: int = 8
    lm_prompts: tuple = (128, 1024)
    lm_new_tokens: int = 32
    lm_slots: int = 4
    # LM training (phase 16): llama3.2-1b (reduced where `lm_reduced`) on
    # one lm_train_batch x lm_train_seq batch for lm_train_steps steps
    lm_train_batch: int = 4
    lm_train_seq: int = 1024
    lm_train_steps: int = 10
    # the sampled path (phases 13-14): GAT serving at gat_hidden on
    # `dataset` with `fanouts`, `batch_size`; training with
    # `sampled_batch_size`-seed batches: SAGE over the train mask cut to
    # `sage_cut` nodes for SAGE_EPOCHS epochs, GAT over one batch for
    # GAT_STEPS steps
    sampled_batch_size: int = 1024
    sage_cut: int = 4096  # cut from 8192 for the command's time
    # phase 18: sampled SAGE-mean resumed over the train mask cut to
    # `resume_cut` nodes, RESUME_EPOCHS epochs
    resume_cut: int = 4096


def zero_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


#: the card's clocks, temperature and power, read before and after the
#: phases: a card that runs below its clocks slows every timing of a run
#: alike, library calls included
CLOCKS = "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"


def time_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Wall time of one call: CUDA events around ``reps`` calls on the card
    (after ``warmup`` calls), so host launch overhead shows where it is
    longer than the device work; the host clock off the card."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


#: profiler windows tried before a measurement falls back to CUDA events
PROFILE_TRIES = 3


def device_events(prof):
    """(name, device µs, launches) of every kernel, copy and memset the
    window recorded; the step's own annotation, which spans them, is left
    out."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if not e.key.startswith("ProfilerStep")]


def window_complete(prof, expect: dict) -> bool:
    """Did the window record device time, and exactly ``expect[k]``
    launches of each kernel ``k`` (``launch_key``'s names)? In the
    full-width run, windows over a few back-to-back launches of the long
    full-graph SpMM kernels recorded only some of them (three 53 ms
    launches read as 17.7 ms each), and a window once recorded nothing,
    though each mode recorded every launch when run alone on the card."""
    got = defaultdict(int)
    busy = 0.0
    for name, us, n in device_events(prof):
        got[launch_key(name)] += n
        busy += us
    if busy > 0 and all(got[k] == v for k, v in expect.items()):
        return True
    print(f"[profile] incomplete window: {busy / 1e3:.3f} ms busy, launches "
          f"{ {k: got[k] for k in expect} }, expected {expect}")
    return False


def profiled(fn, device, expect: dict, cpu: bool = False):
    """``torch.profiler`` (CUDA activity only, or CPU activity too) over
    one call of ``fn``, after one more call as the profiler's warmup step,
    which is discarded; the first of ``PROFILE_TRIES`` windows that is
    complete for ``expect`` (``window_complete``) and its number, else
    (None, PROFILE_TRIES)."""
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with warnings.catch_warnings():  # "profiler clears events each cycle"
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=activities, schedule=sched) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize(device)
                    prof.step()
        if window_complete(prof, expect):
            return prof, attempt
    return None, PROFILE_TRIES


def busy_ms(prof) -> float:
    """Summed duration of every kernel, copy and memset a CUDA-only
    profiler window recorded (one stream: the device's busy time)."""
    return sum(t for _, t, _ in device_events(prof)) / 1e3


def device_ms(fn, device, reps: int, expect: dict):
    """Device time of one call of a short call: ``profiled`` over ``reps``
    back-to-back calls, busy time over ``reps`` — what the call keeps the
    card busy, without host launch gaps. ``expect`` is one call's launches
    by kernel. None where no window held them all (a window without the
    warmup step recorded 15 of 18 ``fused_adam`` launches, every time), or
    off the card."""
    if device.type != "cuda":
        return None
    prof, _ = profiled(lambda: [fn() for _ in range(reps)], device,
                       {k: v * reps for k, v in expect.items()})
    return None if prof is None else busy_ms(prof) / reps


def _bound(nbytes: float, flop: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmm_bound(rows, cols, blocks, f: int, n_rows_padded: int) -> dict:
    """Least time for Y = A·X on these inputs, counted two ways; fp32
    operations on the nonzeros in both. ``bound_ms`` (``bytes``), the
    bound the three SpMM kernels answer to, since they read only nonzero
    columns: each nonzero's value and column index and a row pointer per
    row read once, the X rows the nonzeros reference, Y written once.
    ``layout_bound_ms`` (``layout_bytes``), the BSR layout's: the blocks
    that hold a nonzero, whole, their indices and the X rows of their
    block-columns (zero padding and empty-row blocks carry nothing), Y
    once. ``nnz_bound_ms`` is ``bound_ms``, under the key the attention
    kernels' any-layout bound has. ``dense_flop`` is the work on every
    stored block."""
    nb, br, bc = blocks.shape
    nz = blocks.ne(0)
    used = nz.reshape(nb, -1).any(dim=1)
    n_used = int(used.sum())
    x_rows = int(torch.unique(cols[used]).numel()) * bc
    layout_bytes = 4 * (2 * n_used + n_used * br * bc + x_rows * f + n_rows_padded * f)
    b_idx, _, j = torch.nonzero(nz, as_tuple=True)
    nnz = int(b_idx.numel())
    nnz_x_rows = int(torch.unique(cols[b_idx].long() * bc + j).numel())
    nbytes = 4 * (2 * nnz + n_rows_padded + 1 + nnz_x_rows * f + n_rows_padded * f)
    out = {"blocks_used": n_used, "nnz": nnz, "x_rows": x_rows,
           "nnz_x_rows": nnz_x_rows, "bytes": nbytes, "layout_bytes": layout_bytes,
           "flop": 2.0 * nnz * f, "dense_flop": 2.0 * nb * br * bc * f}
    return _spmm_bounds(out)


def _spmm_bounds(out: dict) -> dict:
    """``bound_ms``/``bound_by``, ``nnz_bound_ms`` and ``layout_bound_ms``
    of a ``spmm_bound`` count (``nnz_bytes`` the same count as ``bytes``,
    as ``sum_rows`` sums it over every sparse row)."""
    out["nnz_bytes"] = out["bytes"]
    out["bound_ms"], out["bound_by"] = _bound(out["bytes"], out["flop"])
    out["nnz_bound_ms"] = out["bound_ms"]
    out["layout_bound_ms"], _ = _bound(out["layout_bytes"], out["flop"])
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timings(calls: dict, device, reps: int,
            expect: "dict | None" = None) -> dict:
    """``<prefix>wall_ms`` (CUDA events over ``reps`` back-to-back calls
    after one more)
    and ``<prefix>ms`` for each named call, with ``<prefix>ms_by`` saying
    how ``ms`` was taken. ``expect`` maps a prefix to its call's launches
    by kernel: those calls are short, and ``ms`` is their device time from
    the profiler (``device_ms``), or the CUDA-event time where no window
    was complete. Calls without an entry are the full-graph calls, which
    keep the card busy far longer than their launches take: ``ms`` is the
    CUDA-event time (the host clock off the card)."""
    expect = expect or {}
    out = {}
    for prefix, fn in calls.items():
        out[prefix + "wall_ms"] = time_ms(fn, device, reps, warmup=1)
        ms = (device_ms(fn, device, reps, expect[prefix])
              if prefix in expect else None)
        out[prefix + "ms"] = out[prefix + "wall_ms"] if ms is None else ms
        out[prefix + "ms_by"] = ("profiler" if ms is not None else
                                 "cuda events" if device.type == "cuda"
                                 else "host clock")
    return out


def csr_tensor(csr, device):
    """The weighted graph as a ``torch.sparse`` CSR tensor: the library
    yardstick's operand (timed beside the kernels, never used by the port)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)),
            torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols)).to(device)


def check_close(name, got, want, tol=TOL) -> float:
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def check_fused(name, op, x, s, b, alpha, spec, device) -> float:
    """The fused kernel (through the operand's nonzero columns) against its
    plain version on one operand and spec: y everywhere, the mask where
    |pre-activation| > MASK_MARGIN, and a repeat launch bitwise equal."""
    has_self, has_bias, act = spec
    args = (op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded,
            s if has_self else None, b if has_bias else None,
            alpha if has_self else None)
    nzc = op.nonzero_columns()
    y, mask = bsr_spmm_fused_epilogue(*args, act, nzc=nzc)
    y2, mask2 = bsr_spmm_fused_epilogue(*args, act, nzc=nzc)
    y_ref, mask_ref = bsr_spmm_fused_ref(*args, act)
    sync(device)
    err = check_close(f"bsr_spmm_fused_epilogue {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm_fused_epilogue {name}: a repeat "
                             "launch is not bitwise equal")
    if act == "relu":
        pre, _ = bsr_spmm_fused_ref(*args, "none")
        far = pre.abs() > MASK_MARGIN
        if not (torch.equal(mask[far], mask_ref[far]) and torch.equal(mask, mask2)):
            raise AssertionError(f"bsr_spmm_fused_epilogue {name}: masks differ")
    print(f"[kernel] bsr_spmm_fused_epilogue {name}: max_abs_err={err:.3g}")
    return err


def check_masked(name, op, x, mask, device) -> float:
    args = (op.block_rows, op.block_cols, op.blocks, x, mask, op.n_rows_padded)
    nzc = op.nonzero_columns()
    y = bsr_spmm_masked(*args, nzc=nzc)
    y2 = bsr_spmm_masked(*args, nzc=nzc)
    y_ref = bsr_spmm_masked_ref(*args)
    sync(device)
    err = check_close(f"bsr_spmm_masked {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm_masked {name}: repeat not bitwise equal")
    print(f"[kernel] bsr_spmm_masked {name}: max_abs_err={err:.3g}")
    return err


def on_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def check_spmm(name, rows, cols, blocks, x, n_rows_padded, device, nzc) -> float:
    """The kernel (through the operand's nonzero columns ``nzc``) against
    the plain version on the same device tensors, and a repeat launch
    bitwise equal."""
    y = bsr_spmm(rows, cols, blocks, x, n_rows_padded, nzc=nzc)
    y2 = bsr_spmm(rows, cols, blocks, x, n_rows_padded, nzc=nzc)
    y_ref = bsr_spmm_ref(rows, cols, blocks, x, n_rows_padded)
    sync(device)
    err = check_close(f"bsr_spmm {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm {name}: a repeat launch is not bitwise equal")
    print(f"[kernel] bsr_spmm {name}: max_abs_err={err:.3g}")
    return err


def unread_rows(op, limit: int = 64) -> torch.Tensor:
    """Up to ``limit`` X rows inside a stored block's columns that no
    nonzero multiplies: the rows where the kernels and the whole-block
    plain versions part under a non-finite X."""
    covered = torch.zeros(op.n_cols_padded, dtype=torch.bool, device=op.blocks.device)
    span = torch.arange(op.bc, device=covered.device)
    covered[(op.block_cols.long()[:, None] * op.bc + span).flatten()] = True
    covered[op.nonzero_columns().x_rows.long()] = False
    return covered.nonzero().flatten()[:limit]


def reading_rows(op, row: int) -> torch.Tensor:
    """Bool [n_rows_padded]: the output rows whose block-row holds a
    nonzero in X row ``row``'s column. There the kernels (over the nonzero
    columns) and the plain versions (over whole blocks) both read that X
    row; elsewhere only the plain versions do."""
    bc = op.bc
    held = ((op.block_cols.long() == row // bc)
            & (op.blocks[:, :, row % bc] != 0).any(dim=1))
    out = torch.zeros(op.n_rows_padded // op.br, dtype=torch.bool,
                      device=op.blocks.device)
    out[op.block_rows.long()[held]] = True
    return out.repeat_interleave(op.br)


def check_nonfinite(name, op, x, device) -> float:
    """The three SpMM kernels with inf, -inf and NaN in X rows that no
    nonzero of the operand multiplies (``unread_rows``): each gives the
    sparse product (the JAX package's ``gather`` answer), finite and
    within 1e-4 of its plain version on X with those rows zeroed, where
    the plain version on the non-finite X (whole blocks, as the Pallas
    kernel) gives NaN. Then an inf in an X row that a nonzero multiplies,
    in a column that also holds a stored zero (0·inf = NaN): the fused
    kernel's ReLU keeps the NaN of its sum, as ``torch.relu`` and
    ``jnp.maximum`` do, equal (NaN for NaN, inf for inf, within 1e-4
    elsewhere) to the plain version with its ReLU on the rows whose
    block-row reads that X row (``reading_rows``) and to the plain version
    on the finite X on the others, with its mask 0 on the NaNs.
    Returns the largest error (0.0 off the card, where the wrappers run
    the plain versions)."""
    rows = unread_rows(op)
    if rows.numel() == 0:
        raise AssertionError(f"non-finite {name}: no unread X row to poison")
    bad = x.clone()
    bad[rows] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                             device=x.device).repeat(rows.numel())[:rows.numel(), None]
    zeroed = x.clone()
    zeroed[rows] = 0.0
    mask = (torch.arange(x.numel(), device=x.device).reshape(x.shape) % 3 > 0).float()
    b = torch.linspace(-1.0, 1.0, x.shape[1], device=x.device)
    a = (op.block_rows, op.block_cols, op.blocks)
    n, nzc = op.n_rows_padded, op.nonzero_columns()
    got = {"bsr_spmm": (bsr_spmm(*a, bad, n, nzc=nzc), bsr_spmm_ref(*a, zeroed, n)),
           "bsr_spmm_fused_epilogue": (
               bsr_spmm_fused_epilogue(*a, bad, n, bias=b, activation="relu", nzc=nzc)[0],
               bsr_spmm_fused_ref(*a, zeroed, n, bias=b, activation="relu")[0]),
           "bsr_spmm_masked": (bsr_spmm_masked(*a, bad, mask, n, nzc=nzc),
                               bsr_spmm_masked_ref(*a, zeroed, mask, n))}
    plain = bsr_spmm_ref(*a, bad, n)
    sync(device)
    if bool(torch.isfinite(plain).all()):
        raise AssertionError(f"non-finite {name}: the plain version stayed finite")
    read = int(nzc.x_rows[int((nzc.values == 0).any(dim=1).nonzero()[0])])
    hit = x.clone()
    hit[read] = float("inf")
    y, y_mask = bsr_spmm_fused_epilogue(*a, hit, n, bias=b, activation="relu", nzc=nzc)
    plain_hit = bsr_spmm_fused_ref(*a, hit, n, bias=b, activation="relu")[0]
    # off the card the wrapper runs the plain version, whole blocks and all
    elsewhere = (bsr_spmm_fused_ref(*a, x, n, bias=b, activation="relu")[0]
                 if device.type == "cuda" else plain_hit)
    want = torch.where(reading_rows(op, read)[:, None], plain_hit, elsewhere)
    sync(device)
    nan = torch.isnan(want)
    if not bool(nan.any()) or not torch.equal(torch.isnan(y), nan):
        raise AssertionError(f"fused ReLU non-finite {name}: NaN where the "
                             f"plain version keeps one: {int(torch.isnan(y).sum())} "
                             f"against {int(nan.sum())}")
    if not torch.equal(torch.isinf(y), torch.isinf(want)):
        raise AssertionError(f"fused ReLU non-finite {name}: inf where the plain "
                             "version has none, or none where it has one")
    if bool(y_mask[nan].any()):
        raise AssertionError(f"fused ReLU non-finite {name}: mask 1 on a NaN")
    err = check_close(f"fused ReLU non-finite {name}", torch.nan_to_num(y),
                      torch.nan_to_num(want))
    if device.type != "cuda":
        return 0.0
    for kernel, (y, want) in got.items():
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{kernel} non-finite {name}: a non-finite output")
        err = max(err, check_close(f"{kernel} non-finite {name}", y, want))
    print(f"[kernel] non-finite X {name}: {rows.numel()} unread rows poisoned, the "
          f"three kernels finite within {err:.3g} of the plain versions on X with "
          f"those rows zeroed; an inf in read row {read}: the fused ReLU keeps "
          f"the plain version's {int(nan.sum())} NaNs")
    return err


def column_build(rows, cols, blocks, n_rows_padded, device, reps: int = 5) -> dict:
    """``nonzero_columns`` on one operand: its columns and bytes, the
    median build time of ``reps`` builds (synchronised host clock), and,
    on the card, its host syncs, counted by CUDA's sync debug mode."""
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        nzc = nonzero_columns(rows, cols, blocks, n_rows_padded)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"columns": int(nzc.x_rows.numel()), "nzc_bytes": nzc.nbytes,
           "split_rows": int(nzc.splits.shape[0]), "build_ms": float(np.median(times)),
           "host_syncs": None}
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                nonzero_columns(rows, cols, blocks, n_rows_padded)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    return out, nzc


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting one float past a 16-byte
    boundary, so no row is aligned for float4 loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def edge_cases(device) -> dict:
    """The three SpMM kernels on padding blocks and on a block-row with no
    blocks, F = 1, 33, 40, 70, 256 (33 and 70 ragged on the scalar path),
    every epilogue spec; on rows misaligned for float4 (F = 36); on a hub
    row of 8x128 blocks whose ~5,000 nonzero columns the kernels cut into
    segments of SPLIT_COLUMNS (F = 32, 40, 256); and the non-finite case
    (``check_nonfinite``) at F = 33, 40. Max abs error of each kernel."""
    r = np.random.default_rng(7)
    g = csr_from_edges(r.integers(0, 130, 300), r.integers(0, 150, 300), 150,
                       n_cols=130, data=r.standard_normal(300).astype(np.float32))
    bsr = csr_to_bsr(g, br=8, bc=8)
    padded = _pad_bsr(bsr, bsr.n_blocks + 9)
    no_blocks = {k: v[padded["rows"] != 4] for k, v in padded.items()}
    hub_src = np.concatenate([r.integers(0, 16384, 6000), r.integers(0, 16384, 300)])
    hub_dst = np.concatenate([r.integers(0, 8, 6000), r.integers(8, 48, 300)])
    hub = csr_to_bsr(csr_from_edges(hub_src, hub_dst, 48, n_cols=16384,
                                    data=r.standard_normal(6300).astype(np.float32)),
                     br=8, bc=128)
    cases = [("padding blocks", padded, bsr, f, False) for f in (1, 33, 40, 70, 256)]
    cases += [("row without blocks", no_blocks, bsr, f, False) for f in (1, 33, 40, 70, 256)]
    cases += [("misaligned rows", padded, bsr, 36, True)]
    cases += [("hub row", _pad_bsr(hub, hub.n_blocks + 3), hub, f, False)
              for f in (32, 40, 256)]
    err = {"spmm": 0.0, "fused": 0.0, "masked": 0.0}
    for label, arrays, op_bsr, f, shift in cases:
        gen = torch.Generator().manual_seed(f)
        x = torch.randn((op_bsr.padded_cols, f), generator=gen).to(device)
        s = torch.randn((op_bsr.padded_rows, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        m = (torch.randn((op_bsr.padded_cols, f), generator=gen) > 0).float().to(device)
        if shift:
            x, s, m = misaligned(x), misaligned(s), misaligned(m)
        alpha = torch.full((1,), 0.7, device=device)
        t = on_device(arrays, device)
        op = kops.BSRDevice(t["rows"], t["cols"], t["blocks"], op_bsr.n_rows,
                            op_bsr.n_cols, op_bsr.padded_rows, op_bsr.padded_cols,
                            op_bsr.br, op_bsr.bc)
        err["spmm"] = max(err["spmm"], check_spmm(
            f"{label} F={f}", t["rows"], t["cols"], t["blocks"], x,
            op_bsr.padded_rows, device, op.nonzero_columns()))
        for spec_name, spec in SPECS.items():
            err["fused"] = max(err["fused"], check_fused(
                f"{label} F={f} {spec_name}", op, x, s, b, alpha, spec, device))
        err["masked"] = max(err["masked"], check_masked(
            f"{label} F={f}", op, x, m, device))
        if label == "padding blocks" and f in (33, 40):
            err["nonfinite"] = max(err.get("nonfinite", 0.0), check_nonfinite(
                f"edge case F={f}", op, x, device))
    return err


def kernel_phase(ds, eng, device, reps: int = 20) -> dict:
    """``bsr_spmm`` on one largest-bucket batch's layer operands at the
    widths the main path gives them (u = X·W: hidden, ..., n_classes),
    through each operand's nonzero columns, built as the serving path
    builds them (once per batch and layer, on the device after the copy):
    their build time and host syncs (``column_build``) beside the
    kernel's."""
    sampler = eng.sampler
    seeds = np.random.default_rng(3).choice(ds.graph.n_rows, sampler.batch_size,
                                            replace=False)
    t0 = time.perf_counter()
    batch = sampler.sample_batch(seeds, eng.trainer.features)
    sample_s = time.perf_counter() - t0
    widths = eng.config.layer_dims[1:]
    edge = edge_cases(device)
    layers, err = [], edge["spmm"]
    for l, blk in enumerate(batch.blocks):
        f = widths[l]
        n_out = batch.bucket.node_caps[l + 1]
        n_in = batch.bucket.node_caps[l]
        x = torch.randn((n_in, f), generator=torch.Generator().manual_seed(l)).to(device)
        t = on_device(blk.fwd_bsr, device)
        build, nzc = column_build(t["rows"], t["cols"], t["blocks"], n_out, device)
        err = max(err, check_spmm(f"layer {l} [{n_out}x{n_in}] F={f}",
                                  t["rows"], t["cols"], t["blocks"], x, n_out,
                                  device, nzc))
        csr = blk.csr
        a_lib = csr_tensor(csr, device)
        lib_err = float((torch.sparse.mm(a_lib, x)
                         - bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x,
                                        n_out)).abs().max())
        if not lib_err <= TOL:
            raise AssertionError(f"library yardstick disagrees: {lib_err}")
        row = {
            "layer": l, "n_rows_padded": n_out, "n_cols_padded": n_in, "F": f,
            "n_blocks": int(t["blocks"].shape[0]), "nnz": int(csr.nnz), **build,
        }
        calls = {
            "": lambda: bsr_spmm(t["rows"], t["cols"], t["blocks"], x, n_out, nzc=nzc),
            "plain_": lambda: bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, n_out),
            "library_": lambda: torch.sparse.mm(a_lib, x),
        }
        row.update(timings(calls, device, reps, expect=SPMM_EXPECT))
        row.update(spmm_bound(t["rows"], t["cols"], t["blocks"], f, n_out))
        print(f"[kernel] bsr_spmm layer {l}: " + json.dumps(row))
        layers.append(row)
    return {"layers": layers, "max_abs_err": err, "sample_s": sample_s,
            "edge": edge}


def serving_phase(ds, eng, ref, sizes: Sizes, kernel: str = "bsr_spmm") -> dict:
    """The main path: two engines (cuda kernels, torch reference) on one
    request stream with one set of weights; ``kernel`` (one launch a layer
    and batch) the only kernel launched."""
    for a, b in zip(eng.trainer.params["layers"], ref.trainer.params["layers"]):
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("the two engines must share weights")
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warmup_s = time.perf_counter() - t0
    ref.warmup()

    zero_counts()
    done, wall = drive(eng, ds.graph.n_rows, sizes.n_requests)
    launched = counts()
    launches = launched[kernel]
    batches = eng.n_batches
    # one launch per layer and batch on the card; CPU tensors run the plain
    # version and launch nothing (a CPU rehearsal of this phase)
    on_card = eng.trainer.device.type == "cuda"
    expected = len(sizes.fanouts) * batches if on_card else 0
    if launches != expected or (on_card and batches == 0):
        raise AssertionError(f"{kernel} launched {launches} times for "
                             f"{batches} batches of {len(sizes.fanouts)} layers")
    if sum(launched.values()) != launches:
        raise AssertionError(f"serving launched other kernels: {launched}")
    if eng.trainer.n_infer_traces != n_warm:
        raise AssertionError("new shape signatures after warmup")
    ref_done, _ = drive(ref, ds.graph.n_rows, sizes.n_requests)
    if len(done) != sizes.n_requests or len(ref_done) != sizes.n_requests:
        raise AssertionError("not every request was answered")
    worst = 0.0
    n_classes = eng.n_classes
    for r, rr in zip(done, ref_done):
        if r.rid != rr.rid or not r.done or r.rejected:
            raise AssertionError(f"request {r.rid} not answered in order")
        if r.logits.shape != (r.node_ids.shape[0], n_classes):
            raise AssertionError(f"request {r.rid}: logits {r.logits.shape}")
        if not np.isfinite(r.logits).all():
            raise AssertionError(f"request {r.rid}: non-finite logits")
        worst = max(worst, float(np.abs(r.logits - rr.logits).max()))
    if not worst <= TOL:
        raise AssertionError(f"cuda vs torch logits differ by {worst} > {TOL}")

    cached = GNNServingEngine(eng.trainer, wave_size=sizes.wave_size,
                              use_cache=True, seed=0)
    ids = np.unique(np.concatenate([r.node_ids for r in done]))[:64]
    miss = cached.serve(ids)
    hit = cached.serve(ids)
    c = cached.cache
    if c.hits != ids.size or c.misses != ids.size or not np.array_equal(miss, hit):
        raise AssertionError(f"cache pass: hits={c.hits} misses={c.misses}")

    lat = np.asarray([r.latency_s for r in done]) * 1e3
    return {"requests": len(done), "batches": batches, "waves": eng.n_waves,
            "launches": launches, "launched": launched, "warmup_s": warmup_s,
            "wall_s": wall,
            "req_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "max_logit_diff": worst,
            "cache_hits": c.hits, "signatures": n_warm}


def breakdown(eng, device, n_ids: int, reps: int = 5,
              kernel: str = "bsr_spmm") -> dict:
    """Where one wave's batch spends its time, median of ``reps`` batches
    of ``n_ids`` seeds (host clock, synchronised): sampling and CSR→BSR on
    the host, the copy to the device, the forward pass (each layer's
    nonzero-column build inside it), the logits back.
    On the card, one more batch runs under the profiler (after a warmup
    batch): the device's busy time in it, and the idle share of the
    batch's median wall time; both None where no window recorded the
    batch's one ``kernel`` launch per layer."""
    tr = eng.trainer
    rng = np.random.default_rng(11)
    parts = {"sample_ms": [], "to_device_ms": [], "forward_ms": [],
             "to_host_ms": []}

    def one_batch(seeds):
        t0 = time.perf_counter()
        batch = eng.sampler.sample_batch(seeds, tr.features, rng=rng)
        t1 = time.perf_counter()
        data = tr._batch_arrays(batch)
        sync(device)
        t2 = time.perf_counter()
        out = tr._infer(tr.params, data)
        sync(device)
        t3 = time.perf_counter()
        out.cpu()
        return t0, t1, t2, t3, time.perf_counter()

    for _ in range(reps):
        t0, t1, t2, t3, t4 = one_batch(rng.choice(tr.n_nodes, n_ids, replace=False))
        for k, a, b in (("sample_ms", t0, t1), ("to_device_ms", t1, t2),
                        ("forward_ms", t2, t3), ("to_host_ms", t3, t4)):
            parts[k].append((b - a) * 1e3)
    out = {"seeds": n_ids, **{k: float(np.median(v)) for k, v in parts.items()}}
    if device.type == "cuda":
        n_layers = len(eng.config.layer_dims) - 1
        prof, _ = profiled(lambda: one_batch(rng.choice(tr.n_nodes, n_ids,
                                                        replace=False)),
                           device, {kernel: n_layers})
        busy = None if prof is None else busy_ms(prof)
        out["device_busy_ms"] = busy
        out["idle_share"] = (None if busy is None
                             else 1.0 - busy / sum(out[k] for k in parts))
    return out


def fused_bound(op, f, self_term: bool, bias: bool, relu: bool,
                masked: bool = False) -> dict:
    """``spmm_bound`` (both counts) plus the epilogue's streams: self read
    once, bias read once, the mask written once; for the masked product
    the mask rows beside the X rows it reads."""
    out = spmm_bound(op.block_rows, op.block_cols, op.blocks, f, op.n_rows_padded)
    extra = 4 * f * (op.n_rows_padded * (int(self_term) + int(relu)) + int(bias))
    out["bytes"] += extra + (4 * f * out["nnz_x_rows"] if masked else 0)
    out["layout_bytes"] += extra + (4 * f * out["x_rows"] if masked else 0)
    return _spmm_bounds(out)


def row_cost(op, f, device, reps: int, kernel: str) -> dict:
    """``kernel``'s time (the fused one with bias + ReLU) on a stream
    holding only the block-row with the most nonzero columns (the hub:
    split into segments of SPLIT_COLUMNS, one CTA each, and the ordered
    second pass) against one holding only a row of about the mean count;
    F=f. Timed as the kernel's whole call is, so that the hub's share of
    the call divides like by like: ``bsr_spmm`` by profiler device time
    (``SPMM_EXPECT``), the fused and masked kernels by CUDA events
    (``timings``). Both streams keep every other block-row, empty, so both
    calls also write those rows."""
    per_row = op.nonzero_columns().columns_per_row()
    hub = int(torch.argmax(per_row))
    mean = float(per_row.float().mean())
    typical = int(torch.argmin((per_row.float() - mean).abs()))
    blocks_per_row = torch.bincount(op.block_rows.long(),
                                    minlength=op.n_rows_padded // op.br)
    gen = torch.Generator().manual_seed(5)
    n_in = op.n_cols_padded
    x = torch.randn((n_in, f), generator=gen).to(device)
    m = (torch.randn((n_in, f), generator=gen) > 0).float().to(device)
    b = torch.zeros(f, device=device)
    out = {"kernel": kernel, "F": f, "hub_columns": int(per_row[hub]), "mean_columns": mean,
           "typical_columns": int(per_row[typical]),
           "hub_blocks": int(blocks_per_row[hub]),
           "typical_blocks": int(blocks_per_row[typical])}
    for label, row in (("hub", hub), ("typical", typical)):
        sel = op.block_rows.long() == row
        r_, c_, bl = (op.block_rows[sel].contiguous(), op.block_cols[sel].contiguous(),
                      op.blocks[sel].contiguous())
        nz = nonzero_columns(r_, c_, bl, op.n_rows_padded)
        call = {"bsr_spmm_masked": lambda: bsr_spmm_masked(
                    r_, c_, bl, x, m, op.n_rows_padded, nzc=nz),
                "bsr_spmm_fused_epilogue": lambda: bsr_spmm_fused_epilogue(
                    r_, c_, bl, x, op.n_rows_padded, bias=b, activation="relu", nzc=nz),
                "bsr_spmm": lambda: bsr_spmm(r_, c_, bl, x, op.n_rows_padded,
                                             nzc=nz)}[kernel]
        expect = {"": {kernel: 1}} if kernel == "bsr_spmm" else None
        out.update({f"{label}_{k}": v for k, v in timings(
            {"": call}, device, reps, expect=expect).items()})
    return out


def fused_kernel_phase(prog, csr_a, device, reps: int) -> dict:
    """Phase 5 on the main path's operands: A (forward) and Aᵀ (backward)."""
    fwd, bwd = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    a_lib, at_lib = csr_tensor(csr_a, device), csr_tensor(csr_a.transpose(), device)
    gen = torch.Generator().manual_seed(11)
    dims = prog.model.config.layer_dims
    widths = sorted(set(dims[1:]), reverse=True)  # 256, 40 at full width
    alpha = torch.full((1,), 1.25, device=device)
    err = {"fused": 0.0, "masked": 0.0, "spmm": 0.0}
    rows = {}
    for f in widths:
        x = torch.randn((fwd.n_cols_padded, f), generator=gen).to(device)
        s = torch.randn((fwd.n_rows_padded, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        for spec_name, spec in SPECS.items():
            err["fused"] = max(err["fused"], check_fused(
                f"A F={f} {spec_name}", fwd, x, s, b, alpha, spec, device))
        # library yardstick: cuSPARSE CSR product + the epilogue's torch ops
        lib_y = torch.relu(torch.sparse.mm(a_lib, x[: fwd.n_cols]) + b)
        plain_y, _ = bsr_spmm_fused_ref(fwd.block_rows, fwd.block_cols, fwd.blocks,
                                        x, fwd.n_rows_padded, bias=b, activation="relu")
        check_close("library yardstick (fused)", lib_y, plain_y[: fwd.n_rows])
        nzc = fwd.nonzero_columns()
        for spec_name, act in (("bias+relu", "relu"), ("bias", "none")):
            args = (fwd.block_rows, fwd.block_cols, fwd.blocks, x, fwd.n_rows_padded)

            def library(act=act):
                z = torch.sparse.mm(a_lib, x[: fwd.n_cols]) + b
                return (torch.relu(z), z > 0) if act == "relu" else z

            row = {"kernel": "bsr_spmm_fused_epilogue", "operand": "A", "F": f,
                   "spec": spec_name, "n_blocks": int(fwd.blocks.shape[0]),
                   "nnz": csr_a.nnz}
            row.update(timings({
                "": lambda: bsr_spmm_fused_epilogue(*args, bias=b, activation=act,
                                                    nzc=nzc),
                "plain_": lambda: bsr_spmm_fused_ref(*args, bias=b, activation=act),
                "library_": library}, device, reps))
            row.update(fused_bound(fwd, f, False, True, act == "relu"))
            rows[("fused", f, act)] = row
            print("[kernel] " + json.dumps(row))
    # the backward on Aᵀ: masked at the widest hidden width with a real
    # ReLU mask; bsr_spmm at the last layer's width
    f = dims[1]
    u = torch.randn((fwd.n_cols_padded, f), generator=gen).to(device)
    _, mask = bsr_spmm_fused_epilogue(fwd.block_rows, fwd.block_cols, fwd.blocks,
                                      u, fwd.n_rows_padded, activation="relu",
                                      nzc=fwd.nonzero_columns())
    t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
    dy = kops._fit_rows(torch.randn((fwd.n_rows_padded, f), generator=gen).to(device), t_in)
    mask = kops._fit_rows(mask, t_in).contiguous()
    err["masked"] = max(err["masked"], check_masked(f"Aᵀ F={f} (real ReLU mask)",
                                                    bwd, dy, mask, device))
    margs = (bwd.block_rows, bwd.block_cols, bwd.blocks, dy, mask, bwd.n_rows_padded)
    lib_in = (mask * dy)[: bwd.n_cols]
    check_close("library yardstick (masked)", torch.sparse.mm(at_lib, lib_in),
                bsr_spmm_masked_ref(*margs)[: bwd.n_rows])
    row = {"kernel": "bsr_spmm_masked", "operand": "A^T", "F": f,
           "mask_share": float(mask.mean()), "n_blocks": int(bwd.blocks.shape[0])}
    bwd_nzc = bwd.nonzero_columns()
    row.update(timings({"": lambda: bsr_spmm_masked(*margs, nzc=bwd_nzc),
                        "plain_": lambda: bsr_spmm_masked_ref(*margs),
                        "library_": lambda: torch.sparse.mm(at_lib, (mask * dy)[: bwd.n_cols])},
                       device, reps))
    row.update(fused_bound(bwd, f, False, False, False, masked=True))
    rows[("masked", f)] = row
    print("[kernel] " + json.dumps(row))
    f = dims[-1]
    dy = torch.randn((t_in, f), generator=gen).to(device)
    rows[("spmm", f)], err["spmm"] = spmm_operand_row("A^T", bwd, at_lib, dy, device, reps)
    err["nonfinite"] = check_nonfinite(f"Aᵀ F={f}", bwd, dy, device)
    for key, op, kernel in (("hub", fwd, "bsr_spmm_fused_epilogue"),
                            ("hub_masked", bwd, "bsr_spmm_masked")):
        rows[key] = row_cost(op, dims[1], device, reps, kernel)
        call = (rows[("masked", dims[1])] if kernel == "bsr_spmm_masked"
                else rows[("fused", dims[1], "relu")])
        rows[key]["full_call_ms"] = call["ms"]
        rows[key]["full_call_ms_by"] = call["ms_by"]
        rows[key]["hub_share_of_call"] = rows[key]["hub_ms"] / call["ms"]
        print(f"[kernel] {key} row: " + json.dumps(rows[key]))
    return {"rows": rows, "err": err}


def spmm_operand_row(label, op, lib, x, device, reps: int):
    """``bsr_spmm`` on one full-batch operand at the path's width, through
    the nonzero columns its binding built: checked against its plain
    version (a repeat bitwise equal), then timed (device time, from the
    profiler: a call takes 0.03-0.5 ms, about what the wrapper's host
    side takes, so CUDA events over back-to-back calls would time the
    host; ``wall_ms`` beside) beside the plain version and
    ``torch.sparse.mm`` on the operand's CSR (``lib``), with both bounds
    (``spmm_bound``) and the columns' count and bytes."""
    f = x.shape[1]
    args = (op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded)
    nzc = op.nonzero_columns()
    err = check_spmm(f"{label} [{op.n_rows_padded}x{op.n_cols_padded}] F={f}",
                     *args, device, nzc)
    check_close(f"library yardstick ({label})", torch.sparse.mm(lib, x[: op.n_cols]),
                bsr_spmm_ref(*args)[: op.n_rows])
    row = {"kernel": "bsr_spmm", "operand": label, "F": f,
           "n_blocks": int(op.blocks.shape[0]), "columns": int(nzc.x_rows.numel()),
           "nzc_bytes": nzc.nbytes, "split_rows": int(nzc.splits.shape[0])}
    row.update(timings({"": lambda: bsr_spmm(*args, nzc=nzc),
                        "plain_": lambda: bsr_spmm_ref(*args),
                        "library_": lambda: torch.sparse.mm(lib, x[: op.n_cols])},
                       device, reps, expect=SPMM_EXPECT))
    row.update(spmm_bound(*args[:3], f, op.n_rows_padded))
    print("[kernel] " + json.dumps(row))
    return row, err


#: ``adam_checks``' mixed list: empty, 1, 3, 4, 5, 1,000, 2,053 and
#: 1,000,003 values and a 0-d leaf (a view at a 4-byte offset is added)
ADAM_MIXED = [(0,), (1,), (3,), (4,), (5,), (1000,), (2053,), (1_000_003,), ()]


def adam_inputs(params, gen, device) -> list:
    """(p, g, m, v) for each parameter: random gradients, and moments as
    after a few steps."""
    out = []
    for p in params:
        g = torch.randn(p.shape, generator=gen).to(device)
        m = 0.1 * torch.randn(p.shape, generator=gen).to(device)
        v = 0.01 * torch.rand(p.shape, generator=gen).to(device)
        out.append((p.detach().contiguous(), g, m, v))
    return out


def check_adam(label, leaves, lr_t, device, launches: int) -> float:
    """``fused_adam_multi`` over ``leaves`` at weight decay 0 and 0.01
    against the plain version leaf by leaf at ADAM_TOL, each call in
    exactly ``launches`` launches on the card; every output contiguous and
    of its leaf's shape, the inputs kept."""
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    kept = [t.clone() for t in (*ps, *gs, *ms, *vs)]
    err = 0.0
    for wd in (0.0, 0.01):
        before = fused_adam.launches
        out = fused_adam_multi(ps, gs, ms, vs, lr_t, weight_decay=wd)
        sync(device)
        got = fused_adam.launches - before
        if got != (launches if device.type == "cuda" else 0):
            raise AssertionError(f"fused_adam {label}: {got} launches, expected "
                                 f"{launches}")
        for i, leaf in enumerate(leaves):
            ref = fused_adam_ref(*leaf, lr_t, 0.9, 0.999, 1e-8, wd)
            for a, r in zip((o[i] for o in out), ref):
                if a.shape != r.shape or not a.is_contiguous():
                    raise AssertionError(f"fused_adam {label} leaf {i}: output "
                                         f"{tuple(a.stride())} of {tuple(a.shape)}")
                err = max(err, check_close(f"fused_adam {label} leaf {i} "
                                           f"{tuple(r.shape)}", a, r, ADAM_TOL))
    if not all(torch.equal(a, b) for a, b in zip(kept, (*ps, *gs, *ms, *vs))):
        raise AssertionError(f"fused_adam {label}: an input was modified")
    return err


def adam_row(label, leaves, lr_t, device, reps: int) -> dict:
    """One step over a path's leaves: the kernel's device time (one launch,
    profiler), its plain version leaf by leaf, ``torch.optim.Adam(
    fused=True)``'s step on the same leaves (the library yardstick) and
    the bound, 28 bytes a parameter over the card's memory rate."""
    lib_params = [p.clone().requires_grad_(True) for p, *_ in leaves]
    for lp, (_, g, _, _) in zip(lib_params, leaves):
        lp.grad = g.clone()
    lib = torch.optim.Adam(lib_params, lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                           fused=device.type == "cuda")
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    row = {"kernel": "fused_adam", "leaves_of": label,
           "leaves": [tuple(p.shape) for p in ps],
           "params": int(sum(p.numel() for p in ps))}
    row.update(timings({
        "": lambda: fused_adam_multi(ps, gs, ms, vs, lr_t),
        "plain_": lambda: [fused_adam_ref(*leaf, lr_t, 0.9, 0.999, 1e-8, 0.0)
                           for leaf in leaves],
        "library_": lib.step}, device, reps,
        expect={"": {"fused_adam": 1}, "plain_": {}, "library_": {}}))
    nbytes = 28 * row["params"]
    row.update({"bytes": nbytes, "nnz_bytes": nbytes, "flop": 15.0 * row["params"]})
    row["bound_ms"], row["bound_by"] = _bound(nbytes, row["flop"])
    row["nnz_bound_ms"] = row["bound_ms"]
    print("[adam] " + json.dumps(row))
    return row


def adam_checks(leaf_sets: dict, device, reps: int) -> dict:
    """Phase 12: ``fused_adam_multi`` against its plain version at 1e-6 on
    each training path's leaves (``leaf_sets``: GCN's 6 and GAT's 15, random
    gradients and moments), on the mixed list (``ADAM_MIXED`` and a view at
    a 4-byte offset) in one launch, and on a list of 2 * CAPACITY + 5
    leaves in ceil(leaves / CAPACITY) launches; then ``adam_row`` on each
    path's leaves."""
    gen = torch.Generator().manual_seed(13)
    lr_t = bias_corrected_lr(0.01, 0.9, 0.999, 3)
    sets = {label: adam_inputs(params, gen, device)
            for label, params in leaf_sets.items()}
    err = 0.0
    for label, leaves in sets.items():
        err = max(err, check_adam(label, leaves, lr_t, device, 1))
    mixed = adam_inputs([torch.randn(shape, generator=gen).to(device)
                         for shape in ADAM_MIXED], gen, device)
    mixed.append(tuple(misaligned(t) for t in adam_inputs(
        [torch.randn(1001, generator=gen).to(device)], gen, device)[0]))
    err = max(err, check_adam("mixed", mixed, lr_t, device, 1))
    many = adam_inputs([torch.randn(1 + 37 * i, generator=gen).to(device)
                        for i in range(2 * CAPACITY + 5)], gen, device)
    err = max(err, check_adam(f"{len(many)} leaves", many, lr_t, device,
                              -(-len(many) // CAPACITY)))
    print(f"[adam] fused_adam: max_abs_err={err:.3g} over "
          f"{ {k: len(v) for k, v in sets.items()} } leaves, the mixed list "
          f"{[tuple(p.shape) for p, *_ in mixed]} and {len(many)} leaves")
    rows = {label: adam_row(label, leaves, lr_t, device, reps)
            for label, leaves in sets.items()}
    return {"rows": rows, "err": err}


def update_host_ms(prog, device, reps: int = 30) -> dict:
    """One ``opt.update`` over the program's tree, as ``train_epoch`` calls
    it (gradients of the program's loss at its parameters): the host clock
    from a synchronised card to the update's end, synchronised, over
    ``reps`` calls after 3 more; median, min and max."""
    grads = value_and_grad(prog.model.loss_fn, prog.params, prog.x,
                           prog.labels, prog.train_mask)[1]
    times = []
    with torch.no_grad():
        for _ in range(reps + 3):
            sync(device)
            t0 = time.perf_counter()
            prog.opt.update(grads, prog.opt_state, prog.params)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
    times = times[3:]
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times), "reps": reps,
            "leaves": len(tree_leaves(prog.params))}


#: what a kernel's second pass is counted under in a profiled window: the
#: split rows' pass (``nzc_split_reduce``, ``bsr_spmm_reduce``,
#: ``attn_<pass>_reduce``) combines their partials after the first pass,
#: inside the same wrapper call, so its time is the kernel's and its
#: launches are counted apart from the calls
SECOND_PASS = " second pass"


def launch_key(name: str) -> str:
    """What a profiler event's launches are counted under: its kernel, or
    the kernel's ``SECOND_PASS``."""
    kernel = classify(name)
    second = ("nzc_split_reduce<" in name or "bsr_spmm_reduce<" in name
              or re.search(r"attn_(?:fwd|bwd_row|bwd_col)_reduce", name))
    return kernel + SECOND_PASS if second else kernel


def classify(name: str) -> str:
    """A profiler event's kernel, by its (demangled) name: the three SpMM
    kernels' two passes over the nonzero-column loop (bsr_nzc.cuh) by
    their names, bsr_spmm.cu's own or the fused and masked kernels' (by
    their MASKED flag); each attention pass's two kernels
    (``attn_<pass>_kernel``, ``attn_<pass>_reduce``) as one kernel."""
    m = re.search(r"bsr_spmm_(?:kernel|reduce)<\s*\d+,\s*\d+,\s*(\w+)>", name)
    if m:  # bsr_spmm.cu's kernels: the accumulate mode by its ACCUM flag
        return "bsr_spmm_accumulate" if m.group(1) in ("true", "1") else "bsr_spmm"
    if "bsr_spmm_kernel<" in name or "bsr_spmm_reduce<" in name:
        return "bsr_spmm"
    m = re.search(r"nzc_(?:kernel|split_reduce)<\s*\d+,\s*\d+,\s*(\w+),", name)
    if m:
        return "bsr_spmm_masked" if m.group(1) == "true" else "bsr_spmm_fused_epilogue"
    if "fused_adam_multi_kernel" in name:
        return "fused_adam"
    m = re.search(r"attn_(fwd|bwd_row|bwd_col)_(?:kernel|reduce)", name)
    if m:
        return f"bsr_attention_{m.group(1)}"
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    low = name.lower()
    # nvjet: cuBLAS's Hopper kernels (the bfloat16 products of phase 16)
    if "gemm" in low or "cutlass" in low or "xmma" in low or "nvjet" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, reductions)"


def epoch_profile(fn, device, epoch_s: float, want: dict) -> dict:
    """One more call of ``fn`` (an epoch, or a step) under the profiler
    (CUDA activity, after a warmup call): device ms and launches by
    kernel, busy total, and the idle share of the median wall time
    ``epoch_s``. A kernel's device ms hold both of its passes; its
    launches count the row pass (one a call) and its ``SECOND_PASS``
    apart. ``complete`` is False where none of ``PROFILE_TRIES`` windows
    held exactly ``want``'s launches of the port's kernels and their
    second passes (or off the card)."""
    if device.type != "cuda":
        return {"complete": False}
    sync(device)
    prof, windows = profiled(fn, device, want)
    if prof is None:
        return {"complete": False, "windows": windows}
    by, launched = defaultdict(float), defaultdict(int)
    events = device_events(prof)
    for name, us, n in events:
        by[classify(name)] += us / 1e3
        launched[launch_key(name)] += n
    busy = sum(by.values())
    top = sorted(events, key=lambda e: -e[1])[:8]
    return {"complete": True, "windows": windows, "device_ms": dict(by),
            "launches": dict(launched),
            "busy_ms": busy, "idle_share": 1.0 - busy / (epoch_s * 1e3),
            "top": [{"kernel": k[:120], "ms": us / 1e3, "launches": n}
                    for k, us, n in top]}


def leaf_diffs(got: dict, want: dict) -> dict:
    """Per parameter leaf (or gradient leaf): the norm of got - want over
    the norm of want."""
    return {f"layer{i}.{k}": float((a[k] - b[k]).norm() / (b[k].norm() or 1.0))
            for i, (a, b) in enumerate(zip(got["layers"], want["layers"]))
            for k in sorted(b)}


@contextlib.contextmanager
def fused_executor(inner: str, hook):
    """Route the ``inner`` programs' fused-epilogue calls through
    ``hook(fn, *args, **kw)``, ``fn`` the executor they would have called."""
    table = kops._EXECUTORS[inner]
    fn = table["fused"]
    table["fused"] = functools.partial(hook, fn)
    try:
        yield
    finally:
        table["fused"] = fn


def spmm_second_passes(prog) -> int:
    """``bsr_spmm``'s second passes in one training step: its calls on an
    operand with split rows (the feature operands X, Xᵀ; rarely Aᵀ),
    recorded over one step's forward and backward through the ``cuda``
    executor."""
    table = kops._EXECUTORS["cuda"]
    fn = table["spmm"]
    split = []

    def record(*args, nzc=None, **kw):
        split.append(nzc is not None and nzc.splits.shape[0] > 0)
        return fn(*args, nzc=nzc, **kw)

    table["spmm"] = record
    try:
        value_and_grad(prog.model.loss_fn, prog.params, prog.x, prog.labels,
                       prog.train_mask)
    finally:
        table["spmm"] = fn
    return sum(split)


def relu_recorder(masks: list):
    """A ``fused_executor`` hook that keeps each ReLU call's mask, in call
    order."""
    def record(fn, *args, **kw):
        y, mask = fn(*args, **kw)
        if mask is not None:
            masks.append(mask)
        return y, mask
    return record


def relu_decider(wants: list, calls: list):
    """A ``fused_executor`` hook that gives the n-th ReLU call the
    decisions of ``wants[n]`` (rows re-tiled to the call's) where the two
    part within MASK_MARGIN of 0, and records per call the elements, the
    decisions parted, those beyond the margin and the largest |pre| among
    them in ``calls``."""
    def decide(fn, rows, cols, blocks, x, n, self_term=None, bias=None,
               alpha=None, activation="none", **kw):
        if activation != "relu":
            return fn(rows, cols, blocks, x, n, self_term, bias, alpha,
                      activation, **kw)
        pre, _ = fn(rows, cols, blocks, x, n, self_term, bias, alpha, "none", **kw)
        want = kops._fit_rows(wants[len(calls)], pre.shape[0])
        mask = (pre > 0).float()
        parted = mask != want
        beyond = parted & (pre.abs() > MASK_MARGIN)
        calls.append({"elements": mask.numel(), "parted": int(parted.sum()),
                      "beyond_margin": int(beyond.sum()),
                      "max_abs_pre": float(pre[parted].abs().max())
                      if parted.any() else 0.0})
        mask = torch.where(parted & ~beyond, want, mask)
        return torch.where(mask > 0, pre, torch.zeros_like(pre)), mask
    return decide


def decided_grads(prog, ref, params) -> tuple:
    """Both programs' gradients at ``params``, the torch program's ReLU
    decisions taken from the cuda program's where the two part within
    MASK_MARGIN of 0: there the sign is rounding's, and one flip moves a
    nearly cancelling gradient past GRAD_RTOL. Returns (cuda grads, torch
    grads, per ReLU call: elements, decisions parted, those beyond the
    margin, the largest |pre| among them)."""
    masks, calls = [], []
    with fused_executor("cuda", relu_recorder(masks)):
        got = value_and_grad(prog.model.loss_fn, params, prog.x, prog.labels,
                             prog.train_mask)[1]
    with fused_executor("torch", relu_decider(masks, calls)):
        want = value_and_grad(ref.model.loss_fn, params, ref.x, ref.labels,
                              ref.train_mask)[1]
    if len(calls) != len(masks):
        raise AssertionError(f"{len(masks)} ReLU calls in the cuda program, "
                             f"{len(calls)} in the torch program")
    return got, want, calls


def gradient_gate(name: str, when: str, decided: tuple) -> dict:
    """Both programs' gradients at the same parameters, leaf by leaf
    (``decided``: cuda grads, torch grads, ReLU calls, as
    ``decided_grads`` returns them): Adam normalises a gradient's scale
    away, so the losses alone would pass a backward that is off by a
    constant factor. Every ReLU decision the two programs part on must
    lie within MASK_MARGIN of 0."""
    cuda_grads, torch_grads, calls = decided
    out = {"grads": leaf_diffs(cuda_grads, torch_grads), "relu_decisions": calls}
    print(f"[{name}] gradients {when}: {json.dumps(out)}")
    if any(c["beyond_margin"] for c in calls):
        raise AssertionError(f"[{name}] ReLU masks {when} differ beyond "
                             f"|pre| > {MASK_MARGIN}: {calls}")
    if not max(out["grads"].values()) <= GRAD_RTOL:
        raise AssertionError(f"[{name}] gradients {when} differ: {out}")
    return out


def loss_and_param_gate(name: str, when: str, losses, ref_losses, params,
                        ref_params, falling: bool = True) -> tuple:
    """Finite losses within 1e-3 relative of the torch program's at every
    epoch, falling where ``falling``, and the parameters ``when`` within
    PARAM_RTOL a leaf. Returns the relative loss gaps and the parameters'."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if not (np.isfinite(losses).all() and max(rel) <= 1e-3):
        raise AssertionError(f"[{name}] losses {losses} vs reference {ref_losses}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"[{name}] loss did not fall: {losses}")
    param_diff = leaf_diffs(params, ref_params)
    print(f"[{name}] parameters {when}: {json.dumps(param_diff)}")
    if not max(param_diff.values()) <= PARAM_RTOL:
        raise AssertionError(f"[{name}] parameters {when} differ: {param_diff}")
    return rel, param_diff


def nzc_build(prog, device) -> dict:
    """The SpMM kernels' operand (the nonzero columns of A and Aᵀ), which
    ``compile`` built once on the device: ``column_build`` of each
    (building it again), beside its blocks and their bytes."""
    return {label: {**column_build(op.block_rows, op.block_cols, op.blocks,
                                   op.n_rows_padded, device, reps=3)[0],
                    "blocks": int(op.blocks.shape[0]),
                    "block_bytes": op.blocks.numel() * 4}
            for label, op in (("A", prog.plan.graph_op.fwd_operand),
                              ("A^T", prog.plan.graph_op.bwd_operand))}


def train_path(name, gnn, device, epochs: int, expected: dict,
               layout=None, weights=None) -> dict:
    """One training path: the ``cuda`` program (fused Adam) and the
    ``torch`` program (plain versions, plain Adam) from the same weights
    (``weights`` where given, else the program's seed) at the cuda
    program's layout (``layout`` as ``compile`` takes it), ``epochs``
    epochs each; counts zeroed just before the cuda run and read after
    every epoch, each epoch's launches exactly ``expected`` (kernel name
    -> launches; every other kernel 0). ``logits0``: the cuda program's
    logits at the first step, in user node order, on the host."""
    t0 = time.perf_counter()
    prog = gnn.compile(engine="cuda", device=device, fused_optimizer=True,
                       layout=layout, params=weights)
    sync(device)
    build_s = time.perf_counter() - t0
    weights = {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                          for layer in prog.params["layers"]]}
    with torch.no_grad():
        logits0 = prog.model.apply(prog.params, prog.x).cpu()
    t0 = time.perf_counter()
    ref = gnn.compile(engine="torch", device=device, fused_optimizer=False,
                      params=weights,
                      layout=None if layout is None else prog.plan.layout)
    sync(device)
    ref_build_s = time.perf_counter() - t0
    print(f"[{name}] plan (operands built in {build_s:.1f}s + {ref_build_s:.1f}s "
          f"on the host and copied):\n{prog.describe_plan()}")
    verified = verify_timed(name, prog.plan, device,
                            exec_graph(gnn.graph, prog.plan))
    nzc = nzc_build(prog, device)
    print(f"[{name}] nonzero columns of A and Aᵀ: {json.dumps(nzc)}")
    on_card = device.type == "cuda"
    # per epoch on the card; CPU tensors run the plain versions and launch
    # nothing
    want = {k: expected.get(k, 0) if on_card else 0 for k in KERNELS}

    def grad_check(when: str, params) -> dict:
        return gradient_gate(name, when, decided_grads(prog, ref, params))

    grad_start = grad_check("at the first step", prog.params)
    spmm_second = spmm_second_passes(prog) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    zero_counts()
    for epoch in range(epochs):
        before = counts()
        t0 = time.perf_counter()
        losses.append(prog.train_epoch()["loss"])  # float(): synchronised
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in counts().items()}
        if got != want:
            raise AssertionError(f"[{name}] epoch {epoch + 1} launched {got}, "
                                 f"expected {want}")
    launched = counts()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    update_host = update_host_ms(prog, device)
    print(f"[{name}] opt.update host time: {json.dumps(update_host)}")
    # the trained parameters: bias terms no longer zero
    grad_end = grad_check(f"after {epochs} epochs", prog.params)
    ref_losses, ref_times = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        ref_losses.append(ref.train_epoch()["loss"])
        ref_times.append(time.perf_counter() - t0)
    rel, param_diff = loss_and_param_gate(
        name, f"after {epochs} epochs", losses, ref_losses, prog.params,
        ref.params)
    epoch_s = float(np.median(times))
    out = {"losses": losses, "ref_losses": ref_losses, "max_rel_diff": max(rel),
           "epoch_ms_median": epoch_s * 1e3, "ref_epoch_ms_median":
           float(np.median(ref_times)) * 1e3, "epoch_ms": [t * 1e3 for t in times],
           "launches": launched, "per_epoch": want, "build_s": build_s,
           "update_host_ms": update_host,
           "ref_build_s": ref_build_s, "operand_bytes": prog.plan.graph_op.fwd_bytes,
           "nonzero_columns": nzc,
           "peak_mem_bytes": peak, "accuracy": prog.accuracy(),
           "layout": prog.plan.layout.describe(),
           "grad_start": grad_start, "grad_end": grad_end,
           "param_rel_diff": param_diff, "verify": verified}
    # each fused call and attention forward and row pass runs on A, each
    # masked call and attention column pass on Aᵀ, bsr_spmm on the
    # operands recorded in one step: a call on an operand with split rows
    # launches its second pass once
    fwd_op, bwd_op = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    split = {"bsr_spmm_fused_epilogue": fwd_op, "bsr_spmm_masked": bwd_op,
             "bsr_attention_fwd": fwd_op, "bsr_attention_bwd_row": fwd_op,
             "bsr_attention_bwd_col": bwd_op}
    second = {k + SECOND_PASS: want[k] if op.nzc is not None and op.nzc.splits.shape[0] else 0
              for k, op in split.items()}
    second["bsr_spmm" + SECOND_PASS] = spmm_second
    out["profile"] = epoch_profile(prog.train_epoch, device, epoch_s,
                                   {**want, **second})
    print(f"[{name}] " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("epoch_ms",)}))
    return {"summary": out, "prog": prog, "ref": ref, "weights": weights,
            "logits0": logits0}


def pair_unequal_paddings(prog, device) -> float:
    """The fused pair's forward and backward on the quickstart's A and Aᵀ,
    whose paddings differ. The forward against the ``torch`` pair; the
    backward against Aᵀ·(mask ⊙ dY) and Σ mask ⊙ dY composed from plain
    ops with the kernel's own mask (y > 0), so a sign that rounds the other
    way within 1e-7 of 0 cannot fail the check."""
    fwd, bwd = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    print(f"[quickstart] A padded {fwd.n_rows_padded} x {fwd.n_cols_padded}, "
          f"Aᵀ padded {bwd.n_rows_padded} x {bwd.n_cols_padded}")
    err = 0.0
    gen = torch.Generator().manual_seed(17)
    t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
    for f, act in ((32, "relu"), (70, "none")):
        u = torch.randn((fwd.n_cols, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        dy = torch.randn((fwd.n_rows, f), generator=gen).to(device)
        ut, bt = u.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = kops.build_fused_epilogue(fwd, bwd, "cuda")(ut, bias=bt, activation=act)
        y.backward(dy)
        with torch.no_grad():
            y_ref = kops.build_fused_epilogue(fwd, bwd, "torch")(u, bias=b,
                                                                activation=act)
        dz = dy * (y > 0).float() if act == "relu" else dy
        du = bsr_spmm_ref(bwd.block_rows, bwd.block_cols, bwd.blocks,
                          kops._fit_rows(dz.detach(), t_in), bwd.n_rows_padded)
        du = kops._fit_rows(du, fwd.n_cols_padded)[: fwd.n_cols]
        for label, a, r in (("y", y.detach(), y_ref), ("du", ut.grad, du),
                            ("dbias", bt.grad, dz.detach().sum(0))):
            err = max(err, check_close(f"fused pair {act} F={f} {label}", a, r))
    print(f"[quickstart] fused pair, unequal paddings: max_abs_err={err:.3g}")
    return err


def feature_operand_checks(qds, prog, device, reps: int) -> dict:
    """``bsr_spmm`` on the quickstart's three operands, at the widths the
    path gives them: X·W on BSR(X) and Xᵀ·dU on BSR(Xᵀ) (the Alg-1 sparse
    layer 0, built as the lowering builds them, F = hidden) and Aᵀ·dY on
    corafull's Aᵀ (the plan's own, F = n_classes), each through
    ``spmm_operand_row``; the non-finite case on BSR(X); and the hub
    segment's cost on BSR(Xᵀ), whose every row is split. The dense
    operand is scaled so that each output has unit variance: at N(0, 1)
    the outputs of these ~440- and ~990-term rows reach ~150, and fp32's
    rounding with them."""
    br, f = prog.plan.layers[0].layout.br, prog.plan.layers[0].d_out
    x_csr = csr_from_dense(qds.features)
    gen = torch.Generator().manual_seed(19)
    rows, err = {}, 0.0
    for label, csr in (("X", x_csr), ("X^T", x_csr.transpose())):
        op = get_backend("cuda").build_spmm_operand(csr, br=br, device=device)
        w = torch.randn((op.n_cols_padded, f), generator=gen).to(device)
        w *= (csr.n_rows / csr.nnz) ** 0.5
        rows[label], e = spmm_operand_row(label, op, csr_tensor(csr, device), w,
                                          device, reps)
        err = max(err, e)
        if label == "X":
            err = max(err, check_nonfinite("BSR(X)", op, w, device))
        else:
            rows["hub X^T"] = row_cost(op, f, device, reps, "bsr_spmm")
            rows["hub X^T"]["full_call_ms"] = rows[label]["ms"]
            rows["hub X^T"]["full_call_ms_by"] = rows[label]["ms_by"]
            rows["hub X^T"]["hub_share_of_call"] = (rows["hub X^T"]["hub_ms"]
                                                    / rows[label]["ms"])
            print("[kernel] hub row of BSR(Xᵀ): " + json.dumps(rows["hub X^T"]))
        del op
    bwd = prog.plan.graph_op.bwd_operand
    c = prog.model.config.layer_dims[-1]
    dy = torch.randn((bwd.n_cols_padded, c), generator=gen).to(device)
    rows["A^T"], e = spmm_operand_row(
        "A^T", bwd, csr_tensor(qds.graph.sym_normalized().transpose(), device), dy,
        device, reps)
    return {"rows": rows, "err": max(err, e)}


def capture_attention(prog) -> list:
    """One training step of ``prog`` at its current parameters, recording
    each attention layer's real inputs: z [N, H*Dh], a_src, a_dst, the
    head count and the loss's cotangent of the layer's output, dy [N, H,
    Dh]. Measurement only: the plan's operator is wrapped for this step."""
    op = prog.plan.graph_op
    inner = op.aggregate_attention
    layers = []

    def spy(z, a_src, a_dst, heads):
        out = inner(z, a_src, a_dst, heads)
        rec = {"z": z.detach(), "a_src": a_src.detach(),
               "a_dst": a_dst.detach(), "heads": heads}
        layers.append(rec)
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return out

    op.aggregate_attention = spy
    try:
        value_and_grad(prog.model.loss_fn, prog.params, prog.x, prog.labels,
                       prog.train_mask)
    finally:
        op.aggregate_attention = inner
    return layers


def attention_operands(fwd, bwd, rec) -> dict:
    """The three passes' arguments for one captured layer, built as
    ``kernels/ops.py:_SparseMHAPair`` builds them: the statistics (m, l)
    and the output from the plain forward, r = Σ_d dy·out; destinations
    are the leading ``fwd.n_rows`` sources (all of them in full batch).
    The loss's cotangent is a mean over the training nodes (~1e-5 at the
    last layer, less below), so dy is rescaled to unit variance, as
    ``feature_operand_checks`` scales its dense operand: otherwise dc,
    dzv and dd would lie below the check's absolute tolerance. Without a
    cotangent (inference) only the forward's arguments."""
    fit = kops._fit_rows
    h = rec["heads"]
    n, hd = rec["z"].shape
    z3 = rec["z"].reshape(n, h, hd // h)
    asrc = torch.einsum("nhd,hd->nh", z3, rec["a_src"])
    adst = torch.einsum("nhd,hd->nh", z3, rec["a_dst"])
    nr, nc = fwd.n_rows_padded, fwd.n_cols_padded
    a = (fwd.block_rows, fwd.block_cols, fwd.blocks)
    fargs = (*a, fit(adst, nr).contiguous(), fit(asrc, nc).contiguous(),
             fit(rec["z"], nc).contiguous(), nr, h)
    if "dy" not in rec:
        return {"fwd": fargs}
    n_dst = fwd.n_rows
    ntr, ntc = bwd.n_rows_padded, bwd.n_cols_padded
    at = (bwd.block_rows, bwd.block_cols, bwd.blocks)
    dy3 = rec["dy"] / rec["dy"].std()
    out, m, l = bsr_attention_fwd_ref(*fargs)
    dy = dy3.reshape(n_dst, hd)
    r = torch.einsum("nhd,nhd->nh", dy3, out[:n_dst].reshape(n_dst, h, hd // h))
    m, l = m[:n_dst], l[:n_dst]
    rargs = (*a, fargs[3], fargs[4], fargs[5], fit(dy, nr).contiguous(),
             fit(r, nr).contiguous(), fit(m, nr).contiguous(),
             fit(l, nr).contiguous(), nr, h)
    cargs = (*at, fit(asrc, ntr).contiguous(), fit(adst, ntc).contiguous(),
             fit(rec["z"], ntr).contiguous(), fit(dy, ntc).contiguous(),
             fit(r, ntc).contiguous(), fit(m, ntc).contiguous(),
             fit(l, ntc).contiguous(), ntr, h)
    return {"fwd": fargs, "row": rargs, "col": cargs}


def attention_bound(rows, cols, blocks, heads: int, hd: int,
                    n_rows_padded: int, kind: str) -> dict:
    """Least time for one attention pass on these inputs, counted two ways,
    as ``spmm_bound`` does. Row-side inputs are indexed by the stream's
    block rows, column-side ones by its block columns, per row in floats:
    forward z + asrc (columns), adst (rows), writes out + m + l; row pass
    z + asrc (columns), adst + dy + r + m + l (rows), writes dc; column
    pass over Aᵀ adst + dy + r + m + l (columns: destinations), asrc + z
    (rows: sources), writes dzv + dd. ``layout_bound_ms``, the layout's:
    each block that holds a nonzero, whole, and its two indices, the
    column-side rows of its block-column and the row-side rows of its
    block-row, once. ``nnz_bound_ms``, any layout's: each nonzero's column
    index and a row pointer per row, the rows the nonzeros reference on
    each side, once. Both write every output row once. ``bound_ms`` (and
    ``bytes``) is the one the kernels answer to, the nonzeros': every pass
    reads its operand's nonzero columns and no block. Operations:
    fp32 on the nonzeros x heads (score, exp and the 2·Dh-long product per
    pass; the column pass two products)."""
    col_w, row_w, out_w = {
        "fwd": (hd + heads, heads, hd + 2 * heads),
        "row": (hd + heads, hd + 4 * heads, heads),
        "col": (hd + 4 * heads, hd + heads, hd + heads)}[kind]
    nb, br, bc = blocks.shape
    nz = blocks.ne(0)
    used = nz.reshape(nb, -1).any(dim=1)
    n_used = int(used.sum())
    col_rows = int(torch.unique(cols[used]).numel()) * bc
    row_rows = int(torch.unique(rows[used]).numel()) * br
    out_bytes = 4 * n_rows_padded * out_w
    nbytes = (4 * (2 * n_used + n_used * br * bc + col_rows * col_w
                   + row_rows * row_w) + out_bytes)
    b_idx, i, j = torch.nonzero(nz, as_tuple=True)
    nnz = int(b_idx.numel())
    nnz_cols = int(torch.unique(cols[b_idx].long() * bc + j).numel())
    nnz_rows = int(torch.unique(rows[b_idx].long() * br + i).numel())
    nnz_bytes = (4 * (nnz + n_rows_padded + 1 + nnz_cols * col_w
                      + nnz_rows * row_w) + out_bytes)
    dh = hd // heads
    per = {"fwd": 2 * dh + 6, "row": 2 * dh + 10, "col": 4 * dh + 10}[kind]
    flop = float(nnz) * heads * per
    out = {"blocks_used": n_used, "nnz": nnz, "bytes": nnz_bytes,
           "layout_bytes": nbytes, "nnz_bytes": nnz_bytes, "flop": flop}
    out["bound_ms"], out["bound_by"] = _bound(out["bytes"], flop)
    out["nnz_bound_ms"], _ = _bound(nnz_bytes, flop)
    out["layout_bound_ms"], _ = _bound(nbytes, flop)
    return out


def attention_call(kind, args, nzc):
    """A thunk of the ``kind`` pass's kernel on ``args``, reading ``nzc``,
    the nonzero columns of its stream (A's, or Aᵀ's for the column pass)."""
    _, kernel, _ = ATTENTION[kind]
    return lambda: kernel(*args, nzc=nzc)


def stream_columns(args):
    """The nonzero columns of an attention pass's stream (``args`` as the
    pass takes them: the stream first, its padded rows second to last),
    built on its device."""
    return nonzero_columns(args[0], args[1], args[2], args[-2])


def output_error(got, want) -> tuple:
    """(max |got - want|, max excess of |got - want| over TOL·|want|,
    ||got - want|| / ||want||): an output within TOL of its plain version
    has the last two at most TOL."""
    if not got.numel():
        return 0.0, 0.0, 0.0
    diff = (got - want).abs()
    gap, scale = float(diff.norm()), float(want.norm())
    return (float(diff.max()), float((diff - TOL * want.abs()).max()),
            gap / scale if scale else (0.0 if gap == 0 else float("inf")))


def check_attention(label, kind, args, device, nzc) -> float:
    """One attention kernel against its plain version on the same device
    tensors, every output within the JAX suite's tolerance (|got - want| <=
    1e-4 + 1e-4·|want|: the softmax denominator l of a row with 17k
    nonzeros is ~1e4, summed in another order) and within 1e-4 of its
    norm (||got - want|| <= 1e-4·||want||, which holds small outputs to
    their own scale), and a repeat launch bitwise equal. The kernel reads
    ``nzc``, its stream's nonzero columns. Returns the largest absolute
    error."""
    name, _, plain = ATTENTION[kind]
    call = attention_call(kind, args, nzc)
    got = call()
    again = call()
    want = plain(*args)
    sync(device)
    got, again, want = ((t,) if isinstance(t, torch.Tensor) else t
                        for t in (got, again, want))
    errs = [output_error(a, w) for a, w in zip(got, want)]
    if not all(excess <= TOL and rel <= TOL for _, excess, rel in errs):
        raise AssertionError(f"{name} {label}: (max abs error, max excess over "
                             f"the relative part, error norm over the output's) "
                             f"per output {errs} > {TOL}")
    if device.type == "cuda" and not all(torch.equal(a, b)
                                         for a, b in zip(got, again)):
        raise AssertionError(f"{name} {label}: a repeat launch is not bitwise equal")
    print(f"[kernel] {name} {label}: max abs error per output "
          f"{[e for e, _, _ in errs]}, relative norm error {[r for _, _, r in errs]}")
    return max(e for e, _, _ in errs)


@contextlib.contextmanager
def split_columns(n: int):
    """Inside the ``with`` statement ``nonzero_columns`` splits rows longer
    than ``n`` columns (``SPLIT_COLUMNS``, restored after)."""
    saved = bsr_spmm_module.SPLIT_COLUMNS
    bsr_spmm_module.SPLIT_COLUMNS = n
    try:
        yield
    finally:
        bsr_spmm_module.SPLIT_COLUMNS = saved


def attention_edge_cases(device) -> float:
    """The three passes on small operands, each through its stream's
    nonzero columns: a padding tail, a block-row without blocks, H·Dh not
    a multiple of 32 (2 x 5, 4 x 17), rows split into segments of 3
    columns and whole; a row whose max lies in its second block; and,
    split at 3 columns, a row whose max lies in its last segment beside a
    row whose first segments hold none of its nonzeros."""
    err = 0.0
    gen = torch.Generator().manual_seed(23)
    for split in (3, bsr_spmm_module.SPLIT_COLUMNS):
        for heads, dh in ((2, 5), (4, 17)):
            r = np.random.default_rng(heads)
            g = csr_from_edges(r.integers(0, 150, 700), r.integers(0, 150, 700), 150)
            a, at = csr_to_bsr(g, br=8, bc=8), csr_to_bsr(g.transpose(), br=8, bc=8)
            arrays = _pad_bsr(a, a.n_blocks + 9)
            keep = arrays["rows"] != 3  # block-row 3 loses its blocks
            t = on_device({k: v[keep] for k, v in arrays.items()}, device)
            tt = on_device({"rows": at.block_rows, "cols": at.block_cols,
                            "blocks": at.blocks}, device)
            nr, nc, hd = a.padded_rows, a.padded_cols, heads * dh

            def rnd(*shape):
                return torch.randn(shape, generator=gen).to(device)

            z, dy = rnd(nc, hd), rnd(nr, hd)
            adst, asrc, rr = rnd(nr, heads), rnd(nc, heads), rnd(nr, heads)
            fargs = (t["rows"], t["cols"], t["blocks"], adst, asrc, z, nr, heads)
            label = f"edge cases H={heads} Dh={dh} split {split}"
            with split_columns(split):
                nzc = stream_columns(fargs)
                nzc_t = nonzero_columns(tt["rows"], tt["cols"], tt["blocks"],
                                        at.padded_rows)
            err = max(err, check_attention(label, "fwd", fargs, device, nzc))
            out, m, l = bsr_attention_fwd(*fargs, nzc=nzc)
            if not (torch.all(out[24:32] == 0) and torch.all(m[24:32] == 0)
                    and torch.all(l[24:32] == 0)):
                raise AssertionError("a block-row without blocks must give out, m, l = 0")
            rargs = (*fargs[:3], adst, asrc, z, dy, rr, m, l, nr, heads)
            err = max(err, check_attention(label, "row", rargs, device, nzc))
            src_side = [kops._fit_rows(x, at.padded_rows).contiguous()
                        for x in (asrc, z)]
            dst_side = [kops._fit_rows(x, at.padded_cols).contiguous()
                        for x in (adst, dy, rr, m, l + 1.0)]
            err = max(err, check_attention(label, "col", (
                tt["rows"], tt["cols"], tt["blocks"], src_side[0], dst_side[0],
                src_side[1], *dst_side[1:], at.padded_rows, heads), device, nzc_t))
    # row 0 attends sources {0, 1} in block-column 0 and {14, 15} in
    # block-column 1, whose scores are the larger: the running max rises
    blocks = torch.zeros((2, 8, 8))
    blocks[0, 0, :2] = 1.0
    blocks[1, 0, 6:] = 1.0
    asrc = torch.zeros((16, 1))
    asrc[:2, 0] = torch.tensor([-1.0, 0.5])
    asrc[14:, 0] = torch.tensor([4.0, 6.0])
    adst = torch.full((8, 1), 0.3)
    z = torch.randn((16, 3), generator=gen)
    fargs = tuple(x.to(device) for x in (torch.zeros(2, dtype=torch.int32),
                                          torch.tensor([0, 1], dtype=torch.int32),
                                          blocks, adst, asrc, z)) + (8, 1)
    nzc = stream_columns(fargs)
    err = max(err, check_attention("max in the second block", "fwd", fargs, device, nzc))
    _, m, _ = bsr_attention_fwd(*fargs, nzc=nzc)
    if abs(float(m[0, 0]) - 6.3) > 1e-5:
        raise AssertionError(f"row max {float(m[0, 0])}, expected 6.3")
    # one block-row over 24 sources, 9 columns holding a nonzero: split at
    # 3 columns, row 0's scores rise to its last segment's; row 1's
    # nonzeros lie in the last segment only, so its first two carry no
    # nonzero (m_s = NEG_INF, l_s = 0) and must add nothing
    blocks = torch.zeros((3, 8, 8))
    for b, ks in enumerate(([1, 4, 6], [0, 3, 7], [2, 5, 6])):
        blocks[b, 0, ks] = 1.0
    blocks[2, 1, [2, 5, 6]] = 1.0
    asrc = torch.linspace(-2.0, 5.0, 24)[:, None]
    fargs = tuple(x.to(device) for x in (torch.zeros(3, dtype=torch.int32),
                                          torch.arange(3, dtype=torch.int32), blocks,
                                          torch.full((8, 1), 0.3), asrc,
                                          torch.randn((24, 3), generator=gen))) + (8, 1)
    with split_columns(3):
        nzc = stream_columns(fargs)
    if nzc.splits.tolist() != [[0, 0, 3]]:
        raise AssertionError(f"the late-max row must split in 3: {nzc.splits.tolist()}")
    err = max(err, check_attention("max in the last segment", "fwd", fargs, device, nzc))
    _, m, _ = bsr_attention_fwd(*fargs, nzc=nzc)
    want = 0.3 + float(asrc[22, 0])
    if abs(float(m[0, 0]) - want) > 1e-5:
        raise AssertionError(f"row max {float(m[0, 0])}, expected {want}")
    return err


def attention_row_cost(kind, args, device, reps: int) -> dict:
    """One attention pass on a stream holding only its hub block-row (A's
    in-degree hub, or Aᵀ's out-degree hub), the row with
    the most nonzeros, blocks breaking a tie, as ``row_cost`` picks by
    nonzero columns; against one holding only a row of about the mean
    length in blocks, at these inputs' width. Also the row with the most
    blocks (the first of a tie), with its blocks and nonzeros: several
    rows may tie on blocks and hold very different nonzeros. Every pass
    walks each sub-stream's own nonzero columns, so a row longer than
    SPLIT_COLUMNS columns is cut into segments, one CTA each, combined by
    one second-pass launch a call: ``<row>_segments`` and
    ``<row>_second_pass_launches`` say so."""
    rows, cols, blocks, *rest = args
    per_row = torch.bincount(rows.long())
    nnz_row = torch.zeros_like(per_row).index_add_(
        0, rows.long(), blocks.ne(0).flatten(1).sum(1))
    # nonzeros first, blocks second, the first row of a full tie
    key = nnz_row * (int(per_row.max()) + 1) + per_row
    hub = int(torch.argmax(key))
    by_blocks = int(torch.argmax(per_row))
    mean = float(per_row[per_row > 0].float().mean())
    typical = int(torch.argmin((per_row.float() - mean).abs()))
    out = {"hub_row": hub, "hub_blocks": int(per_row[hub]), "mean_blocks": mean,
           "typical_blocks": int(per_row[typical]),
           "most_blocks_row": by_blocks, "most_blocks_blocks": int(per_row[by_blocks]),
           "most_blocks_nnz": int(nnz_row[by_blocks]),
           "rows_with_most_blocks": int((per_row == per_row.max()).sum())}
    for label, row in (("hub", hub), ("typical", typical)):
        sel = rows == row
        out[f"{label}_nnz"] = int(blocks[sel].ne(0).sum())
        sub = (rows[sel].contiguous(), cols[sel].contiguous(),
               blocks[sel].contiguous(), *rest)
        nzc = stream_columns(sub)
        out[f"{label}_segments"] = nzc.n_slots
        out[f"{label}_second_pass_launches"] = int(nzc.splits.shape[0] > 0)
        out.update({f"{label}_{k}": v for k, v in timings(
            {"": attention_call(kind, sub, nzc)}, device, reps).items()})
    return out


def segment_ms(rec, op, device, reps: int) -> dict:
    """The port's segment path (``segment_softmax_aggregate``: gather,
    ``scatter_reduce`` amax, ``index_add_``) on the same graph and inputs,
    the PyG-style composition of library calls the fused kernels replace:
    ``fwd`` the forward, ``bwd`` its autograd backward with the captured
    cotangent (the graph kept between calls)."""
    h = rec["heads"]
    n, hd = rec["z"].shape
    backend = get_backend("cuda")
    z = rec["z"].reshape(n, h, hd // h).clone().requires_grad_(True)
    a_src = rec["a_src"].clone().requires_grad_(True)
    a_dst = rec["a_dst"].clone().requires_grad_(True)

    def forward():
        return backend.segment_softmax_aggregate(z, a_src, a_dst, op.src,
                                                 op.dst, n)

    with torch.no_grad():
        fwd = time_ms(forward, device, reps, warmup=1)
    out = forward()
    bwd = time_ms(lambda: torch.autograd.grad(out, (z, a_src, a_dst), rec["dy"],
                                              retain_graph=True),
                  device, reps, warmup=1)
    return {"fwd": fwd, "bwd": bwd}


def attention_phase(prog, device, reps: int) -> dict:
    """Phase 8 on phase 7's operands: A (forward, row pass) and Aᵀ (column
    pass), each layer's real inputs, each pass through its operand's
    nonzero columns, which the program built when it bound the layer."""
    op = prog.plan.graph_op
    fwd, bwd = op.fwd_operand, op.bwd_operand
    if fwd.nzc is None or bwd.nzc is None:
        raise AssertionError("the cuda program must build A's and Aᵀ's nonzero "
                             "columns when it binds the attention pair")
    columns = {"fwd": fwd.nzc, "row": fwd.nzc, "col": bwd.nzc}
    captured = capture_attention(prog)
    sync(device)
    err = {k: 0.0 for k in ATTENTION}
    rows = {}
    hub = None
    for layer, rec in enumerate(captured):
        args = attention_operands(fwd, bwd, rec)
        h = rec["heads"]
        hd = rec["z"].shape[1]
        label = f"layer {layer} H={h} Dh={hd // h}"
        for kind, a in args.items():
            err[kind] = max(err[kind], check_attention(label, kind, a, device,
                                                       columns[kind]))
        seg = segment_ms(rec, op, device, reps)
        for kind, a in args.items():
            name, _, plain = ATTENTION[kind]
            stream = bwd if kind == "col" else fwd
            row = {"kernel": name, "operand": "A^T" if kind == "col" else "A",
                   "layer": layer, "heads": h, "Dh": hd // h,
                   "n_blocks": int(stream.blocks.shape[0])}
            row.update(timings({"": attention_call(kind, a, columns[kind]),
                                "plain_": lambda: plain(*a)}, device, reps))
            row.update(attention_bound(stream.block_rows, stream.block_cols,
                                       stream.blocks, h, hd, stream.n_rows_padded,
                                       kind))
            row["library_ms"] = None
            # the segment path's forward beside ours, its whole backward
            # beside each of our two backward passes
            row["segment_ms"] = seg["fwd" if kind == "fwd" else "bwd"]
            rows[(kind, layer)] = row
            print("[kernel] " + json.dumps(row))
        if layer == 0:
            hub = {kind: attention_row_cost(kind, a, device, reps)
                   for kind, a in args.items()}
            print("[kernel] attention hub rows: " + json.dumps(hub))
        del args
    err["edge"] = attention_edge_cases(device)
    return {"rows": rows, "err": err, "hub": hub, "layers": len(captured)}


def attention_pair_unequal(prog, device) -> float:
    """The attention pair's forward and backward on the quickstart's A and
    Aᵀ (19,800 rows against 19,840 columns), cuda against torch: out and
    dz within 1e-4, da_src / da_dst within 1e-4 of their norm (sums over
    every node)."""
    op = prog.plan.graph_op
    fwd, bwd = op.fwd_operand, op.bwd_operand
    print(f"[gt] A padded {fwd.n_rows_padded} x {fwd.n_cols_padded}, "
          f"Aᵀ padded {bwd.n_rows_padded} x {bwd.n_cols_padded}")
    gen = torch.Generator().manual_seed(29)
    err = 0.0
    for heads, dh in ((4, 8), (4, 17)):
        z = torch.randn((fwd.n_cols, heads, dh), generator=gen).to(device)
        a_src, a_dst = (torch.randn((heads, dh), generator=gen).to(device) / dh ** 0.5
                        for _ in range(2))
        dy = torch.randn((fwd.n_rows, heads, dh), generator=gen).to(device)
        got = {}
        for inner in ("cuda", "torch"):
            zt, st, dt = (t.clone().requires_grad_(True) for t in (z, a_src, a_dst))
            out = kops.build_sparse_mha(fwd, bwd, inner)(zt, st, dt)
            out.backward(dy)
            got[inner] = (out.detach(), zt.grad, st.grad, dt.grad)
        c, t = got["cuda"], got["torch"]
        for label, a, b in (("out", c[0], t[0]), ("dz", c[1], t[1])):
            err = max(err, check_close(f"attention pair H={heads} Dh={dh} {label}", a, b))
        for label, a, b in (("da_src", c[2], t[2]), ("da_dst", c[3], t[3])):
            rel = float((a - b).norm() / b.norm())
            if not rel <= TOL:
                raise AssertionError(f"attention pair {label}: relative {rel}")
    print(f"[gt] attention pair, unequal paddings: max_abs_err={err:.3g}")
    return err


# ---------------------------------------------------------------------------
# Phases 13-14: the sampled path, GAT serving and training
# ---------------------------------------------------------------------------

def train_cut(mask: np.ndarray, n: int) -> np.ndarray:
    """``mask`` cut to its first ``n`` nodes."""
    cut = np.zeros_like(mask)
    cut[np.flatnonzero(mask)[:n]] = True
    return cut


def capture_sampled_attention(tr, data, grad: bool) -> list:
    """Each attention layer's real operands and inputs in one pass of the
    trainer over the batch ``data``: A and Aᵀ as ``BSRDevice``s (Aᵀ None
    where the batch has none), z [N, H*Dh], a_src, a_dst, the head count
    and, with ``grad`` (one loss and gradient), the loss's cotangent of
    the layer's output, dy [n_out, H, Dh]. Measurement only:
    ``kops.sampled_mha_pair`` is wrapped for this pass."""
    inner = kops.sampled_mha_pair
    layers = []

    def spy(fwd, bwd, z3, a_src, a_dst, n_out, how):
        out = inner(fwd, bwd, z3, a_src, a_dst, n_out, how)
        n = z3.shape[0]
        rec = {"z": z3.detach().reshape(n, -1), "a_src": a_src.detach(),
               "a_dst": a_dst.detach(), "heads": z3.shape[1],
               "fwd": kops._arrays_operand(fwd, n_out, n),
               "bwd": None if bwd is None else kops._arrays_operand(bwd, n, n_out)}
        layers.append(rec)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return out

    kops.sampled_mha_pair = spy
    try:
        if grad:
            value_and_grad(tr._loss, tr.params, data)
        else:
            with torch.no_grad():
                tr._logits(tr.params, data)
    finally:
        kops.sampled_mha_pair = inner
    return layers


def sampled_attention_rows(label, captured, device, reps: int) -> tuple:
    """The attention passes on one batch's captured operands and inputs
    (``attention_operands``: the forward alone without a cotangent), each
    through its stream's nonzero columns: checked against the plain
    version (``check_attention``: 1e-4, a repeat bitwise equal), then its
    device time (profiler; a call is short) beside the plain version's,
    and the bounds. Returns the rows by (pass, layer) and the largest
    error by pass."""
    err = {k: 0.0 for k in ATTENTION}
    rows = {}
    for layer, rec in enumerate(captured):
        args = attention_operands(rec["fwd"], rec["bwd"], rec)
        h = rec["heads"]
        hd = rec["z"].shape[1]
        for kind, a in args.items():
            name, _, plain = ATTENTION[kind]
            stream = rec["bwd"] if kind == "col" else rec["fwd"]
            nzc = stream.nonzero_columns()
            err[kind] = max(err[kind], check_attention(
                f"{label} layer {layer} H={h} Dh={hd // h}", kind, a, device, nzc))
            row = {"kernel": name, "operand": "A^T" if kind == "col" else "A",
                   "layer": layer, "heads": h, "Dh": hd // h,
                   "n_rows_padded": stream.n_rows_padded,
                   "n_cols_padded": stream.n_cols_padded,
                   "n_blocks": int(stream.blocks.shape[0]),
                   "split_rows": int(nzc.splits.shape[0])}
            row.update(timings({"": attention_call(kind, a, nzc),
                                "plain_": lambda: plain(*a)}, device, reps,
                               expect={"": {name: 1}}))
            row.update(attention_bound(stream.block_rows, stream.block_cols,
                                       stream.blocks, h, hd, stream.n_rows_padded,
                                       kind))
            row["library_ms"] = None
            rows[(kind, layer)] = row
            print(f"[{label}] " + json.dumps(row))
    return rows, err


def batch_columns(data) -> dict:
    """``column_build`` of every layer's A and (where copied) Aᵀ in the
    batch ``data``: what the path builds on the card once per batch and
    layer, each operand where its product runs."""
    out = {}
    for l, blk in enumerate(data["blocks"]):
        for label, key, n_rows in (("A", "fwd", data["valid"][l + 1].shape[0]),
                                   ("A^T", "bwd", data["valid"][l].shape[0])):
            if key in blk:
                d = blk[key]
                out[f"layer {l} {label}"] = column_build(
                    d["rows"], d["cols"], d["blocks"], n_rows, d["rows"].device,
                    reps=3)[0]
    return out


def sampled_gat_serving(ds, sizes: Sizes, device) -> dict:
    """Phase 13: GAT [F, gat_hidden..., C] served on the sampled path
    through ``build_engine(arch="GAT")``, cuda against the torch engine
    with the same weights and request stream (``serving_phase``: one
    ``bsr_attention_fwd`` launch a layer and batch and nothing else); the
    batch's time by part, its nonzero-column builds, and the forward
    kernel on one largest-bucket batch's real operands."""
    kw = dict(arch="GAT", hidden=sizes.gat_hidden[0], fanouts=sizes.fanouts,
              batch_size=sizes.batch_size, n_buckets=sizes.n_buckets,
              wave_size=sizes.wave_size, use_cache=False, device=device,
              gat_heads=sizes.gat_heads)
    eng = build_engine(ds, engine="cuda", **kw)
    ref = build_engine(ds, engine="torch", **kw)
    print(f"[gat-serving] plan:\n{eng.trainer.plan.describe()}")
    if any(l.agg_primitive != "cuda.spmm_attention" for l in eng.trainer.plan.layers):
        raise AssertionError("every sampled GAT layer must bind cuda.spmm_attention")
    serve = serving_phase(ds, eng, ref, sizes, kernel="bsr_attention_fwd")
    serve["verify"] = verify_timed("gat-serving", eng.trainer.plan, device)
    print(f"[gat-serving] {json.dumps(serve)}")
    serve["breakdown"] = [breakdown(eng, device, n, kernel="bsr_attention_fwd")
                          for n in (4 * sizes.wave_size, sizes.batch_size)]
    print(f"[gat-serving] per-batch breakdown: {json.dumps(serve['breakdown'])}")
    tr = eng.trainer
    seeds = np.random.default_rng(3).choice(ds.graph.n_rows, sizes.batch_size,
                                            replace=False)
    data = tr._batch_arrays(tr.sampler.sample_batch(seeds, tr.features))
    builds = batch_columns(data)
    print(f"[gat-serving] nonzero columns of one batch: {json.dumps(builds)}")
    rows, err = sampled_attention_rows(
        "gat-serving", capture_sampled_attention(tr, data, grad=False), device,
        reps=5)
    serve.update(columns=builds,
                 column_build_ms=sum(b["build_ms"] for b in builds.values()),
                 rows=rows, max_abs_err=err["fwd"])
    return serve


def decided_sampled_grads(tr, ref, params, data) -> tuple:
    """Both sampled programs' gradients at ``params`` on the batch
    ``data``, the torch program's ReLU decisions taken from the cuda
    program's where the two part within MASK_MARGIN of 0 (as
    ``decided_grads``; here the ReLU is torch's, after the aggregation or
    the attention). Each trainer's layers apply the hook where they apply
    their ReLU: with an activation other than ``torch.relu``,
    ``apply_layer`` leaves the ReLU out of the composed epilogue and
    calls the activation after it, the same operations in the same
    order."""
    masks, calls = [], []

    def record(pre):
        masks.append(pre > 0)
        return torch.relu(pre)

    def decide(pre):
        want, mine = masks[len(calls)], pre > 0
        parted = mine != want
        beyond = parted & (pre.abs() > MASK_MARGIN)
        calls.append({"elements": pre.numel(), "parted": int(parted.sum()),
                      "beyond_margin": int(beyond.sum()),
                      "max_abs_pre": float(pre[parted].abs().max())
                      if parted.any() else 0.0})
        keep = torch.where(parted & ~beyond, want, mine)
        return torch.where(keep, pre, torch.zeros_like(pre))

    def grads_with(trainer, hook):
        config = trainer.config
        if config.activation is not torch.relu:
            raise AssertionError("the gate hooks the port's own ReLU")
        trainer.config = dataclasses.replace(config, activation=hook)
        try:
            return value_and_grad(trainer._loss, params, data)[1]
        finally:
            trainer.config = config

    got = grads_with(tr, record)
    want = grads_with(ref, decide)
    if len(calls) != len(masks):
        raise AssertionError(f"{len(masks)} ReLU calls in the cuda program, "
                             f"{len(calls)} in the torch program")
    return got, want, calls


def sampled_per_step(plan) -> dict:
    """The kernel launches one sampled training step makes, from the plan:
    fused attention 3 passes a layer; a BSR aggregation one ``bsr_spmm``
    a layer forward and one backward where its input needs a gradient
    (X·W under the composed epilogue; x itself, data at layer 0,
    otherwise); one Adam launch."""
    n = len(plan.layers)
    out = {"fused_adam": 1}
    if plan.layers[0].agg_primitive.endswith("spmm_attention"):
        out.update({name: n for name, _, _ in ATTENTION.values()})
    elif plan.sampler.emit_bsr:
        out["bsr_spmm"] = n + len(backward_layers(plan))
    return out


def backward_layers(plan) -> list:
    """The layers whose ``bsr_spmm`` aggregation runs a backward product."""
    return [l.index for l in plan.layers if l.epilogue is not None or l.index > 0]


def step_second_passes(plan, data, per_step: dict) -> dict:
    """The second passes one step over ``data`` launches: once for each
    call on an operand with split rows (A for the forward products and
    the attention row pass, Aᵀ for the backward and the column pass)."""
    def split(d, n_rows):
        return int(nonzero_columns(d["rows"], d["cols"], d["blocks"],
                                   n_rows).splits.shape[0] > 0)

    if not plan.sampler.emit_bsr:
        return {}
    valid = data["valid"]
    a = [split(b["fwd"], valid[l + 1].shape[0]) for l, b in enumerate(data["blocks"])]
    at = [split(b["bwd"], valid[l].shape[0]) for l, b in enumerate(data["blocks"])]
    if "bsr_spmm" in per_step:
        return {"bsr_spmm" + SECOND_PASS:
                sum(a) + sum(at[l] for l in backward_layers(plan))}
    return {"bsr_attention_fwd" + SECOND_PASS: sum(a),
            "bsr_attention_bwd_row" + SECOND_PASS: sum(a),
            "bsr_attention_bwd_col" + SECOND_PASS: sum(at)}


def step_breakdown(tr, device, reps: int = 3) -> dict:
    """Where one training step's time goes, median of ``reps`` batches of
    the path's seeds (host clock, synchronised): sampling and CSR→BSR on
    the host, the copy to the card, the step (forward with the column
    builds, backward, Adam; its result dropped, so the trainer is left as
    it was)."""
    rng = np.random.default_rng(11)
    n = min(tr.sampler.batch_size, len(tr.train_ids))
    parts = {"sample_ms": [], "to_device_ms": [], "step_ms": []}
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        batch = tr.sampler.sample_batch(rng.choice(tr.train_ids, n, replace=False),
                                        tr.features, tr.labels_np, rng=rng)
        t1 = time.perf_counter()
        data = tr._batch_arrays(batch, train=True)
        sync(device)
        t2 = time.perf_counter()
        float(tr._step(tr.params, tr.opt_state, data)[2])
        t3 = time.perf_counter()
        for k, a, b in (("sample_ms", t0, t1), ("to_device_ms", t1, t2),
                        ("step_ms", t2, t3)):
            parts[k].append((b - a) * 1e3)
    out = {"seeds": n, **{k: float(np.median(v)) for k, v in parts.items()}}
    out["batch_ms"] = sum(out[k] for k in parts)
    return out


def step_profile(tr, data, device, want: dict) -> dict:
    """``epoch_profile`` of one step over the fixed batch ``data`` (the
    result dropped, so the trainer is left as it was), against the step's
    median synchronised time over 3 steps (``step_ms``)."""
    if device.type != "cuda":
        return {"complete": False}

    def step():
        return tr._step(tr.params, tr.opt_state, data)

    times = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    return {"step_ms": step_s * 1e3, **epoch_profile(step, device, step_s, want)}


def sampled_spmm_rows(batch, data, dims, device, reps: int) -> tuple:
    """``bsr_spmm`` on one training batch's real operands at the widths the
    step gives them: each layer's A at its output width (the forward's
    X·Wn) and Aᵀ at the same width (the backward's dY), through nonzero
    columns built as the step builds them; checked against the plain
    version (a repeat bitwise equal) and ``torch.sparse.mm`` on the
    block's CSR, then timed beside both (device time, profiler) with the
    bounds."""
    rows, err = {}, 0.0
    for l, (blk, d) in enumerate(zip(batch.blocks, data["blocks"])):
        f = dims[l + 1]
        n_out, n_in = batch.bucket.node_caps[l + 1], batch.bucket.node_caps[l]
        for label, arr, csr, n_rows, n_cols in (
                ("A", d["fwd"], blk.csr, n_out, n_in),
                ("A^T", d["bwd"], blk.csr.transpose(), n_in, n_out)):
            x = torch.randn((n_cols, f),
                            generator=torch.Generator().manual_seed(l)).to(device)
            args = (arr["rows"], arr["cols"], arr["blocks"], x, n_rows)
            nzc = nonzero_columns(*args[:3], n_rows)
            err = max(err, check_spmm(f"sampled layer {l} {label} [{n_rows}x{n_cols}] "
                                      f"F={f}", *args, device, nzc))
            lib = csr_tensor(csr, device)
            check_close(f"library yardstick (sampled layer {l} {label})",
                        torch.sparse.mm(lib, x), bsr_spmm_ref(*args))
            row = {"kernel": "bsr_spmm", "operand": label, "layer": l, "F": f,
                   "n_rows_padded": n_rows, "n_cols_padded": n_cols,
                   "n_blocks": int(arr["blocks"].shape[0]), "nnz": int(csr.nnz),
                   "split_rows": int(nzc.splits.shape[0])}
            row.update(timings({"": lambda: bsr_spmm(*args, nzc=nzc),
                                "plain_": lambda: bsr_spmm_ref(*args),
                                "library_": lambda: torch.sparse.mm(lib, x)},
                               device, reps, expect=SAMPLED_SPMM_EXPECT))
            row.update(spmm_bound(*args[:3], f, n_rows))
            rows[(label, l)] = row
            print("[sage-sampled] " + json.dumps(row))
    return rows, err


def sampled_train_path(name, ds, cfg, device, *, lr: float, fanouts,
                       batch_size: int, cut: int, epochs: int,
                       falling: bool = True) -> dict:
    """One sampled training path: ``MiniBatchTrainer`` on ``cuda`` (fused
    Adam) and on ``torch`` (plain versions, plain Adam) from the same
    weights over the train mask cut to ``cut`` nodes, ``epochs`` epochs
    each (the same batches: the trainers' streams share a seed). Counts
    zeroed just before the cuda run and read after every epoch, each
    epoch's launches exactly ``sampled_per_step`` times its steps. Phase
    4's gates: the gradients of both programs at the same parameters on
    a fixed probe batch (the first ``batch_size`` train seeds) at the
    first step and after the last, ReLU decisions as
    ``decided_sampled_grads``; losses within 1e-3 relative (and falling
    where ``falling``); parameters after the last step."""
    mask = train_cut(ds.train_mask, cut)
    trs, build_s = {}, {}
    for eng in ("cuda", "torch"):
        t0 = time.perf_counter()
        trs[eng] = MiniBatchTrainer(
            cfg, ds.graph, ds.features, ds.labels, mask,
            adam(lr, fused=eng == "cuda"), fanouts=tuple(fanouts),
            batch_size=batch_size, engine=eng, seed=0, device=device)
        build_s[eng] = time.perf_counter() - t0
    tr, ref = trs["cuda"], trs["torch"]
    for a, b in zip(tr.params["layers"], ref.params["layers"]):
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"[{name}] the two programs must share weights")
    plan = tr.plan
    print(f"[{name}] plan (trainers built in {build_s['cuda']:.1f}s + "
          f"{build_s['torch']:.1f}s):\n{plan.describe()}")
    verified = verify_timed(name, plan, device)
    on_card = device.type == "cuda"
    per_step = sampled_per_step(plan)
    steps = -(-len(tr.train_ids) // batch_size)
    want = {k: per_step.get(k, 0) * steps if on_card else 0 for k in KERNELS}
    probe = tr.sampler.sample_batch(tr.train_ids[:batch_size], tr.features,
                                    tr.labels_np, rng=np.random.default_rng(17))
    data = tr._batch_arrays(probe, train=True)

    def grad_check(when: str, params) -> dict:
        return gradient_gate(name, when,
                             decided_sampled_grads(tr, ref, params, data))

    grad_start = grad_check("at the first step", tr.params)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    zero_counts()
    for epoch in range(epochs):
        before = counts()
        t0 = time.perf_counter()
        losses.append(tr.train_epoch())  # float() each step: synchronised
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in counts().items()}
        if got != want:
            raise AssertionError(f"[{name}] epoch {epoch + 1} launched {got}, "
                                 f"expected {want}")
    launched = counts()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    grad_end = grad_check(f"after {epochs * steps} steps", tr.params)
    ref_losses, ref_times = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        ref_losses.append(ref.train_epoch())
        ref_times.append(time.perf_counter() - t0)
    rel, param_diff = loss_and_param_gate(
        name, f"after {epochs * steps} steps", losses, ref_losses, tr.params,
        ref.params, falling)
    columns = batch_columns(data)
    second = step_second_passes(plan, data, per_step) if on_card else {}
    out = {"losses": losses, "ref_losses": ref_losses, "max_rel_diff": max(rel),
           "steps_per_epoch": steps, "epoch_ms": [t * 1e3 for t in times],
           "ref_epoch_ms": [t * 1e3 for t in ref_times],
           "step_ms_mean": float(np.sum(times)) * 1e3 / (epochs * steps),
           "ref_step_ms_mean": float(np.sum(ref_times)) * 1e3 / (epochs * steps),
           "launches": launched, "per_step": per_step, "second_passes_probe": second,
           "build_s": build_s, "peak_mem_bytes": peak, "n_traces": tr.n_traces,
           "grad_start": grad_start, "grad_end": grad_end,
           "param_rel_diff": param_diff, "columns": columns,
           "verify": verified,
           "column_build_ms": sum(c["build_ms"] for c in columns.values()),
           "breakdown": step_breakdown(tr, device),
           "profile": step_profile(tr, data, device, {**per_step, **second})}
    print(f"[{name}] " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("columns",)}))
    return {"summary": out, "tr": tr, "ref": ref, "data": data, "probe": probe}


def sampled_training(ds, qds, sizes: Sizes, device) -> dict:
    """Phase 14: sampled training at full width. (a) SAGE-mean [F,
    train_hidden..., C] on ``dataset``, fused Adam 0.01, the train mask
    cut to ``sage_cut`` nodes, ``SAGE_EPOCHS`` epochs, and ``bsr_spmm`` on
    one batch's real operands; (b) GAT [F, gat_hidden..., C] with
    ``gat_heads`` heads, ``GAT_ADAM``'s lr, the train mask cut to one
    batch, ``GAT_STEPS`` steps, and the three attention kernels on one
    batch's real operands and cotangents; (c) one step each of GT [F,
    quick_hidden..., C] with ``gt_heads`` heads on ``quick_dataset``
    (fanouts the last of ``fanouts``) and SAGE-max [F, train_hidden...,
    C] on ``dataset``."""
    b = sizes.sampled_batch_size
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    out = {}
    sage = sampled_train_path(
        "sage-sampled", ds, GNNConfig(kind="SAGE", layer_dims=dims,
                                      aggregation="mean"),
        device, lr=ADAM[1], fanouts=sizes.fanouts, batch_size=b,
        cut=sizes.sage_cut, epochs=SAGE_EPOCHS)
    spmm_rows, spmm_err = sampled_spmm_rows(sage["probe"], sage["data"], dims,
                                            device, reps=5)
    out["sage"] = {**sage["summary"], "rows": spmm_rows, "max_abs_err": spmm_err}
    del sage
    gdims = [ds.features.shape[1], *sizes.gat_hidden, ds.n_classes]
    gat = sampled_train_path(
        "gat-sampled", ds, GNNConfig(kind="GAT", layer_dims=gdims,
                                     aggregation="gcn", gat_heads=sizes.gat_heads),
        device, lr=GAT_ADAM[1], fanouts=sizes.fanouts, batch_size=b, cut=b,
        epochs=GAT_STEPS)
    captured = capture_sampled_attention(gat["tr"], gat["data"], grad=True)
    rows, err = sampled_attention_rows("gat-sampled", captured, device, reps=2)
    out["gat"] = {**gat["summary"], "rows": rows, "err": err}
    del gat, captured
    qdims = [qds.features.shape[1], *sizes.quick_hidden, qds.n_classes]
    gt = sampled_train_path(
        "gt-sampled", qds, GNNConfig(kind="GT", layer_dims=qdims,
                                     aggregation="gcn", gat_heads=sizes.gt_heads),
        device, lr=ADAM[1], fanouts=sizes.fanouts[-(len(qdims) - 1):],
        batch_size=b, cut=b, epochs=1, falling=False)
    if gt["tr"].plan.layers[0].primitive != "gather.feature_matmul_sparse":
        raise AssertionError("sampled GT's layer 0 must bind "
                             "gather.feature_matmul_sparse")
    out["gt"] = gt["summary"]
    del gt
    mx = sampled_train_path(
        "max-sampled", ds, GNNConfig(kind="SAGE", layer_dims=dims,
                                     aggregation="max"),
        device, lr=ADAM[1], fanouts=sizes.fanouts, batch_size=b, cut=b,
        epochs=1, falling=False)
    if any(l.agg_primitive != "gather.segment_max" for l in mx["tr"].plan.layers):
        raise AssertionError("sampled SAGE-max must bind gather.segment_max")
    out["max"] = mx["summary"]
    return out


# ---------------------------------------------------------------------------
# Phases 10-11: LM serving at llama3.2-1B width and the flash attention kernel
# ---------------------------------------------------------------------------

#: the flash kernel against its plain version: the JAX suite's float32
#: tolerance (test_flash_matches_ref) and its bfloat16 one (test_flash_bf16),
#: each |got - want| <= tol + tol·|want|
FLASH_TOL = 2e-5
FLASH_BF16_TOL = 5e-2
#: greedy tokens must agree where the cuda program's top-2 logit margin
#: exceeds this (below it, float32 rounding may pick either)
TOKEN_MARGIN = 1e-3
#: an MoE layer may route a token to other experts in the cuda and torch
#: programs only where the cuda program's top-k margin (p_k - p_(k+1)) is
#: at most this: the flash kernel moves q·k, and so the router's inputs,
#: by float32 rounding, far below it
ROUTE_MARGIN = 1e-5


class RoutingLog:
    """Measurement only: while entered, every ``moe.route`` call appends
    the expert ids it chose [T, k] and each token's top-k margin
    ``p_k - p_(k+1)`` [T] to ``calls``. Nothing on the main path calls it."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        route = self._route = moe_mod.route

        def recorded(probs, k):
            vals, ids = route(probs, k)
            top = torch.sort(probs, dim=-1, descending=True).values
            margin = (top[:, k - 1] - top[:, k] if k < probs.shape[1]
                      else torch.full_like(top[:, 0], float("inf")))
            self.calls.append((ids.clone(), margin))
            return vals, ids

        moe_mod.route = recorded
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route


def routes_parted(ours: list, theirs: list) -> list:
    """The top-k margins (``ours``') at every token that one program's MoE
    calls routed to other experts than the other's, call by call."""
    if len(ours) != len(theirs):
        raise AssertionError(f"{len(ours)} MoE calls against {len(theirs)}")
    margins = []
    for (ids, margin), (other, _) in zip(ours, theirs):
        differ = (ids.sort(1).values != other.sort(1).values).any(1)
        margins += margin[differ].tolist()
    return margins


class RecordingLM:
    """The cuda model's entry points as ``ServingEngine`` calls them. Each
    call's token input, last-position logits, synchronised host time,
    flash launches and (under a ``RoutingLog``) MoE routing are recorded,
    so that the reference program can be fed the same inputs afterwards.
    Measurement only."""

    def __init__(self, model, device, routing: "RoutingLog | None" = None):
        self.model, self.device, self.routing = model, device, routing
        self.calls = []  # dicts: wave, kind, tokens, logits, s, flash, routes
        self.wave = -1

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def _call(self, kind, fn, tokens):
        sync(self.device)
        before = flash_attention.launches
        n_routes = len(self.routing.calls) if self.routing else 0
        t0 = time.perf_counter()
        logits, cache = fn()
        sync(self.device)
        self.calls.append({"wave": self.wave, "kind": kind, "tokens": tokens.clone(),
                           "logits": logits.clone(), "s": time.perf_counter() - t0,
                           "flash": flash_attention.launches - before,
                           "routes": self.routing.calls[n_routes:] if self.routing else []})
        return logits, cache

    def prefill(self, params, tokens, cache):
        self.wave += 1
        return self._call("prefill", lambda: self.model.prefill(params, tokens, cache),
                          tokens)

    def decode_step(self, params, cache, tokens):
        return self._call("decode", lambda: self.model.decode_step(params, cache, tokens),
                          tokens)


def lm_requests(sizes: Sizes, vocab: int) -> list:
    """``lm_requests`` prompts of random tokens, lengths drawn from seed 0
    in lm_prompts[0]..lm_prompts[1], the longest set to lm_prompts[1]."""
    rng = np.random.default_rng(0)
    lo, hi = sizes.lm_prompts
    lengths = rng.integers(lo, hi + 1, sizes.lm_requests)
    lengths[int(np.argmax(lengths))] = hi
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=sizes.lm_new_tokens)
            for i, n in enumerate(lengths)]


#: phase 20's profiled calls by kernel class: a kernel launched inside one
#: of ``models/moe.py``'s ``record_function`` spans counts under its stage
MOE_SPANS = {span: "expert bmm" if span == "moe.experts" else "dispatch/combine"
             for span in moe_mod.SPANS}


def lm_profile(fn, device, n_flash: int, wall_ms: float, spans: dict = None) -> dict:
    """One call of ``fn`` under the profiler: device ms by kernel class,
    busy total and the idle share of ``wall_ms`` (the call's synchronised
    time in the engine's run). With ``spans`` (a ``record_function``
    span's name -> a class) the profiler records CPU activity too: every
    kernel, copy and memset counts under its name's class, and one that an op
    inside such a span launched moves to the span's class (a kernel
    launched outside any op, as flash's through ctypes, stays under its
    name's)."""
    if device.type != "cuda":
        return {"complete": False}
    prof, windows = profiled(fn, device, {"flash_attention": n_flash}, cpu=bool(spans))
    if prof is None:
        return {"complete": False, "windows": windows}
    by = defaultdict(float)
    if spans:
        for e in prof.events():
            # the spans and the profiler's step also show on the device's
            # timeline, as user annotations
            annotation = (getattr(e, "is_user_annotation", False) or e.name in spans
                          or e.name.startswith("ProfilerStep"))
            if e.device_type == DeviceType.CUDA and not annotation:
                by[classify(e.name)] += e.time_range.elapsed_us() / 1e3
            span, p = None, e
            while p is not None and span is None:
                span, p = spans.get(p.name), p.cpu_parent
            for k in (getattr(e, "kernels", None) or []) if span else []:
                by[span] += k.duration / 1e3
                by[classify(k.name)] -= k.duration / 1e3
    else:
        for name, us, _ in device_events(prof):
            by[classify(name)] += us / 1e3
    busy = sum(by.values())
    # a kernel listed under two ops would leave its name's class negative
    return {"complete": min(by.values(), default=0.0) > -1e-6, "windows": windows,
            "device_ms": dict(by), "busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms}


def flash_layers(cfg) -> int:
    """Flash launches a prefill of text: one for each attention layer
    without a sliding window (all of llama3.2-1b's 16, gemma3-1b's 4
    global ones, dbrx-132b's, pixtral-12b's 40), two for an
    encoder-decoder's (whisper-tiny's self attention, and its cross
    attention over the cache's encoder output), none where the attention
    is MLA (deepseek-v3-671b: ``_attn_core`` always), and one for every
    shared site (zamba2-7b's 13); none for a recurrent block (xlstm-1.3b:
    none)."""
    return sum(kind == "shared_attn"
               or (kind == "attn" and not cfg.mla and _layer_window(cfg, i) == 0)
               for i, kind in enumerate(cfg.blocks)) * (2 if cfg.is_encoder_decoder else 1)


def lm_serving_phase(cfg, sizes: Sizes, device) -> dict:
    """Phases 10, 15, 20 and 21, LM serving: ``ServingEngine`` over the
    ``cuda`` model (prefill attention on the flash kernel in the GQA layers
    without a window) at the configuration's full width, random weights
    from a seeded generator on the card; counts zeroed just before
    ``run()`` and read after it. Then the ``torch`` model (the plain
    version) fed the same inputs call by call: its logits within 1e-4 at
    every step, and its greedy tokens equal where the cuda program's top-2
    margin exceeds ``TOKEN_MARGIN``. With MoE layers both programs'
    routing is recorded (``RoutingLog``): a wave is held to those gates
    up to the first call whose routing parted, and the run fails if any
    token parted at a top-k margin above ``ROUTE_MARGIN``; the calls
    parted and not held are counted. A model with sLSTM blocks leaves its
    longest prefill unprofiled (xlstm-1.3b's launches ~30 kernels a time
    step of its sLSTM loop: a trace of ~200,000)."""
    model, ref = build_model(cfg, inner="cuda"), build_model(cfg, inner="torch")
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    heads = (f"{cfg.n_heads} MLA heads (q rank {cfg.mla.q_lora_rank}, kv rank "
             f"{cfg.mla.kv_lora_rank}, qk {cfg.mla.qk_nope_head_dim} + "
             f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim})" if cfg.mla else
             f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV) of {cfg.resolved_head_dim}")
    experts = (f", {cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert} (top "
               f"{cfg.moe.n_experts_per_token}, {cfg.moe.n_shared_experts} shared) from "
               f"layer {cfg.first_k_dense_layers}" if cfg.moe else "")
    kinds = {k: cfg.blocks.count(k) for k in dict.fromkeys(cfg.blocks)}
    blocks = ("" if set(kinds) == {"attn"} else
              " (" + ", ".join(f"{n} {k}" for k, n in kinds.items()) + ")")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers{blocks}, d_model {cfg.d_model}, "
          f"{heads}{experts}, vocab {cfg.vocab_size}: {n_params:,} parameters drawn in "
          f"{init_s:.2f}s")
    max_seq = sizes.lm_prompts[1] + sizes.lm_new_tokens
    # warmup: the same requests once, untimed (the flash library's load,
    # cuBLAS's first calls at these shapes)
    warm = ServingEngine(model, params, batch_slots=sizes.lm_slots, max_seq=max_seq,
                         device=device)
    for r in lm_requests(sizes, cfg.vocab_size):
        warm.submit(r)
    t0 = time.perf_counter()
    warm.run()
    sync(device)
    warmup_s = time.perf_counter() - t0
    routing = RoutingLog() if cfg.moe else None
    rec = RecordingLM(model, device, routing)
    engine = ServingEngine(rec, params, batch_slots=sizes.lm_slots, max_seq=max_seq,
                           device=device)
    reqs = lm_requests(sizes, cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    mem_before = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    with routing or contextlib.nullcontext():
        t0 = time.perf_counter()
        done = engine.run()
        sync(device)
        wall = time.perf_counter() - t0
    launched = counts()
    # the run's own peak: what earlier phases left allocated is not counted
    peak_abs = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = peak_abs - mem_before

    waves = rec.wave + 1
    per_wave = flash_layers(cfg) if on_card else 0
    if [r.rid for r in done] != list(range(len(reqs))):
        raise AssertionError("requests not answered in order")
    for r in done:
        if not r.done or len(r.output) != sizes.lm_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
    for c in rec.calls:
        want = per_wave if c["kind"] == "prefill" else 0
        if c["flash"] != want:
            raise AssertionError(f"a {c['kind']} of wave {c['wave']} launched "
                                 f"flash_attention {c['flash']} times, expected {want}")
    if launched["flash_attention"] != per_wave * waves or (on_card and waves == 0):
        raise AssertionError(f"flash_attention launched {launched['flash_attention']} "
                             f"times for {waves} waves of {per_wave} flash layers")
    if sum(launched.values()) != launched["flash_attention"]:
        raise AssertionError(f"LM serving launched other kernels: {launched}")

    worst, steps, sure_steps, ref_s = 0.0, 0, 0, defaultdict(list)
    worst_at = None
    cache = None
    parted_waves, parted, unheld = set(), [], 0
    for c in rec.calls:
        logits = c["logits"]
        if logits.shape != (c["tokens"].shape[0], cfg.padded_vocab()) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{c['kind']} logits {tuple(logits.shape)} not finite "
                                 f"or of the wrong shape")
        ref_routing = RoutingLog() if cfg.moe else None
        sync(device)
        t0 = time.perf_counter()
        with ref_routing or contextlib.nullcontext():
            if c["kind"] == "prefill":
                cache = ref.init_cache(c["tokens"].shape[0], max_seq, dtype=torch.float32,
                                       device=device)
                want, cache = ref.prefill(params, c["tokens"], cache)
            else:
                want, cache = ref.decode_step(params, cache, c["tokens"])
        sync(device)
        ref_s[c["kind"]].append(time.perf_counter() - t0)
        if ref_routing is not None:
            margins = routes_parted(c["routes"], ref_routing.calls)
            if margins:
                parted.append({"wave": c["wave"], "kind": c["kind"],
                               "tokens": len(margins), "max_margin": max(margins)})
                parted_waves.add(c["wave"])
        if c["wave"] in parted_waves:  # the torch program's cache differs from here
            unheld += 1
            continue
        diff = float((logits - want).abs().max())
        if diff > worst:
            worst, worst_at = diff, f"a {c['kind']} of wave {c['wave']}"
        top = torch.topk(logits, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > TOKEN_MARGIN
        steps += sure.numel()
        sure_steps += int(sure.sum())
        if not torch.equal(logits.argmax(-1)[sure], want.argmax(-1)[sure]):
            raise AssertionError(f"greedy tokens differ in a {c['kind']} of wave "
                                 f"{c['wave']} where the top-2 margin > {TOKEN_MARGIN}")
    if not worst <= TOL:
        raise AssertionError(f"cuda vs torch LM logits differ by {worst} > {TOL} "
                             f"(in {worst_at})")
    route_margin = max((p["max_margin"] for p in parted), default=0.0)
    if route_margin > ROUTE_MARGIN:
        raise AssertionError(f"MoE routing parted at a top-k margin of {route_margin} "
                             f"> {ROUTE_MARGIN}: {parted}")
    print(f"[lm] cuda vs torch, the torch model fed the cuda program's tokens: "
          f"logits within {worst:.3g}; greedy tokens equal at all {sure_steps} of "
          f"{steps} (slot, step) pairs whose top-2 margin > {TOKEN_MARGIN}"
          + (f"; MoE routing parted in {len(parted)} of {len(rec.calls)} calls "
             f"(largest top-k margin there {route_margin:.3g}), {unheld} calls not "
             f"held" if cfg.moe else ""))

    prefill_s = [c["s"] for c in rec.calls if c["kind"] == "prefill"]
    decode_s = [c["s"] for c in rec.calls if c["kind"] == "decode"]
    tokens = sum(len(r.output) for r in done)
    longest = max((c for c in rec.calls if c["kind"] == "prefill"),
                  key=lambda c: c["tokens"].shape[1])
    b = longest["tokens"].shape[0]
    median_ms = float(np.median(decode_s)) * 1e3 if decode_s else 0.0
    # a cache filled by the longest prefill, for a decode step's profile
    _, filled = model.prefill(params, longest["tokens"], model.init_cache(
        b, max_seq, dtype=torch.float32, device=device))
    cur = longest["logits"].argmax(-1)[:, None]
    spans = MOE_SPANS if cfg.moe else None
    out = {
        "arch": cfg.name, "n_params": n_params, "init_s": init_s, "warmup_s": warmup_s,
        "requests": len(done),
        "waves": waves, "slots": sizes.lm_slots, "max_seq": max_seq,
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "wave_prompt_tokens": [int(c["tokens"].shape[1]) for c in rec.calls
                               if c["kind"] == "prefill"],
        "launches": launched, "flash_per_wave": per_wave,
        "max_logit_diff": worst, "token_pairs": steps, "token_pairs_compared": sure_steps,
        "routing_parted": parted, "calls_not_held": unheld,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_ms": [x * 1e3 for x in prefill_s],
        "decode_step_ms_median": median_ms,
        "decode_ms_per_token": median_ms / sizes.lm_slots,
        "ref_prefill_ms": [x * 1e3 for x in ref_s["prefill"]],
        "ref_decode_step_ms_median": float(np.median(ref_s["decode"])) * 1e3
        if ref_s["decode"] else 0.0,
        "peak_mem_bytes": peak, "peak_abs_bytes": peak_abs, "params_bytes": 4 * n_params,
        "profile_prefill": lm_profile(
            lambda: model.prefill(params, longest["tokens"], model.init_cache(
                b, max_seq, dtype=torch.float32, device=device)),
            device, per_wave, longest["s"] * 1e3, spans)
        if "slstm" not in cfg.blocks else {"complete": False, "skipped": True},
        "profile_decode": lm_profile(
            lambda: model.decode_step(params, filled, cur), device, 0, median_ms, spans),
    }
    del filled
    print("[lm] " + json.dumps(out))
    return {"summary": out, "model": model, "params": params, "tokens": longest["tokens"],
            "max_seq": max_seq}


def flash_bound(b, h, hkv, tq, tk, d, causal: bool, elem: int) -> dict:
    """Least time for one flash call on these shapes, from the wrapper's
    ``flash_cost``: q, k, v read once and the output written once, against
    4·D operations (two products) per visible (query, key) pair of each
    head — with the top-left causal mask row i sees min(i + 1, Tk) keys —
    at the peak of the inputs' type: bf16's for 2-byte inputs (the kernel
    itself multiplies in fp32), fp32's for float32."""
    out = flash_cost(b, h, hkv, tq, tk, d, causal, elem)
    out["bound_ms"], out["bound_by"] = _bound(
        out["bytes"], out["flop"], BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S)
    return out


def capture_flash(model, params, tokens, max_seq: int, device) -> list:
    """One prefill of ``tokens`` through ``model``, recording each layer's
    flash inputs (q, k, v as the layer passes them: [B, H, T, D] views of
    the projections and of the cache). Measurement only: the executor is
    wrapped for this call."""
    return [x[:3] for x in capture_flash_calls(model, params, tokens, max_seq, device)]


def capture_flash_calls(model, params, tokens, max_seq: int, device, **inputs) -> list:
    """``capture_flash`` with the frontend's ``inputs`` given to the
    prefill: each flash call's (q, k, v, causal) in launch order."""
    table = kops._EXECUTORS["cuda"]
    inner = table["flash"]
    layers = []

    def spy(q, k, v, **kw):
        layers.append((q, k, v, kw["causal"]))
        return inner(q, k, v, **kw)

    table["flash"] = spy
    try:
        model.prefill(params, tokens, model.init_cache(
            tokens.shape[0], max_seq, dtype=torch.float32, device=device), **inputs)
    finally:
        table["flash"] = inner
    return layers


def check_flash(label, q, k, v, causal: bool, device, tol: float = FLASH_TOL) -> float:
    """The flash kernel against its plain version on the same device
    tensors (|got - want| <= tol + tol·|want|), and a repeat launch bitwise
    equal; returns the largest absolute error."""
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    sync(device)
    if got.dtype != q.dtype or got.shape != want.shape:
        raise AssertionError(f"flash_attention {label}: {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not float((diff - tol * want.float().abs()).max()) <= tol:
        raise AssertionError(f"flash_attention {label}: max abs error {err} > {tol} "
                             f"(+ {tol}·|want|)")
    if device.type == "cuda" and not torch.equal(got, again):
        raise AssertionError(f"flash_attention {label}: a repeat launch is not "
                             "bitwise equal")
    print(f"[kernel] flash_attention {label}: max_abs_err={err:.3g}")
    return err


def flash_edge_cases(device) -> dict:
    """Random inputs: Tq != Tk causal and not, T = 1, 33 and 1000, D = 8
    and 128, K padding inside a tile, Hkv == H; float32 and bfloat16. Then
    the kernel's tiles: every D in ``HEAD_DIMS`` at Tq = 150 and Tk = 97 /
    201 (multiples of neither a query tile, 128 rows or 128/hp a head, nor
    the 64-key tile), KV groups of 1, 2, 4 and 8 heads (1, 2, 4 and 4
    heads a CTA); the same inputs as strided [B, T, H, D] views and
    misaligned copies (the kernel's synchronous load path), bitwise equal
    to the aligned call; bfloat16."""
    gen = torch.Generator().manual_seed(31)
    err = {"f32": 0.0, "bf16": 0.0}
    for b, h, hkv, tq, tk, d, causal in (
            (1, 4, 2, 40, 72, 64, True), (1, 4, 2, 72, 40, 64, True),
            (1, 4, 2, 40, 72, 64, False), (2, 8, 2, 1, 1, 64, True),
            (1, 4, 4, 33, 33, 64, True), (1, 8, 2, 1000, 1000, 64, True),
            (2, 4, 4, 33, 33, 8, True), (1, 4, 1, 100, 100, 128, True),
            (1, 4, 1, 100, 100, 128, False), (1, 2, 2, 64, 100, 32, False)):
        q = torch.randn((b, h, tq, d), generator=gen).to(device)
        k, v = (torch.randn((b, hkv, tk, d), generator=gen).to(device) for _ in range(2))
        label = f"B={b} H={h} Hkv={hkv} Tq={tq} Tk={tk} D={d} causal={causal}"
        err["f32"] = max(err["f32"], check_flash(label, q, k, v, causal, device))
        err["bf16"] = max(err["bf16"], check_flash(
            label + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
            device, FLASH_BF16_TOL))
    tiles = [(d, 2, causal) for d in HEAD_DIMS for causal in (True, False)]
    tiles += [(64, g, causal) for g in (1, 4, 8) for causal in (True, False)]
    for d, group, causal in tiles:
        h, tq, tk = 8, 150, 97 if causal else 201
        q = torch.randn((2, h, tq, d), generator=gen).to(device)
        k, v = (torch.randn((2, h // group, tk, d), generator=gen).to(device)
                for _ in range(2))
        label = f"tiles D={d} group={group} Tq={tq} Tk={tk} causal={causal}"
        err["f32"] = max(err["f32"], check_flash(label, q, k, v, causal, device))
        got = flash_attention(q, k, v, causal=causal)
        for layout, args in (
                ("strided", [x.transpose(1, 2).contiguous().transpose(1, 2)
                             for x in (q, k, v)]),
                ("misaligned", [misaligned(x) for x in (q, k, v)])):
            if device.type == "cuda" and not torch.equal(
                    flash_attention(*args, causal=causal), got):
                raise AssertionError(f"flash_attention {label} {layout}: not the "
                                     "aligned call's result")
        err["bf16"] = max(err["bf16"], check_flash(
            label + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
            device, FLASH_BF16_TOL))
    return err


def head_dim_edge_cases(device, d: int, shapes: tuple, seed: int) -> dict:
    """The kernel at head width ``d`` on ragged ``shapes`` (B, H, Hkv, Tq,
    Tk, causal), float32 and bfloat16, and strided and misaligned views
    bitwise equal to the aligned call."""
    gen = torch.Generator().manual_seed(seed)
    err = {"f32": 0.0, "bf16": 0.0}
    for b, h, hkv, tq, tk, causal in shapes:
        q = torch.randn((b, h, tq, d), generator=gen).to(device)
        k, v = (torch.randn((b, hkv, tk, d), generator=gen).to(device)
                for _ in range(2))
        label = f"D={d} B={b} H={h} Hkv={hkv} Tq={tq} Tk={tk} causal={causal}"
        err["f32"] = max(err["f32"], check_flash(label, q, k, v, causal, device))
        got = flash_attention(q, k, v, causal=causal)
        for layout, args in (
                ("strided", [x.transpose(1, 2).contiguous().transpose(1, 2)
                             for x in (q, k, v)]),
                ("misaligned", [misaligned(x) for x in (q, k, v)])):
            if device.type == "cuda" and not torch.equal(
                    flash_attention(*args, causal=causal), got):
                raise AssertionError(f"flash_attention {label} {layout}: not the "
                                     "aligned call's result")
        err["bf16"] = max(err["bf16"], check_flash(
            label + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
            device, FLASH_BF16_TOL))
    return err


#: the D = 256 kernel (gemma3-1b's global layers: H 4, one KV head, so 4
#: heads a CTA): Tq != Tk causal and not, T = 1, a query tile's 16 rows a
#: head cut at 150, Hkv == H (1 head a CTA) and a group of 2
d256_edge_cases = functools.partial(head_dim_edge_cases, d=256, seed=37, shapes=(
    (1, 4, 1, 150, 97, True), (2, 4, 1, 150, 201, False),
    (1, 4, 1, 40, 72, True), (1, 4, 1, 72, 40, True), (2, 4, 1, 1, 1, True),
    (1, 4, 4, 33, 33, True), (1, 4, 2, 130, 130, True)))
#: the D = 128 kernel (dbrx-132b: H 48 over 8 KV heads, a group of 6, so 2
#: heads a CTA): Tq != Tk causal and not, T = 1, a query tile cut at 150,
#: groups of 6, 3, 2 and 1
d128_edge_cases = functools.partial(head_dim_edge_cases, d=128, seed=41, shapes=(
    (1, 12, 2, 150, 97, True), (2, 12, 2, 150, 201, False),
    (1, 12, 2, 40, 72, True), (1, 12, 2, 72, 40, True), (2, 12, 2, 1, 1, True),
    (1, 6, 2, 130, 130, True), (1, 6, 3, 33, 33, True), (1, 6, 6, 100, 100, True)))


def flash_phase(lm: dict, device, reps: int, edge_cases=flash_edge_cases) -> dict:
    """Phase 11 on phase 10's longest prefill, and phase 15 on gemma3-1b's
    (``edge_cases=d256_edge_cases``): each flash layer's real q, k, v (B
    4, T 1024; H 32, Hkv 8, D 64 at llama3.2-1b; H 4, Hkv 1, D 256 on
    gemma3-1b's global layers), the kernel against its plain version in
    float32 and on bfloat16 copies, a repeat bitwise equal; edge cases;
    per call at the first flash layer's inputs the kernel's, the plain
    version's and ``scaled_dot_product_attention``'s time (on K/V repeated
    to H heads, and with ``enable_gqa``; SDPA's ``is_causal`` is top-left
    too, and both are held to the plain version), the bound, and the
    kernel's time summed over every flash layer of the wave."""
    layers = capture_flash(lm["model"], lm["params"], lm["tokens"], lm["max_seq"], device)
    err = {"f32": 0.0, "bf16": 0.0}
    for i, (q, k, v) in enumerate(layers):
        shape = f"layer {i} q {tuple(q.shape)} k {tuple(k.shape)}"
        err["f32"] = max(err["f32"], check_flash(shape, q, k, v, True, device))
        err["bf16"] = max(err["bf16"], check_flash(
            shape + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), True,
            device, FLASH_BF16_TOL))
    edge = edge_cases(device)
    q, k, v = layers[0]
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    groups = h // hkv
    kr, vr = (x.repeat_interleave(groups, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    want = flash_attention_ref(q, k, v, causal=True)
    lib_err = max(float((sdpa(q, k, v, is_causal=True, enable_gqa=True) - want).abs().max()),
                  float((sdpa(q, kr, vr, is_causal=True) - want).abs().max()))
    if not lib_err <= TOL:
        raise AssertionError(f"scaled_dot_product_attention disagrees: {lib_err}")
    row = {"B": b, "H": h, "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d, "causal": True,
           "layers": len(layers), "library_max_abs_err": lib_err}
    # each call keeps the card busy ~0.6-2.7 ms, far longer than its launch
    # takes: CUDA events (profiler windows over 10 back-to-back kernel
    # launches recorded 0, 8 and 7 of them on an H100)
    row.update(timings({
        "": lambda: flash_attention(q, k, v, causal=True),
        "plain_": lambda: flash_attention_ref(q, k, v, causal=True),
        "library_": lambda: sdpa(q, kr, vr, is_causal=True),
        "library_enable_gqa_": lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
    }, device, reps))
    row["vs_library"] = row["ms"] / row["library_ms"]
    row.update(flash_bound(b, h, hkv, tq, tk, d, True, q.element_size()))
    row["wave_ms"] = sum(time_ms(lambda a=a: flash_attention(*a, causal=True), device,
                                 reps, warmup=1) for a in layers)
    print("[kernel] flash_attention " + json.dumps(row))
    return {"row": row, "err": err, "edge": edge}


def flash_entry(fa: dict) -> dict:
    """The kernels line's ``flash_attention`` entry: one call at the
    captured shape (layer 0 of the longest prefill)."""
    row = fa["row"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"][0],
        "replaces": SOURCES["flash_attention"][1], "launches": 0,
        "max_abs_err": max(fa["err"]["f32"], fa["edge"]["f32"]),
        "bf16_max_abs_err": max(fa["err"]["bf16"], fa["edge"]["bf16"]),
        "ms": row["ms"], "ms_by": row["ms_by"], "wall_ms": row["wall_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) "
                   "on K/V repeated to H heads beforehand",
        "library_enable_gqa_ms": row["library_enable_gqa_ms"],
        "vs_library": row["vs_library"],
        "wave_ms": row["wave_ms"],
        "shape": f"one call at layer 0's prefill inputs: B {row['B']}, H {row['H']}, "
                 f"Hkv {row['Hkv']}, T {row['Tq']}, D {row['D']}, causal, float32; "
                 f"wave_ms the kernel over all {row['layers']} layers (CUDA events)",
    }


#: phase 16: AdamW over warmup_cosine(LM_LR, LM_WARMUP, steps), at the JAX
#: launcher's default peak rate with a 2-step warmup, so the loss falls
#: within the run's steps on its one batch
LM_LR, LM_WARMUP = 3e-4, 2
#: the cuda program (fused Adam) against the torch program (plain Adam):
#: both run the same bfloat16 forward and backward on the card, so they
#: part only where the two Adams round differently and a weight that moves
#: by it crosses a bfloat16 rounding edge in a later step's cast. Losses
#: at every step within LM_LOSS_RTOL relative; after the last step each
#: leaf's parameters within LM_PARAM_RTOL (norm of the difference over the
#: leaf's norm), a bound that a weight whose gradient is within rounding of
#: 0, where Adam's normalised step may take either sign, cannot pass alone
LM_LOSS_RTOL = 1e-3
LM_PARAM_RTOL = 1e-2


def lm_train_run(model, opt, params, batch, steps: int, device) -> dict:
    """``steps`` steps of ``make_train_step(model, opt)`` (bfloat16
    compute, the JAX default) over one batch from ``params``: per step
    the loss, the synchronised host ms and the port's launches."""
    step = make_train_step(model, opt)
    state = opt.init(params)
    losses, ms, launched = [], [], []
    for _ in range(steps):
        sync(device)
        before = counts()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        launched.append({k: v - before[k] for k, v in counts().items()})
    return {"params": params, "state": state, "step": step, "losses": losses,
            "ms": ms, "launched": launched}


def lm_adam_row(params, device, reps: int, arch: str) -> dict:
    """``fused_adam_multi`` over the LM's leaves (the trained weights,
    random gradients and moments, weight decay 0.01): one launch for
    every ``CAPACITY`` leaves, each
    leaf within ADAM_TOL of the plain version; the kernel's CUDA-event ms
    (a call keeps the card busy ~10 ms, far longer than its launch), the
    plain version's, ``torch.optim.AdamW(fused=True)``'s step on the same
    leaves (in place, last) and the bound, 28 bytes a parameter over the
    card's memory rate."""
    gen = torch.Generator(device=device).manual_seed(17)
    ps = [p.detach() for p in tree_leaves(params)]
    gs = [torch.randn(p.shape, generator=gen, device=device) for p in ps]
    ms = [0.1 * torch.randn(p.shape, generator=gen, device=device) for p in ps]
    vs = [0.01 * torch.rand(p.shape, generator=gen, device=device) for p in ps]
    lr_t = bias_corrected_lr(LM_LR, 0.9, 0.999, 3)
    before = fused_adam.launches
    out = fused_adam_multi(ps, gs, ms, vs, lr_t, weight_decay=0.01)
    sync(device)
    want = -(-len(ps) // CAPACITY) if device.type == "cuda" else 0
    if fused_adam.launches - before != want:
        raise AssertionError(f"fused_adam over the LM's {len(ps)} leaves: "
                             f"{fused_adam.launches - before} launches, expected {want}")
    err = 0.0
    for i, leaf in enumerate(zip(ps, gs, ms, vs)):
        ref = fused_adam_ref(*leaf, lr_t, 0.9, 0.999, 1e-8, 0.01)
        for a, r in zip((o[i] for o in out), ref):
            err = max(err, check_close(f"fused_adam LM leaf {i} {tuple(r.shape)}",
                                       a, r, ADAM_TOL))
        # each leaf's outputs and plain version freed once checked: the
        # pixtral-12b cut's 2.5 GiB embedding leaves would not fit twice
        del ref
        for o in out:
            o[i] = None
    del out
    n = int(sum(p.numel() for p in ps))
    row = {"kernel": "fused_adam", "leaves_of": f"{arch} training step",
           "leaves": len(ps), "params": n, "max_abs_err": err}
    row.update(timings({
        "": lambda: fused_adam_multi(ps, gs, ms, vs, lr_t, weight_decay=0.01),
        "plain_": lambda: [fused_adam_ref(*leaf, lr_t, 0.9, 0.999, 1e-8, 0.01)
                           for leaf in zip(ps, gs, ms, vs)]}, device, reps))
    del ms, vs
    lib_params = [p.requires_grad_(True) for p in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g
    lib = torch.optim.AdamW(lib_params, lr=LM_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=device.type == "cuda")
    row.update(timings({"library_": lib.step}, device, reps))
    row["library"] = "torch.optim.AdamW(fused=True).step on the same leaves"
    row.update({"bytes": 28 * n, "flop": 15.0 * n})
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flop"])
    print("[lm-train] adam " + json.dumps(row))
    return row


def first_step_grads(model, params, batch) -> list:
    """The loss and every leaf's gradient of one training step's backward,
    as ``make_train_step`` takes it (the float32 leaves cast to bfloat16
    inside the loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    cast = [p.to(torch.bfloat16) for p in leaves]
    loss, _ = model.loss(tree_unflatten(params, cast), batch)
    return [loss.detach(), *torch.autograd.grad(loss, leaves)]


def repeats_bitwise(model, params, batch) -> int:
    """Two runs of the first step's backward from the same weights and
    batch: the loss and every gradient bitwise equal (the MoE's dispatch
    and combine sum in a fixed order); the number of tensors compared."""
    first = first_step_grads(model, params, batch)
    again = first_step_grads(model, params, batch)
    for i, (a, b) in enumerate(zip(first, again)):
        if not torch.equal(a, b):
            raise AssertionError(f"LM training: {'the loss' if i == 0 else f'gradient {i - 1}'}"
                                 " of two runs of the first step is not bitwise equal")
    return len(first)


def lm_training_phase(cfg, sizes: Sizes, device) -> dict:
    """Phases 16, 20 (d) and 21 (e), LM training: ``make_train_step(build_model(cfg,
    remat="layer"), adamw(warmup_cosine(LM_LR, LM_WARMUP, steps),
    fused=True))`` at bfloat16 compute over one fixed ``make_dummy_batch``
    of lm_train_batch x lm_train_seq tokens, random weights from a seeded
    generator on the card; counts zeroed just before the steps and read
    after them: exactly one ``fused_adam`` launch a step for every
    ``CAPACITY`` leaves (one up to 48; xlstm-1.3b's 86 take two) and no
    other kernel of the port, finite losses that fall. Then the ``torch``
    program (plain Adam) from the same weights and batch, after the first
    program's optimizer state is freed: losses within LM_LOSS_RTOL at
    every step, parameters within LM_PARAM_RTOL a leaf. The step's
    synchronised ms, tokens/s, the run's peak memory, a profiled step by
    kernel class (not with sLSTM blocks: xlstm-1.3b's step launches ~30
    kernels a time step of its sLSTM loop, forward, recomputed and
    backward), and the Adam launch on the LM's leaves (``lm_adam_row``).
    First, two runs of the first step's backward, bitwise equal
    (``repeats_bitwise``)."""
    steps = sizes.lm_train_steps
    sched = warmup_cosine(LM_LR, LM_WARMUP, steps)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, inner="cuda", remat="layer")
    init = model.init(gen, device=device)
    batch = make_dummy_batch(cfg, sizes.lm_train_batch, sizes.lm_train_seq,
                             generator=torch.Generator(device=device).manual_seed(1))
    n_params = sum(t.numel() for t in tree_leaves(init))
    tokens = batch["tokens"].numel()
    print(f"[lm-train] {cfg.name}: {n_params:,} parameters in "
          f"{len(tree_leaves(init))} leaves, batch {tuple(batch['tokens'].shape)}, "
          f"{steps} steps of AdamW(warmup_cosine({LM_LR}, {LM_WARMUP}, {steps}))")
    repeated = repeats_bitwise(model, init, batch)
    print(f"[lm-train] two runs of the first step: the loss and all "
          f"{repeated - 1} gradients bitwise equal")
    mem_before = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    run = lm_train_run(model, adamw(sched, fused=True), init, batch, steps, device)
    launched = counts()
    peak_abs = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = peak_abs - mem_before
    want = {name: 0 for name in KERNELS}
    # one launch a step for every CAPACITY leaves (xlstm-1.3b's 86 take 2)
    want["fused_adam"] = -(-len(tree_leaves(init)) // CAPACITY) if on_card else 0
    for i, got in enumerate(run["launched"]):
        if got != want:
            raise AssertionError(f"LM training step {i}: launches {got}, expected {want}")
    if launched["fused_adam"] != steps * want["fused_adam"] \
            or sum(launched.values()) != launched["fused_adam"]:
        raise AssertionError(f"LM training launched {launched} in {steps} steps")
    losses = run["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"LM training losses do not fall: {losses}")
    median_ms = float(np.median(run["ms"]))
    profile = (epoch_profile(lambda: run["step"](run["params"], run["state"], batch),
                             device, median_ms / 1e3, {"fused_adam": want["fused_adam"]})
               if "slstm" not in cfg.blocks else {"complete": False, "skipped": True})
    params, step_ms = run["params"], run["ms"]
    del run
    free_card(device)  # a collection first: reference cycles may hold tensors

    ref_model = build_model(cfg, inner="torch", remat="layer")
    ref = lm_train_run(ref_model, adamw(sched), init, batch, steps, device)
    if sum(sum(c.values()) for c in ref["launched"]) != 0:
        raise AssertionError("the torch LM training program launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    if not max(rel) <= LM_LOSS_RTOL:
        raise AssertionError(f"LM training losses part: {losses} vs {ref['losses']}")
    param_rel = [float(torch.linalg.vector_norm((a - b).float())
                       / torch.linalg.vector_norm(b.float()))
                 for a, b in zip(tree_leaves(params), tree_leaves(ref["params"]))]
    if not max(param_rel) <= LM_PARAM_RTOL:
        raise AssertionError(f"LM training parameters part by {max(param_rel)} "
                             f"> {LM_PARAM_RTOL}")
    print(f"[lm-train] cuda vs torch (plain Adam): losses within {max(rel):.3g} "
          f"relative at every step, parameters within {max(param_rel):.3g} a leaf")
    ref_losses, ref_ms = ref["losses"], float(np.median(ref["ms"]))
    del ref, init
    free_card(device)  # a collection first: reference cycles may hold tensors
    if on_card:
        print(f"[lm-train] {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated "
              "before the Adam row")
    adam_row = lm_adam_row(params, device, reps=5, arch=cfg.name)
    del params
    free_card(device)  # a collection first: reference cycles may hold tensors
    out = {
        "arch": cfg.name, "n_params": n_params, "batch": sizes.lm_train_batch,
        "seq": sizes.lm_train_seq, "steps": steps, "losses": losses,
        "ref_losses": ref_losses, "max_rel_diff": max(rel),
        "param_max_rel_diff": max(param_rel), "param_rel_diff": param_rel,
        "launches": launched, "step_ms": step_ms, "step_ms_median": median_ms,
        "ref_step_ms_median": ref_ms,
        "tokens_per_s": tokens / (median_ms / 1e3), "peak_mem_bytes": peak,
        "peak_abs_bytes": peak_abs,
        "profile": profile, "adam": adam_row, "first_step_tensors_bitwise": repeated,
    }
    print("[lm-train] " + json.dumps(out))
    return out


def gemma_and_training(sizes: Sizes, device) -> dict:
    """Phases 15 and 16: gemma3-1b served (its windows; the flash kernel at
    D = 256 on its global layers, checked and timed on the wave's inputs),
    then llama3.2-1b trained. Reduced configs where ``lm_reduced`` (gemma
    with 6 layers, so that one is global)."""
    phase_s = {}
    t0 = time.perf_counter()
    gcfg = get_config("gemma3-1b")
    if sizes.lm_reduced:
        gcfg = dataclasses.replace(gcfg.reduced(), n_layers=6)
    gemma = lm_serving_phase(gcfg, sizes, device)
    gfa = flash_phase(gemma, device, reps=10, edge_cases=d256_edge_cases)
    del gemma["model"], gemma["params"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase_s["15"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tcfg = get_config("llama3.2-1b")
    train = lm_training_phase(tcfg.reduced() if sizes.lm_reduced else tcfg, sizes,
                              device)
    phase_s["16"] = time.perf_counter() - t0
    return {"gemma": gemma["summary"], "gemma_flash": gfa, "lm_train": train,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# Phase 20: the MoE family (mixture of experts, MLA, multi-token prediction)
# ---------------------------------------------------------------------------

#: phase 20 (d): the training cut's routed experts, half the 64 of the
#: width cut it stands for: with 64 the out-of-place AdamW update alone
#: holds 28 bytes a parameter (weights, gradients, both moments and the
#: three new tensors), 72 GiB of 2.77 B parameters, past the 70 GiB the
#: phase may take
MOE_TRAIN_EXPERTS = 32


def moe_configs(sizes: Sizes) -> dict:
    """Phase 20's configurations, each cut as PERF.md §4 states: dbrx-132b
    and deepseek-v3-671b served at their published widths, cut in depth
    (dbrx 40 -> 2 layers, one scanned segment of 2; deepseek 61 -> 2, one
    dense layer then one MoE layer of all 256 experts, ``mtp_depth`` 1 ->
    0, which serving never reads), and deepseek-v3-671b trained at a width
    cut (d_model 2,048, 16 heads, vocab 32,768, 3 layers: one dense, then
    a scanned segment of 2 MoE layers of ``MOE_TRAIN_EXPERTS`` experts;
    the MLA ranks, the expert and dense FFN widths, top-8, the shared
    expert and ``mtp_depth`` 1 as published). The reduced configs take the
    same depth cuts where ``lm_reduced``."""
    dbrx, ds = get_config("dbrx-132b"), get_config("deepseek-v3-671b")
    if sizes.lm_reduced:
        dbrx, ds = dbrx.reduced(), ds.reduced()
    train = dataclasses.replace(ds, name=ds.name + "-train-cut", n_layers=3,
                                first_k_dense_layers=1)
    if not sizes.lm_reduced:
        train = dataclasses.replace(
            train, d_model=2048, n_heads=16, n_kv_heads=16, vocab_size=32768,
            moe=dataclasses.replace(ds.moe, n_experts=MOE_TRAIN_EXPERTS))
    return {"dbrx": dataclasses.replace(dbrx, n_layers=2),
            "deepseek": dataclasses.replace(ds, n_layers=2, first_k_dense_layers=1,
                                            mtp_depth=0),
            "train": train}


def free_card(device) -> None:
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def latent_cache_bytes(model, cfg, sizes: Sizes, device) -> dict:
    """MLA's cache for the engine's slots and positions (float32, the
    engine's dtype), allocated and measured, beside what a full K/V cache
    of the same positions and heads would take (K at qk_nope + qk_rope, V
    at v_head_dim a head, computed)."""
    max_seq = sizes.lm_prompts[1] + sizes.lm_new_tokens
    cache = model.init_cache(sizes.lm_slots, max_seq, dtype=torch.float32, device=device)
    latent = sum(layer["attn"]["latent"].numel() * 4
                 for seg in cache["segments"] for layer in seg)
    m = cfg.mla
    full = (cfg.n_layers * sizes.lm_slots * max_seq * cfg.n_heads
            * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 4)
    return {"latent_bytes": latent, "full_kv_bytes": full, "ratio": full / latent,
            "slots": sizes.lm_slots, "positions": max_seq}


def moe_phase(sizes: Sizes, device) -> dict:
    """Phase 20, the MoE family on the card, after everything earlier
    phases held is freed: (a) dbrx-132b served (``lm_serving_phase``:
    flash at D = 128 twice a wave, the routing rule of ``ROUTE_MARGIN``),
    (b) flash at D = 128 on (a)'s wave (``flash_phase`` with
    ``d128_edge_cases``), (c) deepseek-v3-671b served (MLA: no kernel of
    the port) and its latent cache's bytes, (d) the training cut trained
    (``lm_training_phase``: one Adam launch a step, the first step's
    backward bitwise twice). Each part's peak allocation; the phase's
    seconds by part."""
    on_card = device.type == "cuda"
    free_card(device)
    held = torch.cuda.memory_allocated(device) if on_card else 0
    print(f"[moe] phase 20: {held / 2**30:.2f} GiB still allocated by phases 2-19")
    cfgs = moe_configs(sizes)
    phase_s = {}
    t0 = time.perf_counter()
    dbrx = lm_serving_phase(cfgs["dbrx"], sizes, device)
    phase_s["20a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbrx_flash = flash_phase(dbrx, device, reps=10, edge_cases=d128_edge_cases)
    phase_s["20b"] = time.perf_counter() - t0
    del dbrx["model"], dbrx["params"], dbrx["tokens"]
    free_card(device)
    t0 = time.perf_counter()
    ds = lm_serving_phase(cfgs["deepseek"], sizes, device)
    ds["summary"]["latent_cache"] = latent_cache_bytes(ds["model"], cfgs["deepseek"],
                                                       sizes, device)
    print(f"[moe] deepseek latent cache: {json.dumps(ds['summary']['latent_cache'])}")
    phase_s["20c"] = time.perf_counter() - t0
    del ds["model"], ds["params"], ds["tokens"]
    free_card(device)
    t0 = time.perf_counter()
    train = lm_training_phase(cfgs["train"], sizes, device)
    phase_s["20d"] = time.perf_counter() - t0
    free_card(device)
    peaks = {"dbrx": dbrx["summary"]["peak_abs_bytes"],
             "deepseek": ds["summary"]["peak_abs_bytes"],
             "train": train["peak_abs_bytes"]}
    print(f"[moe] phase 20 peaks (GiB, allocated): "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in peaks.items())
          + f"; seconds: {json.dumps(phase_s)}")
    return {"dbrx": dbrx["summary"], "dbrx_flash": dbrx_flash,
            "deepseek": ds["summary"], "train": train, "held_before_bytes": held,
            "peaks": peaks, "phase_s": phase_s}


def moe_entries(entries: list, p20: dict) -> None:
    """Phase 20 beside its kernels' entries: its three paths' launches
    (``launches`` and ``launches_by_path``), the flash call at dbrx-132b's
    D = 128 (one call at its first layer's inputs, CUDA events;
    ``max_abs_err`` over every width), and the Adam launch over the
    training cut's leaves."""
    by_name = {e["name"]: e for e in entries}
    for path, launched in (("lm_serving_dbrx", p20["dbrx"]["launches"]),
                           ("lm_serving_deepseek", p20["deepseek"]["launches"]),
                           ("lm_training_moe", p20["train"]["launches"])):
        for e in entries:
            e["launches_by_path"][path] = launched[e["name"]]
            e["launches"] += launched[e["name"]]
    g = p20["dbrx_flash"]
    row = g["row"]
    flash = by_name["flash_attention"]
    flash["max_abs_err"] = max(flash["max_abs_err"], g["err"]["f32"], g["edge"]["f32"])
    flash["bf16_max_abs_err"] = max(flash.get("bf16_max_abs_err", 0.0), g["err"]["bf16"],
                                    g["edge"]["bf16"])
    flash["dbrx_d128"] = {
        **{k: row[k] for k in ("ms", "ms_by", "wall_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_enable_gqa_ms",
                               "vs_library", "wave_ms")},
        "max_abs_err": max(g["err"]["f32"], g["edge"]["f32"]),
        "launches_a_wave": p20["dbrx"]["flash_per_wave"],
        "shape": f"one call at layer 0's prefill inputs: B {row['B']}, H {row['H']}, "
                 f"Hkv {row['Hkv']}, T {row['Tq']}, D {row['D']}, causal, float32; "
                 f"wave_ms the kernel over all {row['layers']} layers"}
    t = p20["train"]
    a = t["adam"]
    adam = by_name["fused_adam"]
    adam["max_abs_err"] = max(adam["max_abs_err"], a["max_abs_err"])
    adam["moe_step"] = {
        **{k: a[k] for k in ("ms", "ms_by", "plain_ms", "library_ms", "library",
                             "bound_ms", "bound_by", "params", "leaves")},
        "profiled_step_ms": (t["profile"]["device_ms"].get("fused_adam")
                             if t["profile"]["complete"] else None),
        "launches_a_step": t["launches"]["fused_adam"] / t["steps"],
        "shape": f"one launch over {t['arch']}'s {a['leaves']} leaves "
                 f"({a['params']:,} values, stacked experts among them): ms by CUDA "
                 "events; profiled_step_ms its device time inside a profiled step"}


# ---------------------------------------------------------------------------
# Phase 21: Mamba2/SSD with Zamba2's shared block, and xLSTM
# ---------------------------------------------------------------------------

#: phase 21 (d): a whole prefill's last logits against those of a prefill
#: to T - CHUNK_STEPS and CHUNK_STEPS decode steps, within the JAX suite's
#: bound for decode against forward (tests/test_models_components.py:56-81)
CHUNK_TOL = 2e-2
CHUNK_STEPS = 4
#: phase 21 (e): xlstm-1.3b trained on lm_train_batch x HYBRID_TRAIN_SEQ
#: tokens for HYBRID_TRAIN_STEPS steps, cut from phase 16's 1,024 and 10:
#: the sLSTM loop's eager launches make a 1,024-token step ~23 s (PERF.md
#: §4); 256 is two of xlstm-1.3b's mLSTM chunks (128), so the state
#: carried between chunks is trained on the card (a 256-token step took
#: 5.8 s)
HYBRID_TRAIN_SEQ = 256
HYBRID_TRAIN_STEPS = 2

#: the D = 112 kernel (zamba2-7b's shared block: H 32 over 32 KV heads, so
#: 1 head a CTA) on ``d128_edge_cases``' shapes: Tq != Tk causal and not,
#: T = 1, a query tile cut at 150, KV groups of 6, 3, 2 and 1
d112_edge_cases = functools.partial(head_dim_edge_cases, d=112, seed=43,
                                    shapes=d128_edge_cases.keywords["shapes"])


def hybrid_configs(sizes: Sizes) -> dict:
    """Phase 21's configurations, at their published widths and depths:
    zamba2-7b (81 layers: 68 Mamba2 blocks, 13 shared sites) and
    xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM); their reduced configs where
    ``lm_reduced``."""
    zamba, xl = get_config("zamba2-7b"), get_config("xlstm-1.3b")
    if sizes.lm_reduced:
        zamba, xl = zamba.reduced(), xl.reduced()
    return {"zamba2": zamba, "xlstm": xl}


def block_times(model, params, tokens, max_seq: int, device) -> dict:
    """One prefill of ``tokens`` with each recurrent block timed
    (synchronised host clock; measurement only: the transformer's table of
    recurrent blocks is wrapped for this call): ms by block kind, the
    whole prefill's ms, and each kind's share of it."""
    table = transformer_mod._RECURRENT
    saved = dict(table)
    spent = defaultdict(float)

    def timed(kind, fn):
        def call(*args, **kw):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(device)
            spent[kind] += time.perf_counter() - t0
            return out
        return call

    table.update({kind: timed(kind, fn) for kind, fn in saved.items()})
    try:
        cache = model.init_cache(tokens.shape[0], max_seq, dtype=torch.float32,
                                 device=device)
        sync(device)
        t0 = time.perf_counter()
        model.prefill(params, tokens, cache)
        sync(device)
        total = time.perf_counter() - t0
    finally:
        table.update(saved)
    out = {"prefill_ms": total * 1e3, "tokens": list(tokens.shape),
           "ms_by_kind": {k: v * 1e3 for k, v in spent.items()},
           "share": {k: v / total for k, v in spent.items()}}
    print(f"[hybrid] a {tuple(tokens.shape)} prefill by block: {json.dumps(out)}")
    return out


def chunked_vs_recurrent(name: str, model, params, tokens, max_seq: int, device) -> dict:
    """The last logits of a whole prefill of ``tokens`` [B, T] against a
    prefill of the first T - CHUNK_STEPS tokens (the chunked forms) and
    CHUNK_STEPS decode steps over the rest (the recurrences), through the
    cuda model: finite, within CHUNK_TOL."""
    b, t = tokens.shape

    def cache():
        return model.init_cache(b, max_seq, dtype=torch.float32, device=device)

    want, _ = model.prefill(params, tokens, cache())
    got, c = model.prefill(params, tokens[:, :t - CHUNK_STEPS], cache())
    for i in range(t - CHUNK_STEPS, t):
        got, c = model.decode_step(params, c, tokens[:, i:i + 1])
    sync(device)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: chunked or recurrent logits not finite")
    diff = float((got - want).abs().max())
    if not diff <= CHUNK_TOL:
        raise AssertionError(f"{name}: chunked against recurrent logits differ by "
                             f"{diff} > {CHUNK_TOL}")
    print(f"[hybrid] {name}: a {t}-token prefill against {t - CHUNK_STEPS} prefilled and "
          f"{CHUNK_STEPS} decoded: last logits within {diff:.3g} (bound {CHUNK_TOL}; "
          f"largest |logit| {float(want.abs().max()):.3g})")
    return {"max_abs_diff": diff, "tokens": [b, t], "decode_steps": CHUNK_STEPS,
            "max_abs_logit": float(want.abs().max())}


def hybrid_phase(sizes: Sizes, device) -> dict:
    """Phase 21, the recurrent families on the card, after everything
    earlier phases held is freed: (a) zamba2-7b served
    (``lm_serving_phase``: flash at D = 112 at each of its 13 shared sites
    a wave) and its longest prefill timed by block kind; (b) flash at D =
    112 on (a)'s wave (``flash_phase`` with ``d112_edge_cases``); (c)
    xlstm-1.3b served (no kernel of the port) and its longest prefill
    timed by block kind, the sLSTM loop's share among them; (d) for both,
    chunked against recurrent on the longest wave; (e) xlstm-1.3b trained
    (``lm_training_phase``: two Adam launches a step, its 86 leaves in two
    tables, the first step's backward bitwise twice) on HYBRID_TRAIN_SEQ
    tokens a row for HYBRID_TRAIN_STEPS steps. Each part's peak
    allocation; the phase's seconds by part."""
    on_card = device.type == "cuda"
    free_card(device)
    held = torch.cuda.memory_allocated(device) if on_card else 0
    print(f"[hybrid] phase 21: {held / 2**30:.2f} GiB still allocated by earlier phases")
    cfgs = hybrid_configs(sizes)
    phase_s = {"21d": 0.0}
    t0 = time.perf_counter()
    zamba = lm_serving_phase(cfgs["zamba2"], sizes, device)
    zamba["summary"]["blocks"] = block_times(zamba["model"], zamba["params"],
                                             zamba["tokens"], zamba["max_seq"], device)
    phase_s["21a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zamba_flash = flash_phase(zamba, device, reps=10, edge_cases=d112_edge_cases)
    phase_s["21b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = {"zamba2": chunked_vs_recurrent(cfgs["zamba2"].name, zamba["model"],
                                              zamba["params"], zamba["tokens"],
                                              zamba["max_seq"], device)}
    phase_s["21d"] += time.perf_counter() - t0
    del zamba["model"], zamba["params"], zamba["tokens"]
    free_card(device)
    t0 = time.perf_counter()
    xl = lm_serving_phase(cfgs["xlstm"], sizes, device)
    xl["summary"]["blocks"] = block_times(xl["model"], xl["params"], xl["tokens"],
                                          xl["max_seq"], device)
    phase_s["21c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked["xlstm"] = chunked_vs_recurrent(cfgs["xlstm"].name, xl["model"], xl["params"],
                                            xl["tokens"], xl["max_seq"], device)
    phase_s["21d"] += time.perf_counter() - t0
    del xl["model"], xl["params"], xl["tokens"]
    free_card(device)
    t0 = time.perf_counter()
    train_sizes = dataclasses.replace(
        sizes, lm_train_seq=min(sizes.lm_train_seq, HYBRID_TRAIN_SEQ),
        lm_train_steps=min(sizes.lm_train_steps, HYBRID_TRAIN_STEPS))
    train = lm_training_phase(cfgs["xlstm"], train_sizes, device)
    phase_s["21e"] = time.perf_counter() - t0
    free_card(device)
    peaks = {"zamba2": zamba["summary"]["peak_abs_bytes"],
             "xlstm": xl["summary"]["peak_abs_bytes"], "train": train["peak_abs_bytes"]}
    print(f"[hybrid] phase 21 peaks (GiB, allocated): "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in peaks.items())
          + f"; seconds: {json.dumps(phase_s)}")
    return {"zamba2": zamba["summary"], "zamba2_flash": zamba_flash,
            "xlstm": xl["summary"], "chunked": chunked, "train": train,
            "held_before_bytes": held, "peaks": peaks, "phase_s": phase_s}


def hybrid_entries(entries: list, p21: dict) -> None:
    """Phase 21 beside its kernels' entries: its three paths' launches, the
    flash call at zamba2-7b's D = 112 (one call at its first shared site's
    inputs, CUDA events; ``max_abs_err`` over every width), and the Adam
    launch over xlstm-1.3b's leaves."""
    by_name = {e["name"]: e for e in entries}
    for path, launched in (("lm_serving_zamba2", p21["zamba2"]["launches"]),
                           ("lm_serving_xlstm", p21["xlstm"]["launches"]),
                           ("lm_training_xlstm", p21["train"]["launches"])):
        for e in entries:
            e["launches_by_path"][path] = launched[e["name"]]
            e["launches"] += launched[e["name"]]
    g = p21["zamba2_flash"]
    row = g["row"]
    flash = by_name["flash_attention"]
    flash["max_abs_err"] = max(flash["max_abs_err"], g["err"]["f32"], g["edge"]["f32"])
    flash["bf16_max_abs_err"] = max(flash.get("bf16_max_abs_err", 0.0), g["err"]["bf16"],
                                    g["edge"]["bf16"])
    flash["zamba2_d112"] = {
        **{k: row[k] for k in ("ms", "ms_by", "wall_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_enable_gqa_ms",
                               "vs_library", "wave_ms")},
        "max_abs_err": max(g["err"]["f32"], g["edge"]["f32"]),
        "launches_a_wave": p21["zamba2"]["flash_per_wave"],
        "shape": f"one call at the first shared site's prefill inputs: B {row['B']}, "
                 f"H {row['H']}, Hkv {row['Hkv']}, T {row['Tq']}, D {row['D']}, causal, "
                 f"float32; wave_ms the kernel over all {row['layers']} shared sites"}
    t = p21["train"]
    a = t["adam"]
    adam = by_name["fused_adam"]
    adam["max_abs_err"] = max(adam["max_abs_err"], a["max_abs_err"])
    adam["xlstm_step"] = {
        **{k: a[k] for k in ("ms", "ms_by", "plain_ms", "library_ms", "library",
                             "bound_ms", "bound_by", "params", "leaves")},
        "launches_a_step": t["launches"]["fused_adam"] / t["steps"],
        "shape": f"one launch over {t['arch']}'s {a['leaves']} leaves "
                 f"({a['params']:,} values): ms by CUDA events"}


# ---------------------------------------------------------------------------
# Phase 22: the encoder-decoder, cross attention and the vision frontend
# ---------------------------------------------------------------------------

#: phase 22 (d): pixtral-12b trained cut to PIXTRAL_TRAIN_LAYERS layers at
#: its published widths (1,887,457,280 parameters, ~30 GB at 16 bytes a
#: parameter: its 40 layers would take 196 GB) for PIXTRAL_TRAIN_STEPS
#: steps of 4 x (256 + 768) tokens
PIXTRAL_TRAIN_LAYERS = 2
PIXTRAL_TRAIN_STEPS = 2


def encdec_configs(sizes: Sizes) -> dict:
    """Phase 22's configurations: whisper-tiny (4 encoder and 4 decoder
    layers, 1,500 frames) and pixtral-12b (40 layers, 256 frontend
    tokens) at their published sizes, and pixtral-12b's training cut to
    PIXTRAL_TRAIN_LAYERS layers; their reduced configs where
    ``lm_reduced``."""
    whisper, pixtral = get_config("whisper-tiny"), get_config("pixtral-12b")
    if sizes.lm_reduced:
        whisper, pixtral = whisper.reduced(), pixtral.reduced()
    return {"whisper": whisper, "pixtral": pixtral,
            "pixtral_train": dataclasses.replace(pixtral, name=pixtral.name + "-train-cut",
                                                 n_layers=PIXTRAL_TRAIN_LAYERS)}


def prefill_flash_launches(cfg, frames: bool) -> int:
    """Flash launches a prefill: ``flash_layers``' (whisper's self and cross
    attention over the cache's encoder output), and with encoder frames one
    more for each encoder layer."""
    return flash_layers(cfg) + (cfg.n_encoder_layers if frames else 0)


def frontend_inputs(cfg, batch: int, device) -> dict:
    """The stub frontends' inputs for ``batch`` rows, standard normal from a
    seeded generator on ``device``: pixtral's patch embeddings [B, 256,
    D], whisper's frame embeddings [B, 1,500, D]."""
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                                             generator=gen, device=device)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                            generator=gen, device=device)
    return out


def drive_wave(model, params, tokens, inputs: dict, max_seq: int, steps: int, device,
               feed: "list | None" = None) -> list:
    """One wave through ``make_prefill_step`` (the prompt ``tokens`` with
    ``inputs``) and ``steps`` greedy steps of ``make_decode_step`` (the
    argmax, or ``feed``'s tokens: the other program's): per call its
    kind, token input, last-position logits, synchronised seconds and
    flash launches."""
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    cache = model.init_cache(tokens.shape[0], max_seq, dtype=torch.float32, device=device)
    calls = []

    def call(kind, fn, toks):
        sync(device)
        before = flash_attention.launches
        t0 = time.perf_counter()
        logits, new_cache = fn()
        sync(device)
        calls.append({"kind": kind, "tokens": toks, "logits": logits.clone(),
                      "s": time.perf_counter() - t0,
                      "flash": flash_attention.launches - before})
        return logits, new_cache

    logits, cache = call("prefill", lambda: prefill(params, tokens, cache, **inputs), tokens)
    for i in range(steps):
        cur = logits.argmax(-1)[:, None] if feed is None else feed[i]
        logits, cache = call("decode", lambda: decode(params, cache, cur), cur)
    del cache
    return calls


def frontend_wave(cfg, model, ref, params, sizes: Sizes, device) -> dict:
    """Phase 22 (a) and (c), one wave with the frontend's inputs: lm_slots
    prompts of lm_prompts[1] random text tokens (after pixtral's 256 patch
    embeddings; with whisper's 1,500 frames) prefilled through
    ``make_prefill_step`` and decoded lm_new_tokens greedy steps through
    ``make_decode_step``, on the cuda model after a two-step warmup;
    counts zeroed just before and read after: exactly
    ``prefill_flash_launches`` flash launches in the prefill, none in
    decode, no other kernel. Then the torch model on the same inputs and
    the cuda program's tokens: logits within TOL at every call, greedy
    tokens equal where the top-2 margin exceeds TOKEN_MARGIN. Prefill ms,
    decode ms a step, tokens/s, the run's peak, and one profiled prefill
    by kernel class."""
    on_card = device.type == "cuda"
    b, t, steps = sizes.lm_slots, sizes.lm_prompts[1], sizes.lm_new_tokens
    inputs = frontend_inputs(cfg, b, device)
    n_front = cfg.n_frontend_tokens if "frontend_embeds" in inputs else 0
    max_seq = n_front + t + steps
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device=device,
                           generator=torch.Generator(device=device).manual_seed(6))
    drive_wave(model, params, tokens, inputs, max_seq, 2, device)  # warmup
    per_prefill = prefill_flash_launches(cfg, "encoder_frames" in inputs) if on_card else 0
    mem_before = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    calls = drive_wave(model, params, tokens, inputs, max_seq, steps, device)
    launched = counts()
    peak_abs = torch.cuda.max_memory_allocated(device) if on_card else 0
    for i, c in enumerate(calls):
        want = per_prefill if c["kind"] == "prefill" else 0
        if c["flash"] != want:
            raise AssertionError(f"{cfg.name}: call {i} ({c['kind']}) launched "
                                 f"flash_attention {c['flash']} times, expected {want}")
    if launched["flash_attention"] != per_prefill \
            or sum(launched.values()) != launched["flash_attention"]:
        raise AssertionError(f"{cfg.name} wave launched {launched}, expected "
                             f"{per_prefill} flash_attention launches and nothing else")
    zero_counts()
    ref_calls = drive_wave(ref, params, tokens, inputs, max_seq, steps, device,
                           feed=[c["tokens"] for c in calls[1:]])
    if sum(counts().values()):
        raise AssertionError(f"the torch program launched {counts()}")
    worst, sure_steps = 0.0, 0
    for i, (c, r) in enumerate(zip(calls, ref_calls)):
        logits, want = c["logits"], r["logits"]
        if logits.shape != (b, cfg.padded_vocab()) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name}: call {i} logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        worst = max(worst, float((logits - want).abs().max()))
        top = torch.topk(logits, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > TOKEN_MARGIN
        sure_steps += int(sure.sum())
        if not torch.equal(logits.argmax(-1)[sure], want.argmax(-1)[sure]):
            raise AssertionError(f"{cfg.name}: greedy tokens differ at call {i} where "
                                 f"the top-2 margin > {TOKEN_MARGIN}")
    if not worst <= TOL:
        raise AssertionError(f"{cfg.name}: cuda vs torch logits differ by {worst} > {TOL}")
    print(f"[encdec] {cfg.name} wave: logits within {worst:.3g} of the torch program at "
          f"all {len(calls)} calls; greedy tokens equal at all {sure_steps} of "
          f"{b * len(calls)} (row, call) pairs whose top-2 margin > {TOKEN_MARGIN}")
    prefill_ms = calls[0]["s"] * 1e3
    decode_ms = float(np.median([c["s"] for c in calls[1:]])) * 1e3
    out = {
        "arch": cfg.name, "batch": b, "text_tokens": t, "frontend_tokens": n_front,
        "encoder_frames": cfg.encoder_seq if "encoder_frames" in inputs else 0,
        "decode_steps": steps, "launches": launched, "flash_per_prefill": per_prefill,
        "max_logit_diff": worst, "token_pairs_compared": sure_steps,
        "prefill_ms": prefill_ms, "ref_prefill_ms": ref_calls[0]["s"] * 1e3,
        "decode_step_ms_median": decode_ms,
        "ref_decode_step_ms_median": float(np.median([c["s"] for c in ref_calls[1:]])) * 1e3,
        "tokens_per_s": b * steps / sum(c["s"] for c in calls[1:]),
        "peak_mem_bytes": peak_abs - mem_before, "peak_abs_bytes": peak_abs,
        "profile_prefill": lm_profile(
            lambda: make_prefill_step(model)(params, tokens, model.init_cache(
                b, max_seq, dtype=torch.float32, device=device), **inputs),
            device, per_prefill, prefill_ms),
    }
    _, filled = make_prefill_step(model)(params, tokens, model.init_cache(
        b, max_seq, dtype=torch.float32, device=device), **inputs)
    cur = calls[0]["logits"].argmax(-1)[:, None]
    out["profile_decode"] = lm_profile(
        lambda: make_decode_step(model)(params, filled, cur), device, 0, decode_ms)
    del filled
    print("[encdec] " + json.dumps(out))
    return {"summary": out, "tokens": tokens, "inputs": inputs, "max_seq": max_seq}


def flash_shape_rows(label: str, layers: list, device, reps: int) -> dict:
    """Phase 22 (b): the flash kernel on captured prefill inputs, grouped by
    kind (``layers``: (kind, q, k, v, causal) each): every call against its
    plain version in float32 and on bfloat16 copies, a repeat bitwise
    equal (``check_flash``); per kind, at its first call's inputs, the
    kernel's, the plain version's and SDPA's CUDA-event ms (K/V repeated
    to H heads, and with ``enable_gqa``), and the bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for kind in dict.fromkeys(k for k, *_ in layers):
        mine = [x for x in layers if x[0] == kind]
        err = {"f32": 0.0, "bf16": 0.0}
        for i, (_, q, k, v, causal) in enumerate(mine):
            shape = f"{label} {kind} {i} q {tuple(q.shape)} k {tuple(k.shape)}"
            err["f32"] = max(err["f32"], check_flash(shape, q, k, v, causal, device))
            err["bf16"] = max(err["bf16"], check_flash(
                shape + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
                device, FLASH_BF16_TOL))
        _, q, k, v, causal = mine[0]
        b, h, tq, d = q.shape
        hkv, tk = k.shape[1], k.shape[2]
        kr, vr = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
        want = flash_attention_ref(q, k, v, causal=causal)
        lib_err = max(float((sdpa(q, kr, vr, is_causal=causal) - want).abs().max()),
                      float((sdpa(q, k, v, is_causal=causal, enable_gqa=True)
                             - want).abs().max()))
        if not lib_err <= TOL:
            raise AssertionError(f"scaled_dot_product_attention disagrees: {lib_err}")
        row = {"B": b, "H": h, "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d, "causal": causal,
               "calls": len(mine), "max_abs_err": err["f32"], "bf16_max_abs_err": err["bf16"],
               "library_max_abs_err": lib_err}
        row.update(timings({
            "": lambda: flash_attention(q, k, v, causal=causal),
            "plain_": lambda: flash_attention_ref(q, k, v, causal=causal),
            "library_": lambda: sdpa(q, kr, vr, is_causal=causal),
            "library_enable_gqa_": lambda: sdpa(q, k, v, is_causal=causal,
                                                enable_gqa=True),
        }, device, reps))
        row["vs_library"] = row["ms"] / row["library_ms"]
        row.update(flash_bound(b, h, hkv, tq, tk, d, causal, q.element_size()))
        print(f"[kernel] flash_attention {label} {kind} " + json.dumps(row))
        rows[f"{label} {kind}"] = row
    return rows


def whisper_flash_kinds(cfg, layers: list) -> list:
    """Whisper's prefill flash calls in launch order, named: the encoder's
    layers first, then each decoder layer's self attention (causal) and
    cross attention."""
    n_enc = cfg.n_encoder_layers
    kinds = ["encoder"] * n_enc + ["self", "cross"] * cfg.n_layers
    if len(layers) != len(kinds):
        raise AssertionError(f"{len(layers)} flash calls in whisper's prefill, "
                             f"expected {len(kinds)}")
    return [(kind, *x) for kind, x in zip(kinds, layers)]


def encdec_phase(sizes: Sizes, device) -> dict:
    """Phase 22, the encoder-decoder and the vision frontend on the card,
    after everything earlier phases held is freed: (a) whisper-tiny, one
    wave with its frames (``frontend_wave``: 12 flash launches, 4 of them
    the encoder's at T 1,500 and 4 the cross attention's at Tq 1,024 x Tk
    1,500, both non-causal), then phase 10's requests through the
    engine (``lm_serving_phase``: text alone, 8 flash launches a wave);
    (b) flash on (a)'s and (c)'s captured prefill inputs
    (``flash_shape_rows``); (c) pixtral-12b, one wave after its 256 patch
    embeddings (40 flash launches, D = 128, causal, T 1,280); (d)
    whisper-tiny and the pixtral-12b cut trained (``lm_training_phase``).
    The cuda and torch programs share one parameter tree a model. Each
    part's peak allocation; the phase's seconds by part."""
    on_card = device.type == "cuda"
    free_card(device)
    held = torch.cuda.memory_allocated(device) if on_card else 0
    print(f"[encdec] phase 22: {held / 2**30:.2f} GiB still allocated by earlier phases")
    cfgs = encdec_configs(sizes)
    phase_s = {"22b": 0.0}
    out = {"held_before_bytes": held, "flash_rows": {}}
    for key, part in (("whisper", "22a"), ("pixtral", "22c")):
        cfg = cfgs[key]
        t0 = time.perf_counter()
        model, ref = build_model(cfg, inner="cuda"), build_model(cfg, inner="torch")
        params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
        sync(device)
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[encdec] {cfg.name}: {cfg.n_layers} layers"
              + (f" after {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} "
                 "frames" if cfg.is_encoder_decoder else
                 f" after {cfg.n_frontend_tokens} frontend tokens")
              + f", d_model {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} KV) of "
              f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}: {n_params:,} parameters "
              f"drawn in {time.perf_counter() - t0:.2f}s")
        wave = frontend_wave(cfg, model, ref, params, sizes, device)
        wave["summary"]["n_params"] = n_params
        out[key] = wave["summary"]
        phase_s[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
        layers = capture_flash_calls(model, params, wave["tokens"], wave["max_seq"],
                                     device, **wave["inputs"])
        del wave
        named = (whisper_flash_kinds(cfg, layers) if cfg.is_encoder_decoder
                 else [("causal", *x) for x in layers])
        out["flash_rows"].update(flash_shape_rows(cfg.name, named, device, reps=10))
        del layers, named
        phase_s["22b"] += time.perf_counter() - t0
        if key == "whisper":
            t0 = time.perf_counter()
            del model, ref, params
            free_card(device)
            serve = lm_serving_phase(cfg, sizes, device)
            out["whisper_engine"] = serve["summary"]
            del serve
            phase_s["22a"] += time.perf_counter() - t0
        else:
            del model, ref, params
        free_card(device)
    for key, cfg, train_sizes in (
            ("whisper_train", cfgs["whisper"], sizes),
            ("pixtral_train", cfgs["pixtral_train"],
             dataclasses.replace(sizes, lm_train_steps=min(sizes.lm_train_steps,
                                                           PIXTRAL_TRAIN_STEPS)))):
        t0 = time.perf_counter()
        out[key] = lm_training_phase(cfg, train_sizes, device)
        phase_s["22d"] = phase_s.get("22d", 0.0) + time.perf_counter() - t0
        free_card(device)
    out["peaks"] = {k: out[k]["peak_abs_bytes"] for k in
                    ("whisper", "whisper_engine", "pixtral", "whisper_train",
                     "pixtral_train")}
    out["phase_s"] = phase_s
    print(f"[encdec] phase 22 peaks (GiB, allocated): "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in out["peaks"].items())
          + f"; seconds: {json.dumps(phase_s)}")
    return out


def encdec_entries(entries: list, p22: dict) -> None:
    """Phase 22 beside its kernels' entries: its five paths' launches, the
    flash calls at the new shapes (whisper's encoder and cross attention
    at D = 64, non-causal; pixtral-12b's at D = 128, causal; one call each
    at the first such layer's inputs, CUDA events; ``max_abs_err`` over
    every call), and the Adam launch over each trained model's leaves."""
    by_name = {e["name"]: e for e in entries}
    for path, launched in (("lm_wave_whisper", p22["whisper"]["launches"]),
                           ("lm_serving_whisper", p22["whisper_engine"]["launches"]),
                           ("lm_wave_pixtral", p22["pixtral"]["launches"]),
                           ("lm_training_whisper", p22["whisper_train"]["launches"]),
                           ("lm_training_pixtral", p22["pixtral_train"]["launches"])):
        for e in entries:
            e["launches_by_path"][path] = launched[e["name"]]
            e["launches"] += launched[e["name"]]
    flash = by_name["flash_attention"]
    rows = p22["flash_rows"]
    flash["encdec"] = {}
    for label, row in rows.items():
        flash["max_abs_err"] = max(flash["max_abs_err"], row["max_abs_err"])
        flash["bf16_max_abs_err"] = max(flash.get("bf16_max_abs_err", 0.0),
                                        row["bf16_max_abs_err"])
        flash["encdec"][label] = {
            **{k: row[k] for k in ("ms", "ms_by", "wall_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library_enable_gqa_ms",
                                   "vs_library", "max_abs_err", "calls")},
            "shape": f"one call at the first such layer's prefill inputs: B {row['B']}, "
                     f"H {row['H']}, Hkv {row['Hkv']}, Tq {row['Tq']}, Tk {row['Tk']}, "
                     f"D {row['D']}, {'causal' if row['causal'] else 'non-causal'}, "
                     "float32"}
    adam = by_name["fused_adam"]
    for key in ("whisper_train", "pixtral_train"):
        t = p22[key]
        a = t["adam"]
        adam["max_abs_err"] = max(adam["max_abs_err"], a["max_abs_err"])
        adam[key.replace("_train", "_step")] = {
            **{k: a[k] for k in ("ms", "ms_by", "plain_ms", "library_ms", "library",
                                 "bound_ms", "bound_by", "params", "leaves")},
            "launches_a_step": t["launches"]["fused_adam"] / t["steps"],
            "shape": f"one launch over {t['arch']}'s {a['leaves']} leaves "
                     f"({a['params']:,} values): ms by CUDA events"}


# ---------------------------------------------------------------------------
# Phases 17-18: the layout stage and γ, and the single-device runtime
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def layout_cache():
    """A fresh layout cache for the run: ``MORPHLING_LAYOUT_CACHE`` points
    into a temporary directory (the lowering's ``layout="auto"`` reads
    it), restored after."""
    before = os.environ.get("MORPHLING_LAYOUT_CACHE")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "layout_cache.json")
        os.environ["MORPHLING_LAYOUT_CACHE"] = path
        try:
            yield path
        finally:
            if before is None:
                os.environ.pop("MORPHLING_LAYOUT_CACHE", None)
            else:
                os.environ["MORPHLING_LAYOUT_CACHE"] = before


def order_stats(graph, f: int, device) -> dict:
    """Each order's BSR block count at the order rule's reference tile (8
    x the adaptive bc) beside the Hopper kernels' column stream (its
    length at each built block height) and, on the card, the fused
    kernel's forward at width ``f`` and br 8 timed as the autotuner times
    a candidate: does the block count rank the orders as the card does?"""
    bc = adaptive_bc(graph.n_cols)
    out = {}
    for mode in ("none",) + REORDER_MODES:
        g = graph if mode == "none" else reorder_graph(graph, mode)[0]
        out[mode] = {"blocks_8x%d" % bc: bsr_block_count(g, 8, bc),
                     **{f"columns_br{br}": column_stream(g, br)[0]
                        for br in BUILT_BR}}
        if device.type == "cuda":
            ms, = layout_mod._time_scores(g, f, "cuda", True, [(8, 16, 0)], 0,
                                          device)
            out[mode]["fused_ms_br8"] = ms * 1e3
    return out


def plan_phase(name: str, graph, f: int, device, cache: str) -> dict:
    """``plan_layout`` on ``cuda`` at width ``f``, fused: the orders'
    block counts and column streams, each timed candidate's median ms
    (read back from the cache entry) beside its cost-model score, the
    winner (measured on the card); then the same call again, a cache hit
    that measures nothing."""
    t0 = time.perf_counter()
    stats = order_stats(graph, f, device)
    stats_s = time.perf_counter() - t0
    calls = layout_mod.measure_calls()
    t0 = time.perf_counter()
    plan = plan_layout(graph, f, backend="cuda", fused=True, device=device,
                       cache_path=cache)
    plan_s = time.perf_counter() - t0
    timed = layout_mod.measure_calls() - calls
    on_card = device.type == "cuda"
    if plan.source != ("measured" if on_card else "cost-model"):
        raise AssertionError(f"[{name}] plan source {plan.source}")
    g_r = graph if plan.reordered_graph is None else plan.reordered_graph
    grid = _candidate_grid(g_r, f, None, True, "cuda")
    scores = _load_cache(cache)[plan.fingerprint]["scores"]
    model = dict(zip((f"{br}x{bc}x{bf}" for br, bc, bf in grid),
                     _model_scores(g_r, f, grid, "cuda")))
    candidates = {k: {"median_ms": v * 1e3 if on_card else None,
                      "model_score": model[k]} for k, v in scores.items()}
    t0 = time.perf_counter()
    again = plan_layout(graph, f, backend="cuda", fused=True, device=device,
                        cache_path=cache)
    hit_s = time.perf_counter() - t0
    if again.source != "cache" or layout_mod.measure_calls() != calls + timed:
        raise AssertionError(f"[{name}] the second plan must be a cache hit "
                             f"that measures nothing: {again.source}")
    if (again.order, again.br, again.bc) != (plan.order, plan.br, plan.bc):
        raise AssertionError(f"[{name}] the cache hit's layout differs")
    out = {"order": plan.order, "winner": f"{plan.br}x{plan.bc}",
           "describe": plan.describe(), "source": plan.source,
           "measured_candidates": timed, "orders": stats,
           "candidates": candidates, "plan_s": plan_s, "cache_hit_s": hit_s,
           "order_stats_s": stats_s, "f": f}
    print(f"[{name}] layout plan: {json.dumps(out)}")
    return out


def auto_path(name: str, gnn, base: dict, device, epochs: int,
              expected: dict) -> dict:
    """``compile(layout="auto")`` (the plan just cached) from the
    identity-layout path ``base``'s weights: ``train_path``'s gates
    against the torch program at the same layout, the first step's
    logits in user order against ``base``'s (1e-4), and every epoch's
    loss within 1e-3 relative of ``base``'s."""
    run = train_path(name, gnn, device, epochs, expected, layout="auto",
                     weights=base["weights"])
    prog = run["prog"]
    if prog.plan.layout.source != "cache":
        raise AssertionError(f"[{name}] compile must take the cached plan")
    err = check_close(f"[{name}] first-step logits against the identity "
                      "layout's", run["logits0"], base["logits0"])
    ours, theirs = run["summary"]["losses"], base["summary"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(ours, theirs)]
    if not max(rel) <= 1e-3:
        raise AssertionError(f"[{name}] losses {ours} vs identity {theirs}")
    s = run["summary"]
    s.update(logits_max_abs_err=err, identity_rel_diff=max(rel),
             identity_epoch_ms_median=base["summary"]["epoch_ms_median"],
             identity_profile=base["summary"]["profile"].get("device_ms"))
    print(f"[{name}] layout {s['layout']}: median epoch "
          f"{s['epoch_ms_median']:.2f} ms against the identity layout's "
          f"{s['identity_epoch_ms_median']:.2f}; device ms "
          f"{json.dumps(s['profile'].get('device_ms'))} against "
          f"{json.dumps(s['identity_profile'])}")
    del run["prog"], run["ref"]
    return s


def gamma_phase(qgnn, quick: dict, qds, device, epochs: int) -> dict:
    """γ measured twice (``measure_gamma``, the microbenchmark behind
    ``calibrate_gamma``: the ``cuda`` plan's sparse X·W against fp32
    ``torch.matmul``): at the JAX package's default shape and at the
    quickstart's layer 0 (corafull's X → 32); the decision each γ gives
    the quickstart's and GT's layer 0; then the quickstart's epoch with
    layer 0 forced sparse (γ 0.20) and dense (``DENSE_GAMMA``), epochs
    in turns from phase 6's weights, losses within 1e-3 relative."""
    zero_counts()
    measured = {}
    for label, kw in (("JAX's default 1024x1024->64, s=0.9 (launch-bound on "
                       "the card)", {}),
                      (f"quickstart layer 0 {qds.features.shape[0]}x"
                       f"{qds.features.shape[1]}->32",
                       dict(x=qds.features, h=32))):
        m = measure_gamma(engine="cuda", device=device, repeats=20, **kw)
        measured[label] = dataclasses.asdict(m)
        print(f"[gamma] {label}: t_dense {m.t_dense * 1e3:.4f} ms, t_sparse "
              f"{m.t_sparse * 1e3:.4f} ms, eta_dense {m.eta_dense / 1e12:.3f} "
              f"TFLOP/s, eta_sparse {m.eta_sparse / 1e12:.3f} TFLOP/s, gamma "
              f"{m.gamma:.4f}")
    n, f = qds.features.shape
    decisions = {}
    for label, m in measured.items():
        d = decide_execution_path_from_stats(qds.feature_sparsity, n, f, 32,
                                             gamma=m["gamma"])
        # GT's layer 0 is [8710 -> 32] on corafull too: the same decision
        decisions[label] = {"quickstart_and_gt_layer0": d.mode,
                            "threshold": d.threshold,
                            "predicted_speedup": d.predicted_speedup}
    print(f"[gamma] decisions at s={qds.feature_sparsity:.4f}: "
          f"{json.dumps(decisions)}")
    progs = {}
    for path, gamma in (("sparse", PAPER_GAMMA_DEFAULT), ("dense", DENSE_GAMMA)):
        qgnn.gamma = gamma
        progs[path] = qgnn.compile(engine="cuda", device=device,
                                   fused_optimizer=True, params=quick["weights"])
        if progs[path].plan.layers[0].feature_path != path:
            raise AssertionError(f"gamma {gamma} must put layer 0 on {path}")
    qgnn.gamma = PAPER_GAMMA_DEFAULT
    losses = {p: [] for p in progs}
    times = {p: [] for p in progs}
    for epoch in range(epochs):
        for p in (("sparse", "dense") if epoch % 2 == 0 else ("dense", "sparse")):
            t0 = time.perf_counter()
            losses[p].append(progs[p].train_epoch()["loss"])
            times[p].append(time.perf_counter() - t0)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["dense"], losses["sparse"])]
    if not (np.isfinite(losses["dense"]).all() and max(rel) <= 1e-3):
        raise AssertionError(f"[gamma] dense {losses['dense']} vs sparse "
                             f"{losses['sparse']}")
    out = {"measured": measured, "decisions": decisions,
           "epoch_ms_median": {p: float(np.median(t)) * 1e3
                               for p, t in times.items()},
           "epoch_ms": {p: [x * 1e3 for x in t] for p, t in times.items()},
           "losses": losses, "max_rel_diff": max(rel),
           "launches": counts(), "default_gamma": PAPER_GAMMA_DEFAULT}
    print(f"[gamma] quickstart epoch, layer 0 sparse "
          f"{out['epoch_ms_median']['sparse']:.3f} ms, dense "
          f"{out['epoch_ms_median']['dense']:.3f} ms (medians of {epochs}, in "
          f"turns); losses within {max(rel):.2e}")
    return out


def params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def runtime_phase(gnn, base: dict, device, epochs: int, expected: dict) -> dict:
    """Phase 18 (a): the arxiv GCN from phase 4's weights through
    ``FullBatchTrainer`` under the guard (fused Adam 0.01), the injector
    poisoning epoch ``POISONED_EPOCH``'s gradients with NaN: that epoch's
    params bitwise those before it, every loss finite; a run whose
    epoch-10 save is killed leaves step 5 the newest checkpoint, and a
    fresh trainer resumes from it to the uninterrupted run's params, bit
    for bit. The host ms of a save and a restore; the guarded epoch beside
    phase 4's."""
    prog = gnn.compile(engine="cuda", device=device, fused_optimizer=True,
                       params=base["weights"])
    data = (prog.x, prog.labels, prog.train_mask)
    on_card = device.type == "cuda"

    def trainer(ckpt_dir=None, kill=False):
        faults = [FaultSpec(site="grad", steps=(POISONED_EPOCH,), mode="nan")]
        if kill:
            faults.append(FaultSpec(site="checkpoint_kill", steps=(epochs,)))
        return FullBatchTrainer(prog.model, adam(*ADAM[1:], fused=True),
                                ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                                guard=GuardPolicy(),
                                injector=FaultInjector(0, faults))

    zero_counts()
    straight = trainer().fit(prog.params, *data, epochs)
    launched = counts()
    want = {k: expected.get(k, 0) * epochs if on_card else 0 for k in KERNELS}
    if launched != want:
        raise AssertionError(f"[runtime] launched {launched}, expected {want}")
    if not (np.isfinite(straight.losses).all()
            and straight.guard["skipped"] == 1):
        raise AssertionError(f"[runtime] {straight.losses} {straight.guard}")
    before = trainer().fit(prog.params, *data, POISONED_EPOCH).final_params
    after = trainer().fit(prog.params, *data, POISONED_EPOCH + 1).final_params
    if not params_equal(before, after):
        raise AssertionError("[runtime] the poisoned epoch changed the params")
    with tempfile.TemporaryDirectory() as d:
        try:
            trainer(d, kill=True).fit(prog.params, *data, epochs)
            raise AssertionError("[runtime] the killed save did not raise")
        except InjectedFault:
            pass
        left = list_checkpoints(d)
        if left != [CKPT_EVERY]:
            raise AssertionError(f"[runtime] checkpoints after the kill: {left}")
        resumed = trainer(d).fit(prog.params, *data, epochs)
        if not (resumed.restored_from == CKPT_EVERY
                and resumed.losses == straight.losses[CKPT_EVERY:]
                and params_equal(resumed.final_params, straight.final_params)):
            raise AssertionError(f"[runtime] the resume is not bitwise: "
                                 f"{resumed.losses} vs {straight.losses}")
        opt = adam(*ADAM[1:], fused=True)
        state = (straight.final_params, opt.init(straight.final_params))
        save_ms, restore_ms = [], []
        for i in range(5):
            sync(device)
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(d, "timed"), i + 1, state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            restored, _ = restore_checkpoint(os.path.join(d, "timed"), state)
            sync(device)
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state[0]))
    out = {"losses": straight.losses, "guard": straight.guard,
           "epoch_ms_median": float(np.median(straight.epoch_times)) * 1e3,
           "unguarded_epoch_ms_median": base["summary"]["epoch_ms_median"],
           "resumed_losses": resumed.losses, "save_ms_median": float(np.median(save_ms)),
           "restore_ms_median": float(np.median(restore_ms)),
           "save_ms": save_ms, "restore_ms": restore_ms,
           "state_bytes": 3 * nbytes, "launches": launched}
    print(f"[runtime] guarded GCN: epoch {POISONED_EPOCH} skipped bitwise, "
          f"losses finite, the epoch-{epochs} save killed, resumed from "
          f"{CKPT_EVERY} bitwise; guarded epoch {out['epoch_ms_median']:.2f} ms "
          f"(phase 4 unguarded {out['unguarded_epoch_ms_median']:.2f}); save "
          f"{out['save_ms_median']:.1f} ms, restore {out['restore_ms_median']:.1f} "
          f"ms of {out['state_bytes'] / 2**20:.1f} MiB (params, m, v; host "
          "clock, synchronised, medians of 5)")
    del prog
    return out


def recorded_seeds(tr) -> list:
    """Every batch's seed ids the trainer's epochs draw, in order."""
    seeds, draw = [], tr.sampler.epoch_batches

    def epoch_batches(*args, **kw):
        for batch in draw(*args, **kw):
            seeds.append(batch.seeds.copy())
            yield batch

    tr.sampler.epoch_batches = epoch_batches
    return seeds


def sampled_resume(ds, sizes: Sizes, device) -> dict:
    """Phase 18 (b): phase 14's SAGE-mean (fused Adam 0.01, fanouts and
    batches as there), the train mask cut to ``resume_cut`` nodes,
    interrupted after epoch 1 and resumed by a fresh trainer to epoch
    ``RESUME_EPOCHS``: every batch's seed ids, the losses and the params
    bitwise those of the uninterrupted run. Where they are not, the
    uninterrupted run is repeated: the resume must then be no further
    from it than the repeat is."""
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    cfg = GNNConfig(kind="SAGE", layer_dims=dims, aggregation="mean")
    mask = train_cut(ds.train_mask, sizes.resume_cut)

    def trainer(**kw):
        return MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels, mask,
                                adam(*ADAM[1:], fused=True),
                                fanouts=tuple(sizes.fanouts),
                                batch_size=sizes.sampled_batch_size,
                                engine="cuda", seed=0, device=device, **kw)

    def diff(a, b) -> float:
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    zero_counts()
    t0 = time.perf_counter()
    s = trainer()
    s_seeds = recorded_seeds(s)
    rs = s.fit(RESUME_EPOCHS)
    straight_s = time.perf_counter() - t0
    launched = counts()
    steps = len(s_seeds) // RESUME_EPOCHS
    per_step = sampled_per_step(s.plan)
    want = {k: per_step.get(k, 0) * steps * RESUME_EPOCHS
            if device.type == "cuda" else 0 for k in KERNELS}
    if launched != want:
        raise AssertionError(f"[resume] launched {launched}, expected {want}")
    with tempfile.TemporaryDirectory() as d:
        trainer(ckpt_dir=d, ckpt_every=1).fit(1)
        b = trainer(ckpt_dir=d, ckpt_every=1)
        b_seeds = recorded_seeds(b)
        rb = b.fit(RESUME_EPOCHS)
    if rb.restored_from != 1:
        raise AssertionError(f"[resume] restored from {rb.restored_from}")
    tail = s_seeds[steps:]
    if len(b_seeds) != len(tail) or not all(
            np.array_equal(x, y) for x, y in zip(b_seeds, tail)):
        raise AssertionError("[resume] the resumed batches' seeds differ")
    bitwise = rb.losses == rs.losses[1:] and params_equal(b.params, s.params)
    out = {"steps_per_epoch": steps, "epochs": RESUME_EPOCHS,
           "cut": int(mask.sum()), "losses": rs.losses,
           "resumed_losses": rb.losses, "bitwise": bitwise,
           "straight_s": straight_s, "launches": launched}
    if not bitwise:
        r = trainer()
        r.fit(RESUME_EPOCHS)
        out["repeat_param_max_abs_diff"] = diff(r.params, s.params)
        out["resume_param_max_abs_diff"] = diff(b.params, s.params)
        print(f"[resume] not bitwise: {json.dumps(out)}")
        if not out["resume_param_max_abs_diff"] <= out["repeat_param_max_abs_diff"]:
            raise AssertionError("[resume] the resume is further from the "
                                 "uninterrupted run than a repeat is")
    print(f"[resume] sampled SAGE-mean, {steps} steps an epoch over "
          f"{out['cut']} seeds, interrupted after epoch 1 and resumed: seeds "
          f"bitwise, losses and params {'bitwise' if bitwise else 'within the repeat'}"
          f" ({straight_s:.1f}s uninterrupted)")
    return out


def sum_rows(rows: list) -> dict:
    """Timed or bounded calls summed: times, bounds, bytes and operations;
    ``ms_by`` and ``bound_by`` of the sum."""
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "segment_ms",
            "bound_ms", "nnz_bound_ms", "layout_bound_ms", "bytes", "nnz_bytes",
            "flop")
    total = {k: None if any(r.get(k) is None for r in rows)
             else sum(r[k] for r in rows) for k in keys}
    total["ms_by"] = "/".join(sorted({r["ms_by"] for r in rows}))
    _, total["bound_by"] = _bound(total["bytes"], total["flop"])
    return total


def epoch_entry(name: str, calls: list, err: float, epoch: dict) -> dict:
    """One training kernel's entry: ``ms`` its device time in the profiled
    epoch ``epoch`` where the window held every launch, else ``calls_ms``
    (``ms_by`` says which); ``calls_ms``, ``wall_ms``, ``plain_ms``,
    ``library_ms``, the bounds (and ``segment_ms``) each layer's call timed
    or bounded alone at its width, summed."""
    total = sum_rows(calls)
    entry = {
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": 0, "max_abs_err": err,
        "ms": epoch["device_ms"][name] if epoch["complete"] else total["ms"],
        "ms_by": ("profiled epoch" if epoch["complete"] else
                  "calls_ms: no profiler window held every launch of an epoch"),
        "calls_ms": total["ms"], "calls_ms_by": total["ms_by"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": total["bound_by"], "nnz_bound_ms": total["nnz_bound_ms"],
        "library_ms": total["library_ms"], "wall_ms": total["wall_ms"],
        "shape": "one epoch of the path at full width: ms as ms_by says; the "
                 "other times and the bounds each layer's call alone, summed",
    }
    if total["layout_bound_ms"] is not None:
        entry["layout_bound_ms"] = total["layout_bound_ms"]
    if total["segment_ms"] is not None:
        entry["segment_ms"] = total["segment_ms"]
        entry["segment_ms_is"] = (
            "segment_softmax_aggregate per layer, summed: the forward beside "
            "the forward kernel, its whole autograd backward beside each "
            "backward pass; a composition of library calls (gather, "
            "scatter_reduce, index_add_), not one library kernel")
    return entry


def kernel_entries(serving_entry, launches_by_path, fk, ak, adam, errs, dims,
                   epoch: dict, gat_epoch: dict, flash: dict) -> list:
    """The kernels line: one entry per kernel. ``launches`` sums every
    driven path (``launches_by_path`` splits it). The three GCN training
    kernels report one epoch of phase 4 (calls from phase 5; Adam's from
    phase 12, with GAT's 15 leaves and each path's ``opt.update`` host
    time beside them), the three attention kernels one epoch of phase 7
    (calls from phase 8), through ``epoch_entry``. ``bsr_spmm`` keeps its
    serving batch, and ``flash_attention`` (``flash``) one call of phase
    10's prefill."""
    rows = fk["rows"]
    n = len(dims) - 1
    per_epoch = {
        "bsr_spmm_fused_epilogue": [rows[("fused", dims[l + 1],
                                          "relu" if l < n - 1 else "none")]
                                    for l in range(n)],
        "bsr_spmm_masked": [rows[("masked", dims[1])]] * (n - 1),
        "fused_adam": [adam["rows"]["gcn"]],
    }
    entries = [dict(serving_entry)]
    entries += [epoch_entry(name, calls, errs[name], epoch)
                for name, calls in per_epoch.items()]
    for kind, (name, _, _) in ATTENTION.items():
        calls = [ak["rows"][(kind, l)] for l in range(ak["layers"])]
        entries.append(epoch_entry(name, calls, errs[name], gat_epoch))
    adam_entry = next(e for e in entries if e["name"] == "fused_adam")
    adam_entry["gat_step"] = adam["rows"]["gat"]
    adam_entry["update_host_ms"] = adam["update_host_ms"]
    entries[0]["max_abs_err"] = errs["bsr_spmm"]
    entries[0]["training_aT"] = rows[("spmm", dims[-1])]
    entries.append(dict(flash))
    for e in entries:
        by_path = {p: c[e["name"]] for p, c in launches_by_path.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    return entries


def sampled_entries(entries: list, gat_serve: dict, sampled: dict) -> None:
    """Each on-path kernel's calls on the sampled paths beside its entry:
    ``bsr_spmm`` on a SAGE training batch's A and Aᵀ, the attention passes
    on a GAT serving batch (the forward) and a GAT training batch; each
    the batch's layers summed (``sum_rows``), and the launches a batch or
    step that the path's run counted."""
    by_name = {e["name"]: e for e in entries}

    def per_step(path: str, name: str) -> float:
        s = sampled[path]
        return s["launches"][name] / (len(s["losses"]) * s["steps_per_epoch"])

    by_name["bsr_spmm"]["sampled_sage_step"] = {
        **sum_rows(list(sampled["sage"]["rows"].values())),
        "launches_a_step": per_step("sage", "bsr_spmm"),
        "shape": "one SAGE training batch: every layer's A and Aᵀ at its width"}
    for kind, (name, _, _) in ATTENTION.items():
        entry = by_name[name]
        for label, rows, launches in (
                ("sampled_gat_serving_batch", gat_serve["rows"],
                 gat_serve["launched"][name] / gat_serve["batches"]),
                ("sampled_gat_step", sampled["gat"]["rows"], per_step("gat", name))):
            calls = [r for (k, _), r in rows.items() if k == kind]
            if calls:
                entry[label] = {**sum_rows(calls), "launches_a_batch": launches}
    by_name["fused_adam"]["sampled_launches_a_step"] = {
        p: per_step(p, "fused_adam") for p in sampled}


def lm_entries(entries: list, lm2: dict) -> None:
    """Phases 15-16 beside their kernels' entries: the flash call at
    gemma3-1b's D = 256 (one call at its first global layer's inputs,
    CUDA events; ``max_abs_err`` over both widths), and the Adam launch
    over the LM training step's leaves."""
    by_name = {e["name"]: e for e in entries}
    g = lm2["gemma_flash"]
    row = g["row"]
    flash = by_name["flash_attention"]
    flash["max_abs_err"] = max(flash["max_abs_err"], g["err"]["f32"], g["edge"]["f32"])
    flash["bf16_max_abs_err"] = max(flash.get("bf16_max_abs_err", 0.0), g["err"]["bf16"],
                                    g["edge"]["bf16"])
    flash["gemma_d256"] = {
        **{k: row[k] for k in ("ms", "ms_by", "wall_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_enable_gqa_ms",
                               "vs_library", "wave_ms")},
        "max_abs_err": max(g["err"]["f32"], g["edge"]["f32"]),
        "launches_a_wave": lm2["gemma"]["flash_per_wave"],
        "shape": f"one call at the first global layer's prefill inputs: B {row['B']}, "
                 f"H {row['H']}, Hkv {row['Hkv']}, T {row['Tq']}, D {row['D']}, causal, "
                 f"float32; wave_ms the kernel over all {row['layers']} global layers"}
    t = lm2["lm_train"]
    a = t["adam"]
    adam = by_name["fused_adam"]
    adam["max_abs_err"] = max(adam["max_abs_err"], a["max_abs_err"])
    adam["lm_step"] = {
        **{k: a[k] for k in ("ms", "ms_by", "plain_ms", "library_ms", "library",
                             "bound_ms", "bound_by", "params", "leaves")},
        "profiled_step_ms": (t["profile"]["device_ms"].get("fused_adam")
                             if t["profile"]["complete"] else None),
        "launches_a_step": t["launches"]["fused_adam"] / t["steps"],
        "shape": f"one launch over {t['arch']}'s {a['leaves']} leaves "
                 f"({a['params']:,} values): ms by CUDA events; profiled_step_ms "
                 "its device time inside a profiled training step"}


def layout_entries(entries: list, auto: dict, gamma: dict) -> None:
    """Phase 17 beside the SpMM kernels' entries: each one's device ms in
    a profiled epoch at the autotuned layout beside the identity layout's
    (phases 4 and 6), and γ's two measurements beside ``bsr_spmm``."""
    by_name = {e["name"]: e for e in entries}
    for name in ("bsr_spmm", "bsr_spmm_fused_epilogue", "bsr_spmm_masked"):
        by_name[name]["autotuned"] = {
            path: {"layout": a["layout"],
                   "ms": (a["profile"]["device_ms"].get(name, 0.0)
                          if a["profile"]["complete"] else None),
                   "identity_ms": (a["identity_profile"] or {}).get(name),
                   "launches_an_epoch": a["per_epoch"][name],
                   "epoch_ms_median": a["epoch_ms_median"],
                   "identity_epoch_ms_median": a["identity_epoch_ms_median"]}
            for path, a in auto.items()}
    by_name["bsr_spmm"]["gamma"] = {
        label: {k: m[k] for k in ("t_dense", "t_sparse", "eta_dense",
                                  "eta_sparse", "gamma")}
        for label, m in gamma["measured"].items()}


# ---------------------------------------------------------------------------
# Phase 19: the plan-contract verifier on every plan, and the chaos soak
# ---------------------------------------------------------------------------

def exec_graph(graph, plan):
    """The graph a full-batch plan's operands were built on: ``graph``
    renumbered by the plan's order where it permutes (host)."""
    lp = plan.layout
    if lp is None or not lp.permutes:
        return graph
    return permute_graph(graph, np.asarray(lp.inv_perm))


def verify_timed(name: str, plan, device, graph=None) -> dict:
    """Phase 19 (a), run where the plan's phase holds it (its operands
    are freed after): ``verify_plan`` in fast and in full mode,
    ``VERIFY_REPS`` times each (synchronised host clock), on the
    operands' device; a sampled plan's template batch builds its streams
    on the plan's device, its trainer's. Any violation fails the run."""
    out = {"plan": name, "family": type(plan).__name__}
    for mode in ("fast", "full"):
        ms = []
        for _ in range(VERIFY_REPS):
            sync(device)
            t0 = time.perf_counter()
            found = verify_plan(plan, mode=mode, graph=graph)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if found:
                raise AssertionError(f"[{name}] {mode} verification: "
                                     + "; ".join(str(v) for v in found))
        out[f"{mode}_ms"] = float(np.median(ms))
        out[f"{mode}_ms_all"] = ms
    print(f"[verify] {name} ({out['family']}): 0 violations; fast "
          f"{out['fast_ms']:.2f} ms, full {out['full_ms']:.2f} ms (medians of "
          f"{VERIFY_REPS}, synchronised)")
    return out


def lowering_cost(name: str, lower_fn, checked: dict, device) -> dict:
    """Phase 19 (b): one ``lower_fn()`` with ``validate="off"`` (the plan
    freed after, synchronised host clock), and the shares that (a)'s
    fast and full checks of the same plan (``checked``, medians) add to
    it."""
    sync(device)
    t0 = time.perf_counter()
    plan = lower_fn()
    sync(device)
    off = (time.perf_counter() - t0) * 1e3
    del plan
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"off_ms": off, "fast_ms": checked["fast_ms"],
           "full_ms": checked["full_ms"], "plan": checked["plan"],
           "fast_share": checked["fast_ms"] / off,
           "full_share": checked["full_ms"] / off}
    print(f"[verify] lowering {name}: off {off:.1f} ms (one lowering); "
          f"{checked['plan']}'s check fast {out['fast_ms']:.2f} ms "
          f"({out['fast_share']:.2%} of off), full {out['full_ms']:.2f} ms "
          f"({out['full_share']:.2%})")
    return out


def _replace_operand(plan, which: str = "fwd_operand", **fields):
    dev = dataclasses.replace(getattr(plan.graph_op, which), **fields)
    return dataclasses.replace(
        plan, graph_op=dataclasses.replace(plan.graph_op, **{which: dev}))


def card_mutations(qds, qdims, device) -> dict:
    """Phase 19 (c): the quickstart GCN lowered on the card at
    ``layout="degree"`` passes full mode against its exec graph; then
    six corruptions of its card-resident operands (and its permutation)
    are each flagged by name through ``check_plan``, which raises: an
    unsorted block column, a NaN block, an item dropped from A's column
    stream, a stale stream after ``dataclasses.replace(blocks=...)``, a
    swapped ``perm`` pair, a block-row with twice its mass. The value
    checks run as reductions on the card (``core/verify.py``)."""
    cfg = GNNConfig(kind="GCN", layer_dims=qdims, aggregation="gcn")
    plan = lower(cfg, qds.graph, qds.features, engine="cuda", device=device,
                 layout="degree", validate="off")
    g = exec_graph(qds.graph, plan)
    check_plan(plan, mode="full", graph=g)
    dev = plan.graph_op.fwd_operand
    if device.type == "cuda" and not (dev.blocks.is_cuda and dev.nzc.items.is_cuda):
        raise AssertionError("[mutations] the operands must lie on the card")
    rows = dev.block_rows.cpu().numpy()
    row = int(np.flatnonzero(np.bincount(rows) >= 2)[0])
    i, j = np.flatnonzero(rows == row)[:2].tolist()
    cols = dev.block_cols.clone()
    cols[i], cols[j] = dev.block_cols[j], dev.block_cols[i]
    nan = dev.blocks.clone()
    nan[i, 0, 0] = float("nan")
    items = dev.nzc.items
    keep = torch.ones(items.shape[0], dtype=torch.bool, device=items.device)
    keep[items.shape[0] // 2] = False
    stale = dev.blocks.clone()
    stale[i] = 0.0  # a block's columns leave the stream; nzc keeps them
    heavy = dev.blocks.clone()
    heavy[torch.from_numpy(rows == row).to(heavy.device)] *= 2.0
    perm = np.asarray(plan.layout.perm).copy()
    perm[[0, 1]] = perm[[1, 0]]
    cases = {
        "bsr.cols_sorted": _replace_operand(plan, block_cols=cols),
        "bsr.finite": _replace_operand(plan, blocks=nan),
        "nzc.row_coverage": _replace_operand(plan, nzc=dataclasses.replace(
            dev.nzc, items=items[keep].contiguous())),
        "nzc.stream_match": _replace_operand(plan, blocks=stale),
        "perm.inverse": dataclasses.replace(
            plan, layout=dataclasses.replace(plan.layout, perm=perm)),
        "layout.operand_rows": _replace_operand(plan, blocks=heavy),
    }
    out = {}
    for invariant, bad in cases.items():
        sync(device)
        t0 = time.perf_counter()
        try:
            check_plan(bad, mode="full", graph=g)
        except PlanVerificationError as e:
            found = e.violations
        else:
            raise AssertionError(f"[mutations] {invariant}: not flagged")
        ms = (time.perf_counter() - t0) * 1e3
        named = [str(v) for v in found if v.invariant == invariant]
        if not named:
            raise AssertionError(f"[mutations] {invariant} not named: "
                                 + "; ".join(str(v) for v in found))
        out[invariant] = {"flagged": named[0], "ms": ms,
                          "all": sorted({v.invariant for v in found})}
        print(f"[mutations] {named[0]} ({ms:.1f} ms; all flagged: "
              f"{', '.join(out[invariant]['all'])})")
    del plan, cases, nan, stale, heavy
    return out


#: the kernels the chaos soak reaches, by ``kernels/ops.py`` executor key
SOAK_OPS = {"spmm": "bsr_spmm", "fused": "bsr_spmm_fused_epilogue",
            "masked": "bsr_spmm_masked", "attn_fwd": "bsr_attention_fwd",
            "attn_row": "bsr_attention_bwd_row",
            "attn_col": "bsr_attention_bwd_col"}


def _held(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


@contextlib.contextmanager
def recorded_calls(calls: list, limit: Optional[int] = None):
    """Inside the ``with`` statement each ``cuda`` executor of ``SOAK_OPS``
    appends every call (the first ``limit`` where given) to ``calls``: its
    executor key, its arguments (tensors copied before the call; ``nzc``
    left out, as the plain versions read the blocks) and its outputs
    (copied). The kernels launch as before; the executors are restored
    after."""
    table = kops._EXECUTORS["cuda"]
    saved = {op: table[op] for op in SOAK_OPS}

    def spy(op, kernel):
        def call(*args, **kw):
            if limit is not None and len(calls) >= limit:
                return kernel(*args, **kw)
            held = (tuple(_held(a) for a in args),
                    {k: _held(v) for k, v in kw.items() if k != "nzc"})
            out = kernel(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((op, *held, tuple(_held(o) for o in outs)))
            return out
        return call

    for op, kernel in saved.items():
        table[op] = spy(op, kernel)
    try:
        yield calls
    finally:
        table.update(saved)


def check_call(label: str, op: str, args: tuple, kw: dict, got: tuple) -> float:
    """One recorded call (``recorded_calls``) against its plain version
    (the ``torch`` executor) on the same inputs: every output within TOL
    by ``output_error`` (the norm holds the backward's small outputs,
    means over a few seeds, to their own scale), the fused kernel's ReLU
    mask equal where |pre-activation| > MASK_MARGIN. Returns the largest
    absolute error; raises, naming ``label``, where a check fails."""
    plain = kops._EXECUTORS["torch"]
    want = plain[op](*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    if op == "fused" and args[-1] == "relu":
        pre, _ = plain[op](*args[:-1], "none")
        far = pre.abs() > MASK_MARGIN
        if not torch.equal(got[1][far], want[1][far]):
            raise AssertionError(f"{label}: masks differ")
        got, want = got[:1], want[:1]
    errs = [output_error(a, w) for a, w in zip(got, want) if a is not None]
    if not all(excess <= TOL and rel <= TOL for _, excess, rel in errs):
        finite = all(bool(torch.isfinite(a).all()) for a in args
                     if isinstance(a, torch.Tensor) and a.is_floating_point())
        raise AssertionError(
            f"{label} (inputs {'' if finite else 'not '}finite): (max abs "
            f"error, max excess over the relative part, error norm over the "
            f"output's) per output {errs} > {TOL}")
    return max(e for e, _, _ in errs)


def check_recorded(calls: list, device) -> dict:
    """Each recorded call against its plain version (``check_call``).
    Returns, per kernel, the calls checked and the largest absolute
    error."""
    out = {name: {"calls": 0, "max_abs_err": 0.0} for name in SOAK_OPS.values()}
    for i, (op, args, kw, got) in enumerate(calls):
        name = SOAK_OPS[op]
        err = check_call(f"[chaos] {name} call {i}", op, args, kw, got)
        out[name]["calls"] += 1
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    sync(device)
    return out


#: the soak's targets phase 19 runs; its distributed schedules run their
#: kernels in rank processes, and phase 24 (e) runs them
SOAK_SINGLE = ("full_batch", "mini_batch", "serving")


def soak_phase(device) -> dict:
    """Phase 19 (d): ``tools/chaos_soak.py``'s ``N_SCHEDULES`` schedules on
    ``device`` but the distributed ones (``SOAK_SINGLE``; a violated
    end-state property raises); the launches they
    made, counted from 0. Every kernel call of the soak is recorded
    (``recorded_calls``) and, after the counts are read, held against its
    plain version (``check_recorded``): a kernel launched in the soak
    must have each of its launches checked."""
    t0 = time.perf_counter()
    calls = []
    zero_counts()
    with recorded_calls(calls):
        rows = list(chaos_soak.soak(chaos_soak.N_SCHEDULES, 0, device,
                                    os.path.join(ROOT, "chiprun_out", "chaos_soak"),
                                    only=SOAK_SINGLE))
    launched = counts()
    s = time.perf_counter() - t0
    for r in rows:
        print(f"[chaos] {r}")
    print(f"[chaos] {len(rows)} schedules in {s:.1f}s, every property held; "
          f"launches {json.dumps({k: v for k, v in launched.items() if v})}")
    t0 = time.perf_counter()
    checked = check_recorded(calls, device)
    check_s = time.perf_counter() - t0
    for name, n in launched.items():
        if n > checked.get(name, {"calls": 0})["calls"]:
            raise AssertionError(f"[chaos] {name}: {n} launches, "
                                 f"{checked.get(name, {'calls': 0})['calls']} "
                                 "held against the plain version")
    print(f"[chaos] every kernel call held against its plain version in "
          f"{check_s:.1f}s: " + "; ".join(
              f"{k} {c['calls']} calls, max abs error {c['max_abs_err']:.3g}"
              for k, c in checked.items() if c["calls"]))
    return {"schedules": len(rows), "rows": rows, "s": s, "launches": launched,
            "checked": checked, "check_s": check_s}


def verifier_phase(ds, qds, sizes: Sizes, device, verified: list) -> dict:
    """Phase 19: (a) the full-mode verifications that phases 3-17 made of
    their plans (``verify_timed``), gathered; (b) what the check costs
    the lowering: one ``validate="off"`` lowering of the arxiv GCN and of
    the sampled SAGE plan, beside (a)'s check of each; (c) the mutations
    on card-resident operands; (d) the chaos soak, its kernel calls held
    against their plain versions."""
    t_phase = time.perf_counter()
    print("[verify] phase 19 (a): " + "; ".join(
        f"{v['plan']} fast {v['fast_ms']:.2f} / full {v['full_ms']:.2f} ms"
        for v in verified))
    by_plan = {v["plan"]: v for v in verified}
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    gcn = GNNConfig(kind="GCN", layer_dims=dims, aggregation="gcn")
    sage = GNNConfig(kind="SAGE", layer_dims=dims, aggregation="mean")
    cost = {
        "gcn": lowering_cost("arxiv GCN", lambda: lower(
            gcn, ds.graph, ds.features, engine="cuda", device=device,
            validate="off"), by_plan["train"], device),
        "sage_sampled": lowering_cost("sampled SAGE", lambda: lower_sampled(
            sage, ds.graph, ds.features, fanouts=sizes.fanouts,
            batch_size=sizes.sampled_batch_size, engine="cuda", seed=0,
            device=device, validate="off"), by_plan["sage-sampled"], device)}
    qdims = [qds.features.shape[1], *sizes.quick_hidden, qds.n_classes]
    mutations = card_mutations(qds, qdims, device)
    soak = soak_phase(device)
    return {"plans": verified, "lowering": cost, "mutations": mutations,
            "soak": {k: v for k, v in soak.items() if k != "launches"},
            "launches": soak["launches"], "s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# Phase 23: distributed full-batch training, 4 ranks sharing the card
# ---------------------------------------------------------------------------

#: the rank processes of phase 23; they share the one card
DIST_RANKS = 4
#: the runs: (name, graph, arch, aggregation, hidden widths, heads,
#: optimizer, epochs). (a) phase 4's GCN, (b) phase 7's GAT (its
#: effective aggregation is GCN's, so it trains on the same
#: ``DistributedGraph``; 7 epochs, as phase 7: at lr 0.002 the loss leaps
#: at the second step, 3.70 -> 4.92, and is back below its first value
#: only after 5), (c) the JAX package's ``examples/distributed_gnn.py``
#: model, SAGE-mean [8710, 16, 70] on the corafull analog at full scale
DIST_RUNS = (("gcn", "arxiv", "GCN", "gcn", "train_hidden", 0, ADAM, 5),
             ("gat", "arxiv", "GAT", "gcn", "gat_hidden", "gat_heads", GAT_ADAM,
              "gat_epochs"),
             ("sage", "corafull", "SAGE", "mean", (16,), 0, ADAM, 5))
#: the tile of every phase-23 graph (the JAX package's distributed tests')
DIST_BR, DIST_BC = 8, 32


def dist_runs(sizes: Sizes, graph: Optional[str] = None) -> list:
    """Phase 23's runs (of ``graph`` alone where given) as dicts."""
    out = []
    for name, g, arch, agg, hidden, heads, opt, epochs in DIST_RUNS:
        if graph is not None and g != graph:
            continue
        out.append({"name": name, "graph": g, "arch": arch, "aggregation": agg,
                    "hidden": tuple(getattr(sizes, hidden) if isinstance(hidden, str)
                                    else hidden),
                    "heads": getattr(sizes, heads) if isinstance(heads, str) else 4,
                    "opt": opt, "epochs": (getattr(sizes, epochs)
                                           if isinstance(epochs, str) else epochs)})
    return out


def dist_dataset(sizes: Sizes, graph: str):
    return (generate_dataset(sizes.dataset, scale=sizes.scale, seed=0)
            if graph == "arxiv" else
            generate_dataset(sizes.quick_dataset, scale=sizes.quick_scale, seed=0))


def rank_global_ids(graph, part: np.ndarray, k: int) -> list:
    """Each rank's local rows as global node ids, in the order
    ``build_local_views`` gives them without a reorder: the rank's nodes
    ascending, those with no in-edge from another rank (interior) first."""
    deg = np.diff(graph.indptr)
    dst = np.repeat(np.arange(graph.n_rows, dtype=np.int64), deg)
    boundary = np.zeros(graph.n_rows, dtype=bool)
    boundary[dst[part[graph.indices] != part[dst]]] = True
    out = []
    for r in range(k):
        local = np.flatnonzero(part == r)
        out.append(np.concatenate([local[~boundary[local]], local[boundary[local]]]))
    return out


def dist_prepare(sizes: Sizes, graph: str, work: str, ready) -> dict:
    """Phase 23's host work for one graph, in a worker process: the dataset,
    ``hierarchical_partition(graph, 4)``, one ``DistributedGraph`` for each
    distinct effective aggregation of the graph's runs (``br=8, bc=32``),
    each run's plan (``lower_distributed``), and each rank's slice of the
    graph and of the plan pickled into ``work``; then a message on
    ``ready`` (the runs' files: the ranks can start), and only then each
    plan through ``verify_plan`` in fast and in full mode, timed, while
    the ranks train (a violation raises when the parent reads the
    result). Returns the host seconds, the partition's and the graph's
    shapes, the plan dumps, the verification, the files and each rank's
    global row ids."""
    t0 = time.perf_counter()
    ds = dist_dataset(sizes, graph)
    host = {"dataset_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    part = hierarchical_partition(ds.graph, DIST_RANKS)
    host["partition_s"] = time.perf_counter() - t0
    gids = rank_global_ids(ds.graph, part.assignment, DIST_RANKS)
    dists, runs = {}, {}
    for run in dist_runs(sizes, graph):
        cfg = GNNConfig(kind=run["arch"], layer_dims=[
            ds.features.shape[1], *run["hidden"], ds.n_classes],
            aggregation=run["aggregation"], gat_heads=run["heads"])
        agg = effective_aggregation(cfg)
        if agg not in dists:
            t0 = time.perf_counter()
            d = build_distributed_graph(ds.graph, ds.features, ds.labels,
                                        ds.train_mask, part, br=DIST_BR,
                                        bc=DIST_BC, aggregation=agg)
            host[f"build_{agg}_s"] = time.perf_counter() - t0
            for r, ids in enumerate(gids):  # the rows are where gids says
                if not (int(d.n_valid[r]) == ids.size and np.array_equal(
                        d.features[r, : ids.size], ds.features[ids])
                        and np.array_equal(d.labels[r, : ids.size], ds.labels[ids])):
                    raise AssertionError(f"[dist] rank {r}'s rows are not its "
                                         "global ids' rows")
            files = []
            for r in range(DIST_RANKS):
                files.append(os.path.join(work, f"{graph}-{agg}-rank{r}.pkl"))
                with open(files[-1], "wb") as fh:
                    pickle.dump(d.rank_slice(r, bulk=False), fh, protocol=5)
            dists[agg] = (d, files)
        d, files = dists[agg]
        t0 = time.perf_counter()
        plan = lower_distributed(cfg, d, inner="cuda", validate="off")
        lower_s = time.perf_counter() - t0
        if plan.overlap is None:
            raise AssertionError(f"[dist] {run['name']}: the plan must bind the "
                                 "split-phase compositions")
        plan_files = []
        for r in range(DIST_RANKS):
            plan_files.append(os.path.join(work, f"{run['name']}-plan-rank{r}.pkl"))
            with open(plan_files[-1], "wb") as fh:
                pickle.dump(plan.rank_slice(r), fh, protocol=5)
        runs[run["name"]] = {
            "config": {"kind": cfg.kind, "layer_dims": list(cfg.layer_dims),
                       "aggregation": cfg.aggregation, "gat_heads": cfg.gat_heads},
            "plan": plan.describe(),
            "sparse0": plan.layers[0].feature_path == "sparse",
            "agg_primitives": [l.agg_primitive for l in plan.layers],
            "lower_s": lower_s, "dist_files": files, "plan_files": plan_files,
            "_plan": (plan, agg)}
    ready.put({"graph": graph, "host_s": dict(host), "runs": {
        name: {k: v for k, v in r.items() if k != "_plan"}
        for name, r in runs.items()}})
    for name, r in runs.items():
        plan, agg = r.pop("_plan")
        r["verify"] = {}
        for mode in ("fast", "full"):
            t0 = time.perf_counter()
            found = verify_plan(plan, mode=mode, dist=dists[agg][0])
            r["verify"][f"{mode}_ms"] = (time.perf_counter() - t0) * 1e3
            if found:
                raise AssertionError(f"[dist] {name} {mode} verification: "
                                     + "; ".join(str(v) for v in found))
    shapes = {agg: {"n_local": d.n_local, "n_ghost": d.n_ghost,
                    "max_send": d.max_send, "live_shifts": list(d.live_shifts),
                    "n_valid": d.n_valid.tolist(),
                    "n_interior": d.n_interior.tolist(),
                    "fwd_blocks": int(d.fwd["rows"].shape[1]),
                    "interior_blocks": d.interior_blocks.tolist(),
                    "boundary_blocks": d.boundary_blocks.tolist()}
              for agg, (d, _) in dists.items()}
    return {"graph": graph, "nodes": ds.graph.n_rows, "nnz": ds.graph.nnz,
            "host_s": host, "partition": {
                "phase": part.phase, "edge_cut": part.edge_cut,
                "vertex_imbalance": part.vertex_imbalance,
                "load_imbalance": part.load_imbalance},
            "shapes": shapes, "runs": runs, "gids": gids, "partition_result": part}


def params_digest(params) -> str:
    h = hashlib.sha256()
    for p in tree_leaves(params):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _stream_of(ops: dict, args: tuple) -> str:
    """The bound stream a recorded call ran on: its blocks' count and its
    output rows (``n_rows_padded``) against each operand's."""
    blocks = args[2]
    for name, op in ops.items():
        if op.blocks.shape == blocks.shape and torch.equal(op.block_rows, args[0]):
            return name
    raise AssertionError("a recorded call ran on no bound operand")


def _coo_library(op) -> torch.Tensor:
    """The operand as a ``torch.sparse`` CSR tensor (its nonzeros): the
    library yardstick's operand, never used by the port."""
    b, i, j = torch.nonzero(op.blocks, as_tuple=True)
    rows = op.block_rows.long()[b] * op.br + i
    cols = op.block_cols.long()[b] * op.bc + j
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), op.blocks[b, i, j],
            (op.n_rows_padded, op.n_cols_padded)).coalesce().to_sparse_csr()


def dist_call_rows(calls: list, ops: dict, device, reps: int = 3) -> list:
    """Each recorded kernel call of one step on this rank: against its
    plain version on the same inputs (``check_call``), its CUDA-event ms (median over ``reps`` launches after one), the plain
    version's, the library call's (``torch.sparse.mm`` on the stream, and
    the epilogue's torch ops; none for the attention passes) and the
    bound."""
    plain = kops._EXECUTORS["torch"]
    kernel = kops._EXECUTORS["cuda"]
    rows, libs = [], {}
    for i, (op_key, args, kw, got) in enumerate(calls):
        name = SOAK_OPS[op_key]
        stream = _stream_of(ops, args)
        op = ops[stream]
        err = check_call(f"[dist] {name} call {i} on {stream}", op_key, args,
                         kw, got)
        nzc = op.nonzero_columns()
        row = {"kernel": name, "stream": stream, "call": i, "max_abs_err": err,
               "ms": time_ms(lambda: kernel[op_key](*args, nzc=nzc, **kw), device,
                             reps, warmup=1),
               "plain_ms": time_ms(lambda: plain[op_key](*args, **kw), device, 1,
                                   warmup=0)}
        if op_key in ("attn_fwd", "attn_row", "attn_col"):
            heads = args[-1]
            hd = args[5].shape[1]
            row.update(attention_bound(args[0], args[1], args[2], heads, hd,
                                       args[-2], op_key[5:]))
            row["library_ms"] = None
        else:
            x = args[3]
            f = x.shape[1]
            if stream not in libs:
                libs[stream] = _coo_library(op)
            lib = libs[stream]
            if op_key == "spmm":
                row.update(spmm_bound(args[0], args[1], args[2], f, args[4]))
                lib_fn = lambda: torch.sparse.mm(lib, x)  # noqa: E731
            elif op_key == "masked":
                row.update(fused_bound(op, f, False, False, False, masked=True))
                mask = args[4]
                lib_fn = lambda: torch.sparse.mm(lib, x * mask)  # noqa: E731
            else:
                self_term, bias, alpha, act = args[5], args[6], args[7], args[8]
                row.update(fused_bound(op, f, self_term is not None, bias is not None,
                                       act == "relu"))

                def lib_fn(x=x, self_term=self_term, bias=bias, alpha=alpha, act=act):
                    y = torch.sparse.mm(lib, x)
                    if self_term is not None:
                        y = y + alpha * self_term
                    if bias is not None:
                        y = y + bias
                    return torch.relu(y) if act == "relu" else y
            row["library_ms"] = time_ms(lib_fn, device, reps, warmup=1)
        rows.append(row)
    return rows


def _layer_exchanges(records: list) -> list:
    """The instrumented step's exchange records, one line per layer and
    direction: pack and copy out, wire, copy in, the interior kernel's
    CUDA-event ms beside the wire and whether it had started (and ended)
    by the time the wire finished."""
    keys = ("layer", "dir", "f", "bytes", "pack_ms", "wire_ms", "copy_in_ms",
            "finish_ms", "interior_ms", "probe_started_in_wire",
            "probe_done_in_wire")
    return [{k: r[k] for k in keys if k in r} for r in records]


def dist_profiled_step(tr, device, profile_it: bool) -> dict:
    """One more step on every rank (their collectives keep the ranks in
    step); where ``profile_it``, under the profiler (CUDA activity: this
    process's kernels, copies and memsets alone): device ms and launches
    by kernel class, busy ms, and the idle share of the step's
    synchronised wall time."""
    if not (profile_it and device.type == "cuda"):
        tr.train_epoch()
        return {"complete": False}
    sync(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_epoch()  # reads the loss: synchronised
            wall = (time.perf_counter() - t0) * 1e3
    by, launched = defaultdict(float), defaultdict(int)
    for name, us, n in device_events(prof):
        by[classify(name)] += us / 1e3
        launched[launch_key(name)] += n
    busy = sum(by.values())
    return {"complete": busy > 0, "step_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "device_ms": dict(by),
            "launches": dict(launched)}


def dist_rank_run(rank: int, spec: dict, device) -> dict:
    """One phase-23 run on this rank: its slices loaded, the trainer bound
    (the fused Adam kernel), one probe step (``loss_and_grads``; rank 0
    records every kernel call and every rank its ReLU masks), the epochs
    timed (synchronised: ``train_epoch`` reads the loss) with a digest of
    the parameters after each, the launches counted from 0 over the probe
    and the epochs; then one more step, profiled on rank 0
    (``dist_profiled_step``), and one more probe with the exchange's
    timing records on, and on rank 0 every recorded call held against its plain version
    (``dist_call_rows``) and the Adam kernel against its plain version and
    timed on the run's leaves."""
    t0 = time.perf_counter()
    with open(spec["dist_files"][rank], "rb") as fh:
        dist = pickle.load(fh)
    with open(spec["plan_files"][rank], "rb") as fh:
        plan = pickle.load(fh)
    load_s = time.perf_counter() - t0
    cfg = GNNConfig(**spec["config"])
    _, lr, b1, b2 = spec["opt"]
    t0 = time.perf_counter()
    tr = DistributedGNNTrainer(dist, cfg, adam(lr, b1, b2, fused=True), plan=plan,
                               params=params_from_jax(spec["weights"], device),
                               device=device)
    sync(device)
    bind_s = time.perf_counter() - t0
    masks, calls = [], []
    zero_counts()
    with contextlib.ExitStack() as stack:
        if rank == 0:
            stack.enter_context(recorded_calls(calls))
        stack.enter_context(fused_executor("cuda", relu_recorder(masks)))
        loss0, grads0 = tr.loss_and_grads()
        loss0 = float(loss0)
    losses, epoch_ms, digests = [], [], []
    for _ in range(spec["epochs"]):
        sync(device)
        t0 = time.perf_counter()
        losses.append(tr.train_epoch())
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(params_digest(tr.params))
    launched = counts()
    profiled_step = dist_profiled_step(tr, device, rank == 0)
    tr.halo.timings = []
    sync(device)
    t0 = time.perf_counter()
    tr.loss_and_grads()
    sync(device)
    probe_ms = (time.perf_counter() - t0) * 1e3
    exchanges = _layer_exchanges(tr.halo.timings)
    tr.halo.timings = None
    n = int(dist.n_valid[0])
    out = {"rank": rank, "load_s": load_s, "bind_s": bind_s, "loss0": loss0,
           "losses": losses, "epoch_ms": epoch_ms,
           "epoch_ms_median": float(np.median(epoch_ms)), "digests": digests,
           "launches": launched, "instrumented_step_ms": probe_ms,
           "profiled_step": profiled_step,
           "exchanges": exchanges, "n_valid": n,
           "masks": [m[:n].cpu().numpy() > 0 for m in masks],  # the ReLU's decisions
           "operand_blocks": {k: int(op.blocks.shape[0]) for k, op in tr.operands.items()},
           "peak_mem_bytes": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0}
    if rank == 0:
        out["grads"] = [g.cpu().numpy() for g in tree_leaves(grads0)]
        t0 = time.perf_counter()
        out["calls"] = dist_call_rows(calls, tr.operands, device)
        del calls
        lr_t = bias_corrected_lr(lr, b1, b2, 1)
        leaves = list(zip(tree_leaves(tr.params), tree_leaves(grads0),
                          tree_leaves(tr.opt_state.m), tree_leaves(tr.opt_state.v)))
        out["adam_err"] = check_adam(f"dist {spec['name']}", leaves, lr_t, device, 1)
        out["adam"] = adam_row(f"dist {spec['name']}", leaves, lr_t, device, reps=5)
        out["check_s"] = time.perf_counter() - t0
    print(f"[dist] rank {rank} {spec['name']}: loaded in {load_s:.1f}s, bound in "
          f"{bind_s:.1f}s, epoch {out['epoch_ms_median']:.1f} ms (median of "
          f"{len(epoch_ms)}), losses {losses[0]:.4f} -> {losses[-1]:.4f}"
          + (f", rank 0's checks {out['check_s']:.1f}s" if rank == 0 else ""),
          flush=True)
    return out


def dist_rank(rank: int, specs: list) -> dict:
    """What each phase-23 rank process runs: every run in turn."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    out = {}
    for spec in specs:
        out[spec["name"]] = dist_rank_run(rank, spec, device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def dist_reference(run: dict, ds, device) -> dict:
    """The single-device cuda program of a run on the whole graph (fused
    Adam), from seed 0: its parameters (the ranks start from them), its
    epochs' losses and synchronised times; the program is kept for the
    gradient gate."""
    dims = [ds.features.shape[1], *run["hidden"], ds.n_classes]
    gnn = (GNNProgram.load(ds, arch=run["arch"], aggregation=run["aggregation"],
                           gat_heads=run["heads"])
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*run["opt"]))
    t0 = time.perf_counter()
    prog = gnn.compile(engine="cuda", device=device, fused_optimizer=True)
    sync(device)
    build_s = time.perf_counter() - t0
    if prog.plan.layout is not None and prog.plan.layout.permutes:
        raise AssertionError("[dist] the single-device program must keep the "
                             "graph's order")
    weights = {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                          for layer in prog.params["layers"]]}
    p0 = {"layers": [{k: v.detach().clone() for k, v in layer.items()}
                     for layer in prog.params["layers"]]}
    losses, times = [], []
    for _ in range(run["epochs"]):
        t0 = time.perf_counter()
        losses.append(prog.train_epoch()["loss"])  # float(): synchronised
        times.append((time.perf_counter() - t0) * 1e3)
    return {"prog": prog, "p0": p0, "weights": weights, "losses": losses,
            "epoch_ms": times, "epoch_ms_median": float(np.median(times)),
            "build_s": build_s, "plan": prog.describe_plan()}


def dist_alone_epoch_ms(ref: dict, epochs: int) -> float:
    """The single-device program's epoch once the ranks have returned and
    the host's workers are done (its first epochs ran beside them):
    ``epochs`` more epochs, synchronised, the median."""
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        ref["prog"].train_epoch()  # reads the loss: synchronised
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dist_gradient_gate(name: str, ref: dict, ranks: list, gids: list) -> dict:
    """The first step, distributed against single-device at the same
    parameters: the loss within 1e-4, each gradient leaf within GRAD_RTOL
    (norm of the difference over the leaf's). Where the two programs'
    ReLU decisions part (the fused kernels sum in other orders), the
    single-device program takes the distributed program's decision, as
    ``decided_grads`` does, and every such element must lie within
    MASK_MARGIN of 0."""
    prog, p0 = ref["prog"], ref["p0"]
    n = prog.x.shape[0]
    n_masks = len(ranks[0]["masks"])
    want = []
    for c in range(n_masks):
        g = np.zeros((n, ranks[0]["masks"][c].shape[1]), dtype=np.float32)
        for r, ids in enumerate(gids):
            g[ids] = ranks[r]["masks"][c]
        want.append(torch.from_numpy(g).to(prog.x.device))
    calls = []
    with fused_executor("cuda", relu_decider(want, calls)):
        loss, grads = value_and_grad(prog.model.loss_fn, p0, prog.x, prog.labels,
                                     prog.train_mask)
    if len(calls) != n_masks:
        raise AssertionError(f"[dist] {name}: {n_masks} ReLU calls distributed, "
                             f"{len(calls)} on one device")
    dist_grads = tree_unflatten(p0, [torch.from_numpy(g).to(prog.x.device)
                                     for g in ranks[0]["grads"]])
    out = {"loss": ranks[0]["loss0"], "ref_loss": float(loss),
           "loss_diff": abs(ranks[0]["loss0"] - float(loss)),
           "grads": leaf_diffs(dist_grads, grads), "relu_decisions": calls}
    print(f"[dist] {name} first step against one device: {json.dumps(out)}")
    if any(c["beyond_margin"] for c in calls):
        raise AssertionError(f"[dist] {name}: ReLU masks differ beyond |pre| > "
                             f"{MASK_MARGIN}: {calls}")
    if not out["loss_diff"] <= TOL:
        raise AssertionError(f"[dist] {name}: first loss {out['loss']} against "
                             f"{out['ref_loss']}")
    if not max(out["grads"].values()) <= GRAD_RTOL:
        raise AssertionError(f"[dist] {name}: gradients differ: {out['grads']}")
    return out


#: each run's kernels, launched on every rank (and Adam once a step)
DIST_KERNELS = {
    "gcn": ("bsr_spmm_fused_epilogue", "bsr_spmm_masked", "bsr_spmm", "fused_adam"),
    "gat": ("bsr_attention_fwd", "bsr_attention_bwd_row", "bsr_attention_bwd_col",
            "fused_adam"),
    "sage": ("bsr_spmm", "bsr_spmm_fused_epilogue", "bsr_spmm_masked", "fused_adam"),
}


def dist_run_gates(name: str, run: dict, ref: dict, ranks: list,
                   on_card: bool) -> dict:
    """A run's gates beyond the first step: every rank's losses equal, each
    epoch within 1e-3 relative of the single-device program's, falling;
    the ranks' parameters bitwise equal after every epoch (digests); each
    of the run's kernels launched on every rank, and nothing else."""
    r0 = ranks[0]
    for r in ranks[1:]:
        if r["losses"] != r0["losses"] or r["digests"] != r0["digests"]:
            raise AssertionError(f"[dist] {name}: rank {r['rank']} parted from "
                                 f"rank 0: {r['losses']} vs {r0['losses']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
    if not (np.isfinite(r0["losses"]).all() and max(rel) <= 1e-3):
        raise AssertionError(f"[dist] {name}: losses {r0['losses']} against one "
                             f"device's {ref['losses']}")
    if not r0["losses"][-1] < r0["losses"][0]:
        raise AssertionError(f"[dist] {name}: the loss did not fall: {r0['losses']}")
    on_path = set(DIST_KERNELS[name])
    for r in ranks if on_card else ():  # CPU tensors launch nothing
        missing = [k for k in on_path if not r["launches"][k]]
        stray = [k for k, v in r["launches"].items() if v and k not in on_path]
        if missing or stray:
            raise AssertionError(f"[dist] {name} rank {r['rank']}: kernels not "
                                 f"launched {missing}, launched off the path "
                                 f"{stray}: {r['launches']}")
        if r["launches"]["fused_adam"] != len(r["losses"]):
            raise AssertionError(f"[dist] {name}: Adam launched "
                                 f"{r['launches']['fused_adam']} times in "
                                 f"{len(r['losses'])} steps")
    return {"max_rel_diff": max(rel), "rel": rel}


def dist_kernel_summary(rows: list) -> dict:
    """Rank 0's step, per kernel: the calls, their ms, plain ms, library
    ms and bounds summed, per stream and in all."""
    out = {}
    for name in sorted({r["kernel"] for r in rows}):
        mine = [r for r in rows if r["kernel"] == name]

        def total(sel):
            t = {k: (None if any(r.get(k) is None for r in sel)
                     else sum(r[k] for r in sel))
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flop")}
            _, t["bound_by"] = _bound(t["bytes"], t["flop"])
            t["calls"] = len(sel)
            t["max_abs_err"] = max(r["max_abs_err"] for r in sel)
            return t

        out[name] = {**total(mine), "by_stream": {
            s: total([r for r in mine if r["stream"] == s])
            for s in sorted({r["stream"] for r in mine})}}
    return out


def distributed_phase(sizes: Sizes, device) -> dict:
    """Phase 23: runs (a) GCN and (b) GAT on the ogbn-arxiv analog and (c)
    SAGE-mean on the corafull analog, each on ``DIST_RANKS`` rank processes
    that share the card (gloo, ``launch/mesh.py:run_ranks``). Two worker
    processes do the host work (``dist_prepare``) while the single-device
    programs of the three runs train on the card (``dist_reference``);
    once the workers have written the ranks' files, one spawn runs every
    run on every rank (``dist_rank``) while the workers verify the plans
    in full, and the gates hold each run to the single-device program."""
    t_phase = time.perf_counter()
    runs = dist_runs(sizes)
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Manager() as manager, concurrent.futures.ProcessPoolExecutor(
                2, mp_context=ctx) as pool:
            ready = manager.Queue()
            futures = {g: pool.submit(dist_prepare, sizes, g, work, ready)
                       for g in ("arxiv", "corafull")}
            refs = {}
            for graph in ("arxiv", "corafull"):
                ds = dist_dataset(sizes, graph)
                for run in dist_runs(sizes, graph):
                    refs[run["name"]] = dist_reference(run, ds, device)
                    print(f"[dist] {run['name']} on one device: plan\n"
                          f"{refs[run['name']]['plan']}\nlosses "
                          f"{refs[run['name']]['losses']}, epoch "
                          f"{refs[run['name']]['epoch_ms_median']:.2f} ms")
                del ds
            ref_s = time.perf_counter() - t_phase
            files = {}
            while len(files) < len(futures):
                try:
                    msg = ready.get(timeout=5)
                except queue.Empty:
                    for f in futures.values():
                        if f.done():
                            f.result()  # a worker that failed raises here
                    continue
                files[msg["graph"]] = msg
            host_s = time.perf_counter() - t_phase
            specs = []
            for run in runs:
                p = files[run["graph"]]["runs"][run["name"]]
                specs.append({"name": run["name"], "config": p["config"],
                              "opt": run["opt"], "epochs": run["epochs"],
                              "weights": refs[run["name"]]["weights"],
                              "dist_files": p["dist_files"],
                              "plan_files": p["plan_files"]})
            # the workers verify the plans in full while the ranks train
            t0 = time.perf_counter()
            ranks = run_ranks(dist_rank, DIST_RANKS, (specs,), device=device,
                              timeout_s=600)
            ranks_s = time.perf_counter() - t0
            prep = {g: f.result() for g, f in futures.items()}
        for g, p in prep.items():
            print(f"[dist] {g}: {p['nodes']} nodes, partition {json.dumps(p['partition'])}"
                  f", host {json.dumps(p['host_s'])}, shapes {json.dumps(p['shapes'])}")
            for name, r in p["runs"].items():
                print(f"[dist] {name} plan (lowered in {r['lower_s']:.2f}s; verified "
                      f"fast {r['verify']['fast_ms']:.1f} ms, full "
                      f"{r['verify']['full_ms']:.1f} ms, 0 violations, beside the "
                      f"ranks):\n{r['plan']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"runs": {}, "host_s": host_s, "ref_s": ref_s, "ranks_s": ranks_s,
           "prepare": {g: {k: v for k, v in p.items()
                           if k not in ("gids", "partition_result")}
                       for g, p in prep.items()},
           # the 4-way partitions, for phase 24 (taken out before the dump)
           "partitions": {g: p["partition_result"] for g, p in prep.items()}}
    for run in runs:
        name = run["name"]
        by_rank = [r[name] for r in ranks]
        prep_run = prep[run["graph"]]["runs"][name]
        if prep_run["sparse0"] != (name == "sage"):
            raise AssertionError(f"[dist] {name}: layer 0's path is "
                                 f"{'sparse' if prep_run['sparse0'] else 'dense'}")
        grad = dist_gradient_gate(name, refs[name], by_rank, prep[run["graph"]]["gids"])
        gates = dist_run_gates(name, run, refs[name], by_rank,
                               device.type == "cuda")
        launched = {k: sum(r["launches"][k] for r in by_rank) for k in KERNELS}
        out["runs"][name] = {
            "graph": run["graph"], "arch": run["arch"], "epochs": run["epochs"],
            "losses": by_rank[0]["losses"], "ref_losses": refs[name]["losses"],
            "max_rel_diff": gates["max_rel_diff"], "first_step": grad,
            "epoch_ms_median": [r["epoch_ms_median"] for r in by_rank],
            "epoch_ms": [r["epoch_ms"] for r in by_rank],
            "ref_epoch_ms_median": refs[name]["epoch_ms_median"],
            "ref_build_s": refs[name]["build_s"],
            "bind_s": [r["bind_s"] for r in by_rank],
            "load_s": [r["load_s"] for r in by_rank],
            "instrumented_step_ms": [r["instrumented_step_ms"] for r in by_rank],
            "exchanges": [r["exchanges"] for r in by_rank],
            "operand_blocks": [r["operand_blocks"] for r in by_rank],
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in by_rank],
            "launches": launched, "launches_by_rank": [r["launches"] for r in by_rank],
            "kernels": dist_kernel_summary(by_rank[0]["calls"]),
            "profiled_step": by_rank[0]["profiled_step"],
            "calls": by_rank[0]["calls"], "adam": by_rank[0]["adam"],
            "adam_err": by_rank[0]["adam_err"], "check_s": by_rank[0]["check_s"],
            "plan": prep_run["plan"], "verify": prep_run["verify"],
            "lower_s": prep_run["lower_s"],
            "ref_epoch_ms_alone_median": dist_alone_epoch_ms(refs[name], run["epochs"])}
        del refs[name]["prog"]
    out["s"] = time.perf_counter() - t_phase
    return out


def distributed_entries(entries: list, p23: dict, alone: bool) -> None:
    """Phase 23 beside its kernels' entries: each run's launches over its
    four ranks (paths ``distributed_<run>``), ``max_abs_err`` over rank 0's
    calls of one step and the Adam check, and each kernel's calls of that
    step on the split streams (``distributed``: ms, plain ms, library ms,
    bounds, per stream). Alone (``--phases 23``), the entries take their
    top-level numbers from the runs that launched them."""
    by_name = {e["name"]: e for e in entries}
    for name, run in p23["runs"].items():
        for e in entries:
            n = run["launches"][e["name"]]
            e["launches_by_path"][f"distributed_{name}"] = n
            e["launches"] += n
        for k, s in run["kernels"].items():
            e = by_name[k]
            e["max_abs_err"] = max(e["max_abs_err"], s["max_abs_err"])
            e.setdefault("distributed", {})[name] = {
                **s, "shape": "rank 0's calls of one training step on its "
                              "interior and boundary streams (4 ranks), summed; "
                              "CUDA events"}
        adam = by_name["fused_adam"]
        adam["max_abs_err"] = max(adam["max_abs_err"], run["adam_err"])
        adam.setdefault("distributed", {})[name] = {
            k: run["adam"][k] for k in ("ms", "ms_by", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "params")}
    if not alone:
        return
    for e in entries:
        runs = e.get("distributed")
        if not runs:
            continue
        first = next(iter(runs.values()))
        e.update({"route": "cuda", "source": SOURCES[e["name"]][0],
                  "replaces": SOURCES[e["name"]][1]})
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            e[k] = first[k]


def print_distributed_summary(m: dict, card: str) -> None:
    """Phase 23's lines: per run the epochs of every rank beside the
    single-device epoch, the first step's gaps, the exchange per layer on
    rank 0 and whether the interior kernel ran inside the wire's window,
    each kernel's ms on the split streams, the host's seconds."""
    for g, p in m["prepare"].items():
        print(f"[dist] {g}: partition {p['partition']['phase']} in "
              f"{p['host_s']['partition_s']:.1f}s, builds "
              + ", ".join(f"{k} {v:.1f}s" for k, v in p["host_s"].items()
                          if k.startswith("build"))
              + f" on the host (worker processes) on {card}")
    for name, r in m["runs"].items():
        fs = r["first_step"]
        print(f"[dist] {name} ({r['arch']} on {r['graph']}, 4 ranks on one card): epoch "
              f"{', '.join(f'{x:.1f}' for x in r['epoch_ms_median'])} ms by rank "
              f"(one device {r['ref_epoch_ms_alone_median']:.2f} ms alone, "
              f"{r['ref_epoch_ms_median']:.2f} beside the host's workers), losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, max rel diff "
              f"{r['max_rel_diff']:.2e}, first loss gap {fs['loss_diff']:.2e}, "
              f"grads {max(fs['grads'].values()):.2e} on {card}")
        ps = r["profiled_step"]
        if ps["complete"]:
            print(f"[dist] {name} rank 0 profiled step: {ps['step_ms']:.1f} ms, the card "
                  f"busy {ps['busy_ms']:.2f} ms with this rank's work (idle "
                  f"{ps['idle_share']:.1%}): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(ps["device_ms"].items(),
                                                        key=lambda kv: -kv[1])))
        else:
            print(f"[dist] {name} rank 0 profiled step: not measured")
        for e in r["exchanges"][0]:
            print(f"[dist] {name} rank 0 layer {e['layer']} {e['dir']} (F {e['f']}, "
                  f"{e['bytes'] / 2**20:.1f} MiB out): pack {e['pack_ms']:.2f} ms, "
                  f"wire {e['wire_ms']:.2f}, copy in {e['copy_in_ms']:.2f}"
                  + (f", interior kernel {e['interior_ms']:.3f} ms, started in the "
                     f"wire {e['probe_started_in_wire']}, done "
                     f"{e['probe_done_in_wire']}" if "interior_ms" in e else ""))
        for k, s in r["kernels"].items():
            print(f"[dist] {name} {k}: {s['calls']} calls a step on rank 0, "
                  f"{s['ms']:.3f} ms (plain {s['plain_ms']:.1f}, library "
                  f"{'-' if s['library_ms'] is None else format(s['library_ms'], '.3f')}"
                  f", bound {s['bound_ms']:.3f}): "
                  + "; ".join(f"{st} {v['ms']:.3f}" for st, v in s["by_stream"].items()))
    print(f"[dist] phase 23 in {m['s']:.1f}s: host {m['host_s']:.1f}s (one device "
          f"{m['ref_s']:.1f}s beside it), ranks {m['ranks_s']:.1f}s")


# ---------------------------------------------------------------------------
# Phase 24: host-streamed strips on the card, and the resilience plane
# ---------------------------------------------------------------------------

#: path A's operand: ``build_streamed_operand(graph, "gcn", k_shards=4,
#: budget_bytes=...)`` from this budget, halved until A and Aᵀ each cut
#: into at least ``STREAM_MIN_STRIPS`` strips
STREAM_BUDGET = 128 << 20
STREAM_MIN_STRIPS = 8
STREAM_EPOCHS = 5
#: path B: the JAX package's rank-death schedule (a NaN gradient at step 1,
#: rank 2 dead from step 3, 12 epochs) and a straggler schedule (rank 1 8x
#: slower from step 2, 6 epochs), SAGE-mean on the corafull analog; a
#: monitor timeout of 0 (one missed beat is DEAD)
RESILIENT_EPOCHS = 12
STRAGGLER_EPOCHS = 6
#: (e): the soak's first schedules whose target is ``distributed``
SOAK_DIST_SCHEDULES = 8


def streamed_operand(ds, assignment) -> tuple:
    """Path A's operand, its budget and its build seconds."""
    budget = STREAM_BUDGET
    while True:
        t0 = time.perf_counter()
        op = build_streamed_operand(ds.graph, "gcn", k_shards=4, budget_bytes=budget,
                                    assignment=assignment)
        build_s = time.perf_counter() - t0
        if min(op.fwd.n_strips, op.bwd.n_strips) >= STREAM_MIN_STRIPS:
            return op, budget, build_s
        budget //= 2


def strip_passes(timeline: list) -> list:
    """A card timeline's records, one list a pass (a pass starts at strip 0)."""
    passes = []
    for e in timeline:
        if e["strip"] == 0:
            passes.append([])
        passes[-1].append(e)
    return passes


def pass_summary(records: list, f: int) -> dict:
    """One pass's per-strip copy and kernel ms (CUDA events), whether copy
    s + 1 ended inside kernel s (no later than its end), and the pass's
    span from the first copy's start to the last kernel's end."""
    copy = [r["copy"][0].elapsed_time(r["copy"][1]) for r in records]
    kernel = [r["kernel"][0].elapsed_time(r["kernel"][1]) for r in records]
    hidden = [records[s]["kernel"][0].elapsed_time(records[s + 1]["copy"][1])
              <= records[s]["kernel"][0].elapsed_time(records[s]["kernel"][1])
              for s in range(len(records) - 1)]
    return {"f": f, "strips": len(records), "copy_ms": copy, "kernel_ms": kernel,
            "copy_hidden": hidden, "bytes": [r["bytes"] for r in records],
            "span_ms": records[0]["copy"][0].elapsed_time(records[-1]["kernel"][1])}


def split_rows(st) -> list:
    """The block-rows a strip boundary cuts: (strip, block-row) where strip
    s - 1's last block and strip s's first are in one block-row."""
    return [(s, int(st.rows[s][0])) for s in range(1, st.n_strips)
            if st.rows[s - 1][-1] == st.rows[s][0]]


def strip_bound(st, s: int, f: int) -> dict:
    """Least time for one strip's y += A_s·X: its column stream read (the
    kernel's operand), the X rows its columns reference, and y read and
    written on the rows the strip touches; fp32 FMAs on its nonzeros."""
    c = st.columns[s]
    real = st.blocks[s] if s < st.n_strips - 1 else st.blocks[s][: st.n_blocks - s * st.blocks_per_strip]
    nz = real != 0
    b, _, j = np.nonzero(nz)
    x_rows = np.unique(st.cols[s][b].astype(np.int64) * real.shape[2] + j).size
    rows_touched = np.unique(st.rows[s][: real.shape[0]]).size * st.br
    nbytes = c.nbytes + 4 * x_rows * f + 2 * 4 * rows_touched * f
    flop = 2.0 * int(nz.sum()) * f
    ms, by = _bound(nbytes, flop)
    return {"bytes": nbytes, "flop": flop, "bound_ms": ms, "bound_by": by,
            "nnz": int(nz.sum()), "x_rows": int(x_rows), "rows": int(rows_touched)}


def strip_checks(name: str, st, f: int, device, gen) -> dict:
    """Each strip's accumulate launch (its column stream copied alone)
    against its plain version (``bsr_spmm_accum_ref`` on the strip's blocks)
    on the same y, within TOL, the rows a strip boundary splits apart."""
    x = torch.randn(st.n_cols_padded, f, device=device, generator=gen)
    y = torch.randn(st.n_rows_padded, f, device=device, generator=gen)
    split = split_rows(st)
    errs, split_errs = [], []
    for s in range(st.n_strips):
        c = st.columns[s]
        nzc = c.unpack(st.packed[c.offset:c.offset + c.nbytes].to(device), st.br,
                       st.n_rows_padded // st.br)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in (st.rows[s], st.cols[s], st.blocks[s])]
        want = bsr_spmm_accum_ref(y, *t, x, st.n_rows_padded)
        bsr_spmm_accumulate(nzc, x, y)
        errs.append(check_close(f"[stream] {name} strip {s}", y, want))
        for s2, brow in split:
            if s2 == s:
                rows = slice(brow * st.br, (brow + 1) * st.br)
                split_errs.append(check_close(f"[stream] {name} strip {s} split "
                                              f"block-row {brow}", y[rows], want[rows]))
        y = want  # the next strip adds to the plain version's sum
        del nzc, t
    return {"strips": st.n_strips, "max_abs_err": max(errs), "split_rows": len(split),
            "split_max_abs_err": max(split_errs) if split_errs else None}


def strip_times(st, s: int, f: int, device, gen) -> dict:
    """One strip's call at width f, its column stream on the card: the
    kernel's device ms (profiler), the plain version's and the library
    call's (``torch.addmm`` of the strip as a CSR tensor, y + A_s·X in one
    call) CUDA-event ms; then the alternative to the accumulate mode, a
    fresh y_s a strip (``bsr_spmm`` over the strip's stream with its empty
    block-rows kept, so it writes every row) and ``y.add_(y_s)``, timed
    over every strip of the operand beside the accumulate launches."""
    x = torch.randn(st.n_cols_padded, f, device=device, generator=gen)
    y = torch.zeros(st.n_rows_padded, f, device=device)
    c = st.columns[s]
    nzc = c.unpack(st.packed[c.offset:c.offset + c.nbytes].to(device), st.br,
                   st.n_rows_padded // st.br)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (st.rows[s], st.cols[s], st.blocks[s])]
    lib = _coo_library(types.SimpleNamespace(
        block_rows=t[0], block_cols=t[1], blocks=t[2], br=st.br, bc=t[2].shape[2],
        n_rows_padded=st.n_rows_padded, n_cols_padded=st.n_cols_padded))
    ms = device_ms(lambda: bsr_spmm_accumulate(nzc, x, y), device, 10,
                   {"bsr_spmm_accumulate": 1})
    out = {"strip": s, "f": f, "ms": ms,
           "ms_by": "profiler" if ms is not None else "cuda events",
           "wall_ms": time_ms(lambda: bsr_spmm_accumulate(nzc, x, y), device, 10),
           "plain_ms": time_ms(lambda: bsr_spmm_accum_ref(y, *t, x, st.n_rows_padded),
                               device, 3, warmup=1),
           "library_ms": time_ms(lambda: torch.addmm(y, lib, x), device, 10)}
    if out["ms"] is None:
        out["ms"] = out["wall_ms"]
    del lib, t
    cols = []
    for k in range(st.n_strips):  # every strip's stream resident: no copies timed
        ck = st.columns[k]
        cols.append(ck.unpack(st.packed[ck.offset:ck.offset + ck.nbytes].to(device),
                              st.br, st.n_rows_padded // st.br))
    full = []
    for k in range(st.n_strips):
        tk = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (st.rows[k], st.cols[k], st.blocks[k])]
        full.append((tk, nonzero_columns(*tk, st.n_rows_padded)))

    def accumulate():
        for nz in cols:
            bsr_spmm_accumulate(nz, x, y)

    def fresh():
        for tk, nz in full:
            y.add_(bsr_spmm(*tk, x, st.n_rows_padded, nzc=nz))

    out["pass_accumulate_ms"] = time_ms(accumulate, device, 5)
    out["pass_fresh_add_ms"] = time_ms(fresh, device, 5)
    return out


def streamed_path(ds, sizes: Sizes, device, assignment) -> dict:
    """Phase 24 (a): the resident cuda program of phase 4's GCN from seed 0
    (its first step's loss and gradients, ``STREAM_EPOCHS`` epochs and their
    peak allocation), then the same model on the streamed operand, as the
    JAX package's ``examples/host_streamed_demo.py`` trains it
    (``LayerOps(aggregate=op.aggregate)`` a layer, ``pipelined_value_and_grad``,
    fused Adam): the first step against the resident program's, the epochs
    timed with their launches counted from 0 and their peak allocation,
    one instrumented epoch (per strip, copy and kernel ms and the overlap),
    one profiled epoch; then every strip's accumulate call against its
    plain version and one strip timed."""
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    cfg = GNNConfig(kind="GCN", layer_dims=dims, aggregation="gcn")
    gnn = (GNNProgram.load(ds, arch="GCN", aggregation="gcn")
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*ADAM))
    t0 = time.perf_counter()
    prog = gnn.compile(engine="cuda", device=device, fused_optimizer=True)
    sync(device)
    res = {"build_s": time.perf_counter() - t0}
    p0 = {"layers": [{k: v.detach().clone() for k, v in layer.items()}
                     for layer in prog.params["layers"]]}
    ref_loss, ref_grads = value_and_grad(prog.model.loss_fn, p0, prog.x, prog.labels,
                                         prog.train_mask)
    ref_loss = float(ref_loss)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    res["losses"], res["epoch_ms"] = [], []
    for _ in range(STREAM_EPOCHS):
        t0 = time.perf_counter()
        res["losses"].append(prog.train_epoch()["loss"])
        res["epoch_ms"].append((time.perf_counter() - t0) * 1e3)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    res["epoch_ms_median"] = float(np.median(res["epoch_ms"]))
    del prog, gnn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    op, budget, build_s = streamed_operand(ds, assignment)
    out = {"resident": res, "build_s": build_s, "budget": budget,
           "strips": {"fwd": op.fwd.n_strips, "bwd": op.bwd.n_strips},
           "blocks_per_strip": {"fwd": op.fwd.blocks_per_strip,
                                "bwd": op.bwd.blocks_per_strip},
           "blocks": {"fwd": op.fwd.n_blocks, "bwd": op.bwd.n_blocks},
           "jax_total_nbytes": op.total_nbytes(), "jax_device_nbytes": op.device_nbytes(),
           "pinned_nbytes": op.pinned_nbytes(), "card_nbytes": op.card_nbytes(),
           "columns": {"fwd": sum(c.n_cols for c in op.fwd.columns),
                       "bwd": sum(c.n_cols for c in op.bwd.columns)}}
    print(f"[stream] operand built in {build_s:.1f}s at budget {budget >> 20} MiB: "
          f"{op.fwd.n_strips} + {op.bwd.n_strips} strips of {op.fwd.blocks_per_strip} / "
          f"{op.bwd.blocks_per_strip} blocks ({op.fwd.n_blocks} / {op.bwd.n_blocks} "
          f"blocks of 8x32); the JAX package's reckoning {op.total_nbytes() / 2**30:.2f} "
          f"GiB on the host, {op.device_nbytes() / 2**20:.1f} MiB on the device; "
          f"column streams {op.pinned_nbytes() / 2**20:.1f} MiB pinned, "
          f"{op.card_nbytes() / 2**20:.2f} MiB of strip buffers on the card", flush=True)
    x = torch.from_numpy(ds.features[op.order]).to(device)
    labels = torch.from_numpy(ds.labels[op.order]).to(device)
    mask = torch.from_numpy(ds.train_mask[op.order]).to(device)
    denom = mask.sum().to(torch.float32).clamp(min=1.0)
    fns = arch_layer_fns(cfg, [LayerOps(aggregate=op.aggregate)] * cfg.n_layers)
    opt = adam(ADAM[1], ADAM[2], ADAM[3], fused=True)
    params = {"layers": [{k: v.clone() for k, v in layer.items()}
                         for layer in p0["layers"]]}
    opt_state = opt.init(params)
    loss0, grads0 = pipelined_value_and_grad(fns, params, x, labels, mask, denom)
    first = {"loss": float(loss0), "ref_loss": ref_loss,
             "loss_diff": abs(float(loss0) - ref_loss),
             "grads": leaf_diffs(grads0, ref_grads)}
    print(f"[stream] first step against the resident program: {json.dumps(first)}")
    if not first["loss_diff"] <= TOL:
        raise AssertionError(f"[stream] first loss {first['loss']} against {ref_loss}")
    if not max(first["grads"].values()) <= GRAD_RTOL:
        raise AssertionError(f"[stream] gradients differ: {first['grads']}")
    del grads0, ref_grads
    sync(device)
    base = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    losses, times = [], []
    for _ in range(STREAM_EPOCHS):
        sync(device)
        t0 = time.perf_counter()
        loss, grads = pipelined_value_and_grad(fns, params, x, labels, mask, denom)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    per_epoch = len(dims) - 1
    want = {k: 0 for k in KERNELS}
    if on_card:  # CPU tensors launch nothing
        want["bsr_spmm_accumulate"] = STREAM_EPOCHS * per_epoch * (op.fwd.n_strips
                                                                   + op.bwd.n_strips)
        want["fused_adam"] = STREAM_EPOCHS
    if launched != want:
        raise AssertionError(f"[stream] launches {launched}, expected {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"[stream] losses {losses}")
    out.update(first_step=first, losses=losses, epoch_ms=times,
               epoch_ms_median=float(np.median(times)), launches=launched,
               peak_bytes=peak, base_bytes=base)
    # one instrumented epoch: each strip's copy and kernel between events
    widths = dims[1:]
    out["passes"] = {"fwd": [], "bwd": []}
    if on_card:
        op.fwd.timeline, op.bwd.timeline = [], []
        sync(device)
        pipelined_value_and_grad(fns, params, x, labels, mask, denom)
        sync(device)
        out["passes"] = {
            "fwd": [pass_summary(r, f)
                    for r, f in zip(strip_passes(op.fwd.timeline), widths)],
            "bwd": [pass_summary(r, f)
                    for r, f in zip(strip_passes(op.bwd.timeline), widths[::-1])]}
        op.fwd.timeline = op.bwd.timeline = None
        if [len(v) for v in out["passes"].values()] != [per_epoch, per_epoch]:
            raise AssertionError(f"[stream] an epoch made {out['passes']} passes")

    def epoch():
        loss, grads = pipelined_value_and_grad(fns, params, x, labels, mask, denom)
        with torch.no_grad():
            opt.update(grads, opt_state, params)

    out["profile"] = epoch_profile(epoch, device, out["epoch_ms_median"] / 1e3,
                                   {"bsr_spmm_accumulate": want["bsr_spmm_accumulate"]
                                    // STREAM_EPOCHS, "fused_adam": 1})
    del grads, params, opt_state, x, labels, mask
    gc.collect()
    out["op"] = op
    if not on_card:  # the kernel checks and times need the card
        return out
    gen = torch.Generator(device=device).manual_seed(24)
    out["checks"] = {name: strip_checks(name, st, widths[0], device, gen)
                     for name, st in (("fwd", op.fwd), ("bwd", op.bwd))}
    mid = op.fwd.n_strips // 2
    out["timed"] = strip_times(op.fwd, mid, widths[0], device, gen)
    out["timed"].update(strip_bound(op.fwd, mid, widths[0]))
    return out


def stream_faults(device) -> dict:
    """Phase 24 (b): the fetch's host half on the card, on the JAX demo's
    operand (corafull at scale 0.02, 96 KiB budget, checksums on): a
    fault that fails strip 1's fetch twice retries to a y bitwise equal to
    the clean pass's; a fault on every fetch raises ``StreamFetchError``
    naming strip 0, shard 5 and operand 'fwd' after 2 attempts; a flipped
    bit in a strip's pinned column stream raises ``StripChecksumError``
    (inside the ``StreamFetchError``) naming that strip."""
    ds = generate_dataset("corafull", scale=0.02, seed=0)
    rp = RetryPolicy(max_retries=1, base_delay_s=1e-5, max_delay_s=1e-4)
    op = build_streamed_operand(ds.graph, "gcn", k_shards=4, budget_bytes=96 * 1024,
                                retry=rp, shard_id=5, verify_fetch=True)
    x = torch.randn(op.n_nodes, 40, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    y0 = op.fwd.apply(x)
    inj = FaultInjector(seed=0, faults=[FaultSpec(site="prefetch", prob=1.0, count=1)])
    hook = inj.callback_hook("prefetch")
    op.fwd.fault_hook = lambda i: hook(("fwd", i)) if i == 1 else None
    y1 = op.fwd.apply(x)
    sync(device)
    if not (torch.equal(y0, y1) and inj.fired["prefetch"] == 1):
        raise AssertionError("[stream] a retried fetch changed y")
    op.fwd.fault_hook = lambda i: (_ for _ in ()).throw(OSError("pinned read failed"))
    try:
        op.fwd.apply(x)
        raise AssertionError("[stream] a failing fetch did not raise")
    except StreamFetchError as e:
        if (e.strip, e.shard, e.name, e.attempts) != (0, 5, "fwd", 2):
            raise AssertionError(f"[stream] fetch error fields: {e}")
        permanent = str(e)
    op.fwd.fault_hook = None
    c = op.bwd.columns[3]
    at = c.offset + c.sections[3] + 2

    def flip():  # on the card the pinned buffer the copy reads; off it the blocks
        if device.type == "cuda":
            op.bwd.packed[at] ^= 0x40
        else:
            op.bwd.blocks[3].reshape(-1).view(np.uint8)[6] ^= 0x40

    flip()
    try:
        op.bwd.apply(x)
        raise AssertionError("[stream] a corrupted strip passed")
    except StreamFetchError as e:
        if not (isinstance(e.cause, StripChecksumError) and e.cause.strip == 3):
            raise AssertionError(f"[stream] corruption raised {e!r}")
        corrupted = str(e)
    flip()
    if not torch.equal(op.bwd.apply(x), op.bwd.apply(x)):
        raise AssertionError("[stream] the repaired strip's pass does not repeat")
    out = {"retried_equal": True,
           "pinned": device.type == "cuda" and bool(op.bwd.packed.is_pinned()),
           "permanent": permanent, "corrupted": corrupted}
    print(f"[stream] faults on the card: {json.dumps(out)}")
    return out


#: phase 24 (c): the kernel calls rank 0 records at the start of each
#: segment and holds against their plain versions: one SAGE step's 12
#: (phase 23 (c) records the same 12 a step)
RESILIENT_CHECKED_CALLS = 12


def counted_segment_rank(rank: int, spec: dict) -> dict:
    """``ResilientDistributedTrainer``'s segment on this rank with its
    kernels' launches counted from 0 (every rank's gathered to rank 0);
    rank 0 also records the segment's first ``RESILIENT_CHECKED_CALLS``
    kernel calls and, after the segment, holds each against its plain
    version (``check_call``)."""
    import torch.distributed as tdist

    calls: list = []
    zero_counts()
    with (recorded_calls(calls, RESILIENT_CHECKED_CALLS) if rank == 0
          else contextlib.nullcontext()):
        out = ResilientDistributedTrainer.segment_rank(rank, spec)
    launched = [None] * tdist.get_world_size()
    tdist.all_gather_object(launched, counts())
    if rank == 0:
        n = len(launched)
        checks: dict = {}
        for i, (op, args, kw, got) in enumerate(calls):
            name = SOAK_OPS[op]
            err = check_call(f"[resilient] segment from step {spec['step']} on {n} "
                             f"ranks: {name} call {i}", op, args, kw, got)
            c = checks.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            c["calls"] += 1
            c["max_abs_err"] = max(c["max_abs_err"], err)
        out.update(launches_by_rank=launched, checks=checks)
    return out


class CountedResilientTrainer(ResilientDistributedTrainer):
    """The trainer with ``counted_segment_rank`` on its ranks: each
    segment's record gains every rank's launches and rank 0's checks."""

    segment_rank = staticmethod(counted_segment_rank)

    def _segment(self, end: int) -> dict:
        r0 = super()._segment(end)
        self.segments[-1].update(launches=r0["launches_by_rank"], checks=r0["checks"])
        return r0


def resilient_run(ds, cfg, device, faults, epochs: int, tmp: str, partition,
                  pool) -> dict:
    """One ``ResilientDistributedTrainer`` run (``CountedResilientTrainer``)
    on ``DIST_RANKS`` ranks sharing the card, on ``pool``; its events,
    segments, losses and guard, and the probe (loss and gradients) at the
    carried params."""
    t0 = time.perf_counter()
    with CountedResilientTrainer(
            ds.graph, ds.features, ds.labels, ds.train_mask, cfg,
            functools.partial(adam, ADAM[1], ADAM[2], ADAM[3], fused=True),
            n_ranks=DIST_RANKS, ckpt_dir=tmp, ckpt_every=2, guard=GuardPolicy(),
            injector=FaultInjector(seed=0, faults=faults), dead_timeout=0.0,
            straggler_factor=3.0, window=4, br=DIST_BR, bc=DIST_BC, device=device,
            timeout_s=600, partition=partition, pool=pool) as rt:
        build_s = time.perf_counter() - t0
        res = rt.fit(epochs=epochs)
        loss, grads = rt.loss_and_grads()
    return {"rt": rt, "out": res, "probe_loss": loss, "probe_grads": grads,
            "build_s": build_s, "s": time.perf_counter() - t0}


def resilient_launches(name: str, segments: list) -> dict:
    """Each segment's launches on every rank: each of the SAGE run's
    kernels (``DIST_KERNELS["sage"]``) launched on every rank, nothing
    else. Returns the launches summed over segments and ranks, and rank
    0's checks merged."""
    on_path = set(DIST_KERNELS["sage"])
    total = dict.fromkeys(KERNELS, 0)
    checks: dict = {}
    for i, sg in enumerate(segments):
        for r, launched in enumerate(sg["launches"]):
            missing = [k for k in on_path if not launched[k]]
            stray = [k for k, v in launched.items() if v and k not in on_path]
            if missing or stray:
                raise AssertionError(
                    f"[resilient] {name} segment {i} rank {r}: kernels not launched "
                    f"{missing}, launched off the path {stray}: {launched}")
            for k, v in launched.items():
                total[k] += v
        if sum(c["calls"] for c in sg["checks"].values()) < RESILIENT_CHECKED_CALLS:
            raise AssertionError(f"[resilient] {name} segment {i}: rank 0 checked "
                                 f"{sg['checks']}")
        for k, c in sg["checks"].items():
            m = checks.setdefault(k, {"calls": 0, "max_abs_err": 0.0})
            m["calls"] += c["calls"]
            m["max_abs_err"] = max(m["max_abs_err"], c["max_abs_err"])
    return {"launches": total, "checks": checks}


def resilient_gate(name: str, run: dict, prog, device) -> dict:
    """The carried params on the single-device cuda program ``prog``: the
    group's probe loss within 1e-4 and each gradient leaf within
    GRAD_RTOL."""
    rt = run["rt"]
    params = {"layers": [{k: v.to(device) for k, v in layer.items()}
                         for layer in rt.params["layers"]]}
    loss, grads = value_and_grad(prog.model.loss_fn, params, prog.x, prog.labels,
                                 prog.train_mask)
    got = tree_unflatten(params, [torch.from_numpy(g).to(device)
                                  for g in run["probe_grads"]])
    out = {"loss": run["probe_loss"], "ref_loss": float(loss),
           "loss_diff": abs(run["probe_loss"] - float(loss)),
           "grads": leaf_diffs(got, grads)}
    if not out["loss_diff"] <= TOL:
        raise AssertionError(f"[resilient] {name}: loss {out['loss']} against "
                             f"{out['ref_loss']} on one device")
    if not max(out["grads"].values()) <= GRAD_RTOL:
        raise AssertionError(f"[resilient] {name}: gradients differ: {out['grads']}")
    return out


def resilience_path(sizes: Sizes, device, partition, pool) -> dict:
    """Phase 24 (c): the rank-death and straggler schedules on the JAX
    package's ``examples/distributed_gnn.py`` model (SAGE-mean [8710, 16,
    70] on the corafull analog at full scale), 4 ranks sharing the card:
    the rank-death run ends on 3 ranks after one rescale from the step-2
    checkpoint with the NaN step skipped, the straggler run after one
    rebalance with the state carried bitwise; losses finite and falling;
    each run's carried params against the single-device program
    (``resilient_gate``)."""
    ds = dist_dataset(sizes, "corafull")
    cfg = GNNConfig(kind="SAGE", layer_dims=[ds.features.shape[1], 16, ds.n_classes],
                    aggregation="mean")
    schedules = {
        "rank_death": ([FaultSpec(site="rank_dead", steps=range(3, 10_000), rank=2,
                                  persistent=True),
                        FaultSpec(site="grad", steps=(1,), mode="nan")],
                       RESILIENT_EPOCHS),
        "straggler": ([FaultSpec(site="rank_slow", steps=range(2, 10_000), rank=1,
                                 factor=8.0)], STRAGGLER_EPOCHS)}
    t0 = time.perf_counter()
    prog = (GNNProgram.load(ds, arch=cfg.kind, aggregation=cfg.aggregation)
            .initialize_layers(list(cfg.layer_dims), "xavier", seed=0)
            .compile(engine="cuda", device=device, fused_optimizer=True))
    out = {"ref_build_s": time.perf_counter() - t0}
    for name, (faults, epochs) in schedules.items():
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "chiprun_out")) as tmp:
            run = resilient_run(ds, cfg, device, faults, epochs, tmp, partition, pool)
        res = run["out"]
        events = [{"step": e.step, "action": e.action, "recovery_s": e.recovery_s,
                   **{k: v for k, v in e.detail.items()}} for e in res["events"]]
        segs = [{k: v for k, v in sg.items() if k != "ready_at"} for sg in res["segments"]]
        losses = res["losses"]
        if not (len(losses) == epochs and np.isfinite(losses).all()
                and losses[-1] < losses[0]):
            raise AssertionError(f"[resilient] {name}: losses {losses}")
        if name == "rank_death":
            ok = (res["final_ranks"] == 3 and [e["action"] for e in events] == ["rescale"]
                  and res["guard"]["skipped"] >= 1 and events[0]["dead"] == [2])
        else:
            ok = (res["final_ranks"] == DIST_RANKS
                  and [e["action"] for e in events] == ["rebalance"]
                  and segs[1]["start_digest"] == segs[0]["end_digest"])
        if not ok:
            raise AssertionError(f"[resilient] {name}: {json.dumps(events)} "
                                 f"{json.dumps(segs)} guard {res['guard']}")
        gate = resilient_gate(name, run, prog, device)
        out[name] = {**resilient_launches(name, segs),
                     "events": events, "segments": segs, "losses": losses,
                     "guard": res["guard"], "final_ranks": res["final_ranks"],
                     "gate": gate, "builds": res["builds"], "build_s": run["build_s"],
                     "s": run["s"]}
        print(f"[resilient] {name}: {json.dumps(out[name])}", flush=True)
    del prog
    return out


def _psum_rank(rank: int, device) -> dict:
    """Phase 24 (d) on one rank: ``compressed_psum`` of this rank's
    gradients (the constant rank + 1, the JAX package's case, and a
    random tree of GCN [128, 256, 40]'s shapes) with a zero error buffer."""
    from repro_torch.training.grad import compressed_psum

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device.type == "cuda" else device)
    g = torch.Generator(device=dev).manual_seed(rank)
    grads = {"c": torch.full((64,), rank + 1.0, device=dev),
             "w0": torch.randn(128, 256, device=dev, generator=g),
             "w1": torch.randn(256, 40, device=dev, generator=g)}
    err = {k: torch.zeros_like(v) for k, v in grads.items()}
    means, errs = compressed_psum(grads, err)
    return {"grads": {k: v.cpu().numpy() for k, v in grads.items()},
            "means": {k: v.cpu().numpy() for k, v in means.items()},
            "errs": {k: v.cpu().numpy() for k, v in errs.items()}}


def psum_check(device, pool) -> dict:
    """Phase 24 (d): 4 ranks' ``compressed_psum`` against the exact mean:
    the ranks' means equal, the constant case within the JAX package's
    bound (< 0.2 of the true mean), every leaf's error against the exact
    mean printed beside its scale, and each rank's error buffer its own
    quantisation residual (g - mean never enters it)."""
    ranks = pool.run(_psum_rank, DIST_RANKS, (device,))
    out = {}
    for k in ranks[0]["means"]:
        exact = np.mean([r["grads"][k] for r in ranks], axis=0)
        for r in ranks[1:]:
            if not np.array_equal(r["means"][k], ranks[0]["means"][k]):
                raise AssertionError(f"[psum] {k}: ranks' means differ")
        out[k] = {"max_err": float(np.abs(ranks[0]["means"][k] - exact).max()),
                  "scale": float(np.abs(exact).max()),
                  "residual_max": max(float(np.abs(r["errs"][k]).max()) for r in ranks)}
    if not out["c"]["max_err"] < 0.2 * float(np.mean(np.arange(1, DIST_RANKS + 1))):
        raise AssertionError(f"[psum] {out['c']}")
    print(f"[psum] compressed_psum on {DIST_RANKS} ranks: {json.dumps(out)}")
    return out


def soak_distributed(device, pool) -> dict:
    """Phase 24 (e): the soak's distributed schedules among its first
    ``SOAK_DIST_SCHEDULES`` (every end-state property raises where it
    fails)."""
    t0 = time.perf_counter()
    rows = list(chaos_soak.soak(SOAK_DIST_SCHEDULES, 0, device,
                                os.path.join(ROOT, "chiprun_out", "chaos_soak"),
                                only=("distributed",), pool=pool))
    for r in rows:
        print(f"[chaos] {r}")
    return {"rows": rows, "s": time.perf_counter() - t0}


def streaming_phase(sizes: Sizes, device, partitions: Optional[dict]) -> dict:
    """Phase 24: (a) ``streamed_path``, (b) ``stream_faults``, (c)
    ``resilience_path``, (d) ``psum_check``, (e) ``soak_distributed``,
    (c)-(e) on one ``RankPool`` of ``DIST_RANKS`` processes;
    ``partitions`` are phase 23's 4-way partitions (``hierarchical_partition
    (graph, 4)``, the ones (a) and (c) make) where it ran, else each part
    partitions."""
    t_phase = time.perf_counter()
    partitions = partitions or {}
    ds = generate_dataset(sizes.dataset, scale=sizes.scale, seed=0)
    arxiv = partitions.get("arxiv")
    out = {"a": streamed_path(ds, sizes, device,
                              None if arxiv is None else arxiv.assignment)}
    del ds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t_phase
    out["b"] = stream_faults(device)
    # (c)-(e) on one pool of rank processes: spawned once, each group
    # formed anew (4 ranks, 3 after the rescale)
    t0 = time.perf_counter()
    with RankPool(DIST_RANKS, device=device, timeout_s=600) as pool:
        out["pool_s"] = time.perf_counter() - t0
        out["c"] = resilience_path(sizes, device, partitions.get("corafull"), pool)
        out["c_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["d"] = psum_check(device, pool)
        out["d_s"] = time.perf_counter() - t0
        out["e"] = soak_distributed(device, pool)
    out["s"] = time.perf_counter() - t_phase
    return out


def streaming_entries(entries: list, p24: dict) -> None:
    """The accumulate mode's entry from phase 24 (a): its launches on the
    streamed path (``streamed``), its largest error over every strip's
    check, one strip's call at F = 256 (device ms, plain ms, library ms,
    bound); every other kernel's launches on the path (Adam's); and each
    kernel's launches on (c)'s ranks over both schedules (``resilient``),
    with the largest error of rank 0's checked calls."""
    a = p24["a"]
    by_name = {e["name"]: e for e in entries}
    if "bsr_spmm_accumulate" not in by_name:
        entries.append({"name": "bsr_spmm_accumulate", "launches": 0,
                        "launches_by_path": {}, "max_abs_err": 0.0})
        by_name["bsr_spmm_accumulate"] = entries[-1]
    runs = [r for k, r in p24["c"].items() if k != "ref_build_s"]
    for e in entries:
        n = a["launches"][e["name"]]
        e["launches_by_path"]["streamed"] = n
        resilient = sum(r["launches"][e["name"]] for r in runs)
        e["launches_by_path"]["resilient"] = resilient
        e["launches"] += n + resilient
        for r in runs:
            if e["name"] in r["checks"]:
                e["max_abs_err"] = max(e["max_abs_err"],
                                       r["checks"][e["name"]]["max_abs_err"])
    e = by_name["bsr_spmm_accumulate"]
    if "timed" not in a:  # off the card: nothing launched, nothing timed
        return
    t = a["timed"]
    e.update({"route": "cuda", "source": SOURCES[e["name"]][0],
              "replaces": SOURCES[e["name"]][1],
              "max_abs_err": max(c["max_abs_err"] for c in a["checks"].values()),
              "ms": t["ms"], "ms_by": t["ms_by"], "plain_ms": t["plain_ms"],
              "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
              "bound_by": t["bound_by"],
              "shape": (f"one strip of A (strip {t['strip']} of {a['strips']['fwd']}, "
                        f"{t['nnz']} nonzeros, {t['rows']} rows touched) at F = "
                        f"{t['f']}: y += A_s X; library: torch.addmm(y, A_s as CSR, X)")})


def print_streaming_summary(m: dict, card: str) -> None:
    """Phase 24's lines, each beside the card's name and power limit."""
    a = m["a"]
    res = a["resident"]
    print(f"[stream] (a) arxiv GCN on streamed strips: {a['strips']['fwd']} + "
          f"{a['strips']['bwd']} strips at {a['budget'] >> 20} MiB, built in "
          f"{a['build_s']:.1f}s; epoch {a['epoch_ms_median']:.2f} ms (median of "
          f"{STREAM_EPOCHS}) against the resident program's "
          f"{res['epoch_ms_median']:.2f}; peak allocation {a['peak_bytes'] / 2**30:.2f} "
          f"GiB (held before the epochs {a['base_bytes'] / 2**30:.2f}) against "
          f"{res['peak_bytes'] / 2**30:.2f}; column streams {a['pinned_nbytes'] / 2**20:.1f}"
          f" MiB pinned, {a['card_nbytes'] / 2**20:.2f} MiB on the card; losses "
          f"{a['losses'][0]:.4f} -> {a['losses'][-1]:.4f}; accumulate launches "
          f"{a['launches']['bsr_spmm_accumulate']} on {card}")
    for side, passes in a["passes"].items():
        for p in passes:
            hid = sum(p["copy_hidden"])
            print(f"[stream] {side} pass at F {p['f']}: {p['strips']} strips, copy "
                  f"{np.median(p['copy_ms']):.3f} ms a strip ({sum(p['copy_ms']):.2f} in "
                  f"all, {sum(p['bytes']) / 2**20:.1f} MiB), kernel "
                  f"{np.median(p['kernel_ms']):.3f} ms a strip ({sum(p['kernel_ms']):.2f} "
                  f"in all), copy s+1 inside kernel s {hid}/{len(p['copy_hidden'])}, "
                  f"span {p['span_ms']:.2f} ms")
    if "timed" not in a:
        return
    pr = a["profile"]
    if pr.get("complete"):
        print(f"[stream] profiled epoch: busy {pr['busy_ms']:.2f} ms (both streams), "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(pr["device_ms"].items(),
                                                            key=lambda kv: -kv[1])))
    else:
        print("[stream] profiled epoch: not measured")
    t = a["timed"]
    print(f"[stream] accumulate strip {t['strip']} at F {t['f']}: {t['ms']:.4f} ms "
          f"({t['ms_by']}), plain {t['plain_ms']:.2f}, library {t['library_ms']:.4f}, "
          f"bound {t['bound_ms']:.4f} ({t['bound_by']}); a pass over A's strips: "
          f"accumulate {t['pass_accumulate_ms']:.3f} ms, fresh y_s + add_ "
          f"{t['pass_fresh_add_ms']:.3f} ms; checks "
          + json.dumps(a["checks"]) + f" on {card}")
    for name, r in m["c"].items():
        if name == "ref_build_s":
            continue
        segs = r["segments"]
        print(f"[resilient] {name}: " + "; ".join(
            f"{e['action']} at step {e['step']} recovery {e['recovery_s']:.2f}s (host "
            f"{e['host_s']:.2f}s)" for e in r["events"])
              + "; segments " + ", ".join(
                  f"{sg['ranks']} ranks {sg['steps']} steps, started in {sg['start_s']:.1f}s, "
                  f"epoch {np.median(sg['epoch_ms']) if sg['epoch_ms'] else float('nan'):.1f} ms"
                  for sg in segs)
              + f"; loss gap {r['gate']['loss_diff']:.2e}, grads "
              f"{max(r['gate']['grads'].values()):.2e}; launches on the ranks "
              + json.dumps({k: v for k, v in r["launches"].items() if v})
              + "; rank 0's first-step calls against the plain versions "
              + json.dumps(r["checks"]) + "; host builds "
              + json.dumps(r["builds"]) + f" on {card}")
    print(f"[stream] phase 24 in {m['s']:.1f}s: (a) {m['a_s']:.1f}s, the rank pool "
          f"spawned in {m['pool_s']:.1f}s, (c) {m['c_s']:.1f}s, (d) {m['d_s']:.1f}s, "
          f"(e) {m['e']['s']:.1f}s")



# ---------------------------------------------------------------------------
# Phase 25: the one-card dry run held against the card
# ---------------------------------------------------------------------------

#: (label, arch, SHAPES cell, batch run: None the cell's own): each at its
#: full width and length
DRYRUN_CELLS = (("a", "gemma3-1b", "long_500k", None),
                ("b", "llama3.2-1b", "prefill_32k", 1),
                ("c", "llama3.2-1b", "train_4k", 1))
#: the measured peak allocation within max(PEAK_RTOL of, PEAK_SLACK) of the
#: dry run's simulated peak (the allocator's rounding, cuBLAS's workspace)
PEAK_RTOL, PEAK_SLACK = 0.10, 256 << 20
#: (b): the rows of one layer's flash call held against the plain version:
#: the first FLASH_HEAD_ROWS against their keys, the last FLASH_TAIL_ROWS
#: against every key under the top-left mask
FLASH_HEAD_ROWS, FLASH_TAIL_ROWS = 4096, 512
#: (b): each query row's largest |got - want| within FLASH_ROW_RTOL of that
#: row's largest |want|. A row of T keys averages T values of v, so its
#: values shrink as sqrt(1/T) and an absolute limit that holds at row 0
#: cannot see row 32,767. bf16 outputs from the same fp32 value part by at
#: most one ulp, 2^-7 of the row's largest value: the limit is 4 of them
FLASH_ROW_RTOL = 2.0 ** -5
#: timed steps after the warm-up and the measured one
DRYRUN_REPS = 3


def step_output_check(label: str, cell, out) -> dict:
    """A cell's step output as the repo checks its kind: a training step's
    loss finite and new parameters and moments of the old ones' shapes; a
    serving step's last-position logits [B, Vpad] finite."""
    if cell.shp.kind == "train":
        params, state, loss = out
        same = all(a.shape == b.shape for a, b in zip(tree_leaves(params),
                                                       tree_leaves(cell.args[0])))
        if not (same and math.isfinite(float(loss)) and state.step == 1):
            raise AssertionError(f"dry-run cell {label}: loss {float(loss)}, "
                                 f"parameters of their shapes {same}")
        return {"loss": float(loss)}
    logits = out[0]
    want = (cell.shp.global_batch, cell.cfg.padded_vocab())
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dry-run cell {label}: logits {tuple(logits.shape)} "
                             f"(want {want}), finite {bool(torch.isfinite(logits).all())}")
    return {"logits_shape": list(want)}


def tail_attention(q, k, v, rows: int) -> torch.Tensor:
    """The plain version of the last ``rows`` query rows of a causal flash
    call over every key, the mask aligned top-left (row i sees keys
    0..i): float32 logits and softmax, the output at q's dtype."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q[:, :, tq - rows:].float().reshape(b, hkv, h // hkv, rows, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(d)
    row = torch.arange(tq - rows, tq, device=q.device)
    hidden = torch.arange(tk, device=q.device)[None, :] > row[:, None]
    probs = torch.softmax(logits.masked_fill(hidden, float("-inf")), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(b, h, rows, d).to(q.dtype)


def row_rel_err(have, want) -> dict:
    """Over every (batch, head, query row) of a block: the row's largest
    |have - want| over its largest |want|, at most (``row_rel_err``);
    beside it the block's largest |have - want| and its largest and mean
    |want|."""
    want = want.float()
    diff = (have.float() - want).abs()
    scale = want.abs().amax(dim=-1)
    ratio = diff.amax(dim=-1) / scale.clamp_min(torch.finfo(torch.float32).tiny)
    return {"row_rel_err": float(ratio.max()), "max_abs_err": float(diff.max()),
            "want_abs_max": float(scale.max()), "want_abs_mean": float(want.abs().mean())}


def long_flash(cell, device) -> dict:
    """(b)'s flash kernel: layer 0's call of one more prefill captured, the
    kernel on it held against the plain version on the row blocks the plain
    version can hold (FLASH_HEAD_ROWS against their keys, the last
    FLASH_TAIL_ROWS against all keys), each row within FLASH_ROW_RTOL of
    its own scale (``row_rel_err``; the check must fail on the block with
    one row, and with every row, zeroed); its CUDA-event ms beside SDPA's
    (K/V repeated to H heads) and the bound. The plain version of
    the whole call would hold T x T float32 logits a head, so it has no
    time here."""
    table = kops._EXECUTORS["cuda"]
    inner = table["flash"]
    first = []

    def spy(q, k, v, **kw):
        if not first:
            first.append((q, k, v, kw["causal"]))
        return inner(q, k, v, **kw)

    table["flash"] = spy
    try:
        out = cell.step(*cell.args, **cell.kwargs)
    finally:
        table["flash"] = inner
    del out
    q, k, v, causal = first.pop()
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    got = flash_attention(q, k, v, causal=causal)
    head = min(FLASH_HEAD_ROWS, tq)
    tail = min(FLASH_TAIL_ROWS, tq)
    errs, blocks = {}, {}
    for name, have, want in (
            ("head", got[:, :, :head], flash_attention_ref(
                q[:, :, :head], k[:, :, :head], v[:, :, :head], causal=True)),
            ("tail", got[:, :, tq - tail:], tail_attention(q, k, v, tail))):
        blocks[name] = row_rel_err(have, want)
        errs[name] = blocks[name]["max_abs_err"]
        if not blocks[name]["row_rel_err"] <= FLASH_ROW_RTOL:
            raise AssertionError(f"flash_attention T={tq} {name} rows: {blocks[name]}, "
                                 f"a row's error over its largest |want| > {FLASH_ROW_RTOL}")
        one_row = have.clone()
        one_row[:, :, -1] = 0
        for bad in (one_row, torch.zeros_like(have)):
            if row_rel_err(bad, want)["row_rel_err"] <= FLASH_ROW_RTOL:
                raise AssertionError(f"flash_attention T={tq} {name} rows: the check "
                                     "passes zeroed rows")
        del one_row
    del got
    cost = flash_bound(b, h, hkv, tq, tk, d, causal, q.element_size())
    bound_ms, bound_by = cost["bound_ms"], cost["bound_by"]
    on_card = device.type == "cuda"
    row = {"B": b, "H": h, "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d, "dtype": str(q.dtype),
           "causal": causal, "max_abs_err": errs, "blocks": blocks, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "flop": cost["flop"], "bytes": cost["bytes"], "plain_ms": None,
           "plain_why": f"the plain version's logits would take {4 * b * h * tq * tk} bytes"}
    row["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=causal), device,
                        reps=DRYRUN_REPS, warmup=1)
    # SDPA on K/V repeated to H heads beforehand (its flash backend; a GQA
    # call may take the math backend, whose T x T logits do not fit)
    kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal), device,
        reps=DRYRUN_REPS, warmup=1) if on_card else None
    del kr, vr
    row["library"] = ("torch.nn.functional.scaled_dot_product_attention(is_causal=True) "
                      "on K/V repeated to H heads beforehand")
    print(f"[dryrun] (b) flash_attention B {b}, H {h}, Hkv {hkv}, T {tq}, D {d}, "
          f"{q.dtype}: head rows err {errs['head']:.3g} (row-relative "
          f"{blocks['head']['row_rel_err']:.3g}, max |want| {blocks['head']['want_abs_max']:.3g}), "
          f"tail rows err {errs['tail']:.3g} (row-relative {blocks['tail']['row_rel_err']:.3g}, "
          f"max |want| {blocks['tail']['want_abs_max']:.3g}); "
          f"{row['ms']:.2f} ms (SDPA {row['library_ms']}, bound {bound_ms:.2f} "
          f"{bound_by})")
    return row


def dryrun_cell(label: str, arch: str, shape: str, batch, sizes: Sizes, device) -> dict:
    """One phase-25 cell: the dry run of its shape (``launch/specs.py``
    over ``meta`` tensors, ``launch/step_cost.py``), then the same cell on
    the card from seed 0: a warm-up step, then a step with the counts set to
    0 just before it (the kernels launched as the dry run counted them) and
    its peak allocation over what was allocated before it (within
    max(PEAK_RTOL, PEAK_SLACK) of the simulated peak), then DRYRUN_REPS
    synchronised steps: their median beside the bound, the roofline
    fraction and the MFU."""
    cfg = get_config(arch)
    kw = {"batch": batch}
    if sizes.lm_reduced:
        cfg = dataclasses.replace(cfg.reduced(), n_layers=6) if arch == "gemma3-1b" \
            else cfg.reduced()
        kw.update(batch=batch or 1)
    t0 = time.perf_counter()
    sim = build_cell(arch, shape, cfg=cfg, **kw)
    out, cost = reckon(sim.step, *sim.args, **sim.kwargs)
    del out
    roof = roofline_of(cost, arch, shape, sim.cfg, sim.shp, sim.min_bytes)
    sim_s = time.perf_counter() - t0
    persistent = dict(sim.persistent)
    del sim
    cell = build_cell(arch, shape, cfg=cfg, device=device,
                      generator=torch.Generator(device=device).manual_seed(0), **kw)
    if cell.persistent != persistent:
        raise AssertionError(f"dry-run cell {label}: the card holds {cell.persistent}, "
                             f"the dry run {persistent}")
    on_card = device.type == "cuda"

    def run():
        res = cell.step(*cell.args, **cell.kwargs)
        sync(device)
        return res

    run()  # warm-up (its outputs dropped): the allocator's pools, cuBLAS's workspace
    free_card(device)  # a collection first: reference cycles may hold its tensors
    before = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    res = run()
    launched = counts()
    peak = torch.cuda.max_memory_allocated(device) - before if on_card else 0
    checked = step_output_check(label, cell, res)
    del res
    want = {name: int(cost.launches.get(name, 0)) for name in KERNELS}
    if on_card and launched != want:
        raise AssertionError(f"dry-run cell {label}: launched {launched}, the dry run "
                             f"counts {want}")
    slack = max(PEAK_RTOL * cost.peak, PEAK_SLACK)
    if on_card and not abs(peak - cost.peak) <= slack:
        raise AssertionError(f"dry-run cell {label} ({arch} x {shape}): peak allocation "
                             f"{peak} bytes, simulated {cost.peak} (slack {slack:.0f})")
    step_s = []
    for _ in range(DRYRUN_REPS):
        t = time.perf_counter()
        run()
        step_s.append(time.perf_counter() - t)
    roof.measured_s = float(np.median(step_s))
    row = {"arch": arch, "shape": shape, "batch": cell.shp.global_batch,
           "seq": cell.shp.seq_len, "kind": cell.shp.kind, "dryrun_s": sim_s,
           "persistent_bytes": persistent, "simulated_peak_bytes": cost.peak,
           "measured_peak_bytes": peak, "peak_ratio": peak / cost.peak if cost.peak else None,
           "launches": launched, "counted_launches": want, "step_s": step_s,
           "step_s_median": roof.measured_s, "check": checked,
           "params_init": cell.n_params, "params_count": cfg.param_count(),
           **{k: v for k, v in roof.to_dict().items() if k not in ("arch", "shape")}}
    print(f"[dryrun] ({label}) {arch} x {shape}, batch {row['batch']} x {row['seq']}: "
          f"peak {peak / 2**30:.3f} GiB measured, {cost.peak / 2**30:.3f} simulated; "
          f"launches {({k: n for k, n in launched.items() if n})}; step {roof.measured_s * 1e3:.1f} ms (bound "
          f"{roof.bound_time * 1e3:.1f} ms, {roof.dominant}; roofline fraction "
          f"{roof.compute_roofline_fraction:.4f}, MFU {roof.mfu})")
    if label == "b":
        row["flash"] = long_flash(cell, device)
    del cell
    return row


def dryrun_phase(sizes: Sizes, device) -> dict:
    """Phase 25: every cell of DRYRUN_CELLS in turn, the card freed
    between them."""
    out = {}
    for label, arch, shape, batch in DRYRUN_CELLS:
        t0 = time.perf_counter()
        out[label] = dryrun_cell(label, arch, shape, batch, sizes, device)
        out[label]["phase_s"] = time.perf_counter() - t0
        free_card(device)
    return out


def dryrun_entries(entries: list, p25: dict) -> None:
    """Phase 25 beside its kernels' entries: each cell's launches
    (``launches_by_path``) and the flash call at T = 32,768 (b)."""
    by_name = {e["name"]: e for e in entries}
    for label, row in p25.items():
        for e in entries:
            e["launches_by_path"][f"dryrun_{label}"] = row["launches"][e["name"]]
            e["launches"] += row["launches"][e["name"]]
    f = p25["b"]["flash"]
    flash = by_name["flash_attention"]
    flash["bf16_max_abs_err"] = max(flash.get("bf16_max_abs_err", 0.0), *f["max_abs_err"].values())
    flash["prefill_32k"] = {
        **{k: f[k] for k in ("ms", "bound_ms", "bound_by", "library_ms", "library",
                             "plain_ms", "plain_why")},
        "max_abs_err": f["max_abs_err"], "blocks": f["blocks"],
        "shape": f"layer 0's call of llama3.2-1b x prefill_32k, one sequence: B {f['B']}, "
                 f"H {f['H']}, Hkv {f['Hkv']}, T {f['Tq']}, D {f['D']}, causal, "
                 f"{f['dtype']}; ms by CUDA events; held on the first {FLASH_HEAD_ROWS} "
                 f"and the last {FLASH_TAIL_ROWS} rows"}


def print_dryrun_summary(m: dict, card: str) -> None:
    print(f"[summary] phase 25, the one-card dry run against the card ({card}):")
    for label, r in m.items():
        print(f"[summary]   ({label}) {r['arch']} x {r['shape']} (batch {r['batch']} x "
              f"{r['seq']}): peak {r['measured_peak_bytes']:,} bytes measured, "
              f"{r['simulated_peak_bytes']:,} simulated ({r['peak_ratio']:.4f}); step "
              f"{r['step_s_median'] * 1e3:.2f} ms, bound {r['bound_time_s'] * 1e3:.2f} ms "
              f"({r['dominant']}), roofline fraction {r['roofline_fraction']:.4f}, MFU "
              f"{r['mfu']:.4f}; launches {({k: n for k, n in r['launches'].items() if n})}; "
              f"{r['phase_s']:.1f} s")
    f = m["b"]["flash"]
    print(f"[summary]   (b) flash T {f['Tq']}: {f['ms']:.2f} ms, SDPA {f['library_ms']:.2f}, "
          f"bound {f['bound_ms']:.2f} ({f['bound_by']})")


def run(sizes: Sizes, device, phases: str = "all") -> dict:
    """Phases 2 to 25 at ``sizes`` on ``device`` (phase 20, 21, 22, 23, 24
    or 25 alone where ``phases`` names it: the kernels line then holds that
    phase's launches and numbers alone); returns the kernels line and
    the details. Phases 20 to 25 each start after the phases before them
    have returned, so that nothing those held stays on the card."""
    if phases in ("20", "21", "22", "23", "24", "25"):
        result = {"phase_s": {}, "kernels": [
            {"name": name, "launches": 0, "launches_by_path": {}, "max_abs_err": 0.0}
            for name in KERNELS]}
    else:
        result = phases_2_to_19(sizes, device)
    if phases in ("all", "20"):
        t0 = time.perf_counter()
        moe = moe_phase(sizes, device)
        result["phase_s"]["20"] = time.perf_counter() - t0
        moe_entries(result["kernels"], moe)
        result["moe"] = moe
    if phases in ("all", "21"):
        t0 = time.perf_counter()
        hybrid = hybrid_phase(sizes, device)
        result["phase_s"]["21"] = time.perf_counter() - t0
        hybrid_entries(result["kernels"], hybrid)
        result["hybrid"] = hybrid
    if phases in ("all", "22"):
        t0 = time.perf_counter()
        encdec = encdec_phase(sizes, device)
        result["phase_s"]["22"] = time.perf_counter() - t0
        encdec_entries(result["kernels"], encdec)
        result["encdec"] = encdec
    if phases in ("all", "23"):
        t0 = time.perf_counter()
        dist = distributed_phase(sizes, device)
        result["phase_s"]["23"] = time.perf_counter() - t0
        distributed_entries(result["kernels"], dist, alone=phases == "23")
        partitions = dist.pop("partitions")
        result["distributed"] = dist
    else:
        partitions = None
    if phases in ("all", "24"):
        t0 = time.perf_counter()
        streaming = streaming_phase(sizes, device, partitions)
        result["phase_s"]["24"] = time.perf_counter() - t0
        streaming_entries(result["kernels"], streaming)
        streaming["a"].pop("op")
        result["streaming"] = streaming
    if phases in ("all", "25"):
        t0 = time.perf_counter()
        dry = dryrun_phase(sizes, device)
        result["phase_s"]["25"] = time.perf_counter() - t0
        dryrun_entries(result["kernels"], dry)
        result["dryrun"] = dry
    return result


def phases_2_to_19(sizes: Sizes, device) -> dict:
    """Phases 2 to 19 at ``sizes`` on ``device``; returns the kernels line
    and the details."""
    t_start = t0 = time.perf_counter()
    ds = generate_dataset(sizes.dataset, scale=sizes.scale, seed=0)
    print(f"[data] {ds.name}: {ds.graph.n_rows} nodes, {ds.graph.nnz} nonzeros, "
          f"{ds.features.shape[1]} features in {time.perf_counter() - t0:.2f}s")
    kw = dict(arch="GCN", hidden=sizes.hidden, fanouts=sizes.fanouts,
              batch_size=sizes.batch_size, n_buckets=sizes.n_buckets,
              wave_size=sizes.wave_size, use_cache=False, device=device)
    eng = build_engine(ds, engine="cuda", **kw)
    ref = build_engine(ds, engine="torch", **kw)
    kern = kernel_phase(ds, eng, device)
    serve = serving_phase(ds, eng, ref, sizes)
    serve["verify"] = verify_timed("serve", eng.trainer.plan, device)
    print(f"[serve] {json.dumps(serve)}")
    serve["breakdown"] = [breakdown(eng, device, n)
                          for n in (4 * sizes.wave_size, sizes.batch_size)]
    print(f"[serve] per-batch breakdown: {json.dumps(serve['breakdown'])}")
    layers = kern["layers"]
    total = sum_rows(layers)
    serving_entry = {
        "name": "bsr_spmm", "route": "cuda",
        "source": SOURCES["bsr_spmm"][0], "replaces": SOURCES["bsr_spmm"][1],
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": total["ms"], "ms_by": total["ms_by"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
        "nnz_bound_ms": total["nnz_bound_ms"],
        "layout_bound_ms": total["layout_bound_ms"],
        "library_ms": total["library_ms"],
        "wall_ms": total["wall_ms"],
        "column_build_ms": sum(l["build_ms"] for l in layers),
        "column_build_host_syncs": (None if layers[0]["host_syncs"] is None
                                    else sum(l["host_syncs"] for l in layers)),
        "shape": "one largest-bucket serving batch: layers 0-2 summed; wall_ms "
                 "CUDA events; column_build_ms the batch's nonzero columns, "
                 "built once per layer (synchronised host clock)",
    }
    del eng, ref

    # phase 4: full-batch training, the main path
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    n = len(dims) - 1
    gnn = (GNNProgram.load(ds, arch="GCN", aggregation="gcn")
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*ADAM))
    train_expect = {"bsr_spmm_fused_epilogue": n, "bsr_spmm_masked": n - 1,
                    "bsr_spmm": 1, "fused_adam": 1}
    train = train_path("train", gnn, device, sizes.epochs, train_expect)
    if any(l.feature_path != "dense" for l in train["prog"].plan.layers):
        raise AssertionError("the main path's features are dense")
    adam_leaves = {"gcn": tree_leaves(train["prog"].params)}
    # phase 5: the training kernels on the main path's operands
    t0 = time.perf_counter()
    fk = fused_kernel_phase(train["prog"], ds.graph.sym_normalized(), device,
                            reps=3)
    edge = kern["edge"]
    print(f"[kernel] phase 5 took {time.perf_counter() - t0:.1f}s")
    del train["prog"], train["ref"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 6: the quickstart at full scale
    qds = generate_dataset(sizes.quick_dataset, scale=sizes.quick_scale, seed=0)
    print(f"[data] {qds.name}: {qds.graph.n_rows} nodes, {qds.graph.nnz} "
          f"nonzeros, {qds.features.shape[1]} features, sparsity "
          f"{qds.feature_sparsity:.4f}")
    qdims = [qds.features.shape[1], *sizes.quick_hidden, qds.n_classes]
    qn = len(qdims) - 1
    qgnn = (GNNProgram.load(qds, arch="GCN", aggregation="gcn")
            .initialize_layers(qdims, "xavier", seed=0).set_optimizer(*ADAM))
    quick_expect = {"bsr_spmm_fused_epilogue": qn, "bsr_spmm_masked": qn - 1,
                    "bsr_spmm": 3, "fused_adam": 1}
    quick = train_path("quickstart", qgnn, device, sizes.epochs, quick_expect)
    if quick["prog"].plan.layers[0].primitive != "cuda.feature_matmul_sparse":
        raise AssertionError("the quickstart's layer 0 must bind "
                             "cuda.feature_matmul_sparse")
    pair_err = pair_unequal_paddings(quick["prog"], device)
    qk = feature_operand_checks(qds, quick["prog"], device, reps=5)
    del quick["prog"], quick["ref"]
    phase_s = {"2-6": time.perf_counter() - t_start}

    # phase 7: GAT training on the arxiv analog, the attention main path
    t0 = time.perf_counter()
    gdims = [ds.features.shape[1], *sizes.gat_hidden, ds.n_classes]
    gn = len(gdims) - 1
    ggnn = (GNNProgram.load(ds, arch="GAT", aggregation="gcn",
                            gat_heads=sizes.gat_heads)
            .initialize_layers(gdims, "xavier", seed=0).set_optimizer(*GAT_ADAM))
    gat = train_path("gat", ggnn, device, sizes.gat_epochs, {
        "bsr_attention_fwd": gn, "bsr_attention_bwd_row": gn,
        "bsr_attention_bwd_col": gn, "fused_adam": 1})
    if any(l.agg_primitive != "cuda.spmm_attention" for l in gat["prog"].plan.layers):
        raise AssertionError("every GAT layer must bind cuda.spmm_attention")
    adam_leaves["gat"] = tree_leaves(gat["prog"].params)
    phase_s["7"] = time.perf_counter() - t0
    # phase 8: the attention kernels on phase 7's operands and inputs
    t0 = time.perf_counter()
    ak = attention_phase(gat["prog"], device, reps=2)
    phase_s["8"] = time.perf_counter() - t0
    del gat["prog"], gat["ref"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 9: GT on the quickstart at full scale
    t0 = time.perf_counter()
    tgnn = (GNNProgram.load(qds, arch="GT", aggregation="gcn",
                            gat_heads=sizes.gt_heads)
            .initialize_layers(qdims, "xavier", seed=0).set_optimizer(*ADAM))
    gt = train_path("gt", tgnn, device, sizes.epochs, {
        "bsr_attention_fwd": qn, "bsr_attention_bwd_row": qn,
        "bsr_attention_bwd_col": qn, "bsr_spmm": 2, "fused_adam": 1})
    gplan = gt["prog"].plan
    if gplan.layers[0].primitive != "cuda.feature_matmul_sparse":
        raise AssertionError("GT's layer 0 must bind cuda.feature_matmul_sparse")
    if any(l.agg_primitive != "cuda.spmm_attention" for l in gplan.layers):
        raise AssertionError("every GT layer must bind cuda.spmm_attention")
    attn_pair_err = attention_pair_unequal(gt["prog"], device)
    seg = tgnn.compile(engine="cuda", device=device, fused_optimizer=True,
                       fuse_attention=False, params=gt["weights"])
    if any(l.agg_primitive != "cuda.segment_softmax_aggregate"
           for l in seg.plan.layers):
        raise AssertionError("fuse_attention=False must bind the segment path")
    seg_loss = seg.train_epoch()["loss"]
    fused_loss = gt["summary"]["losses"][0]
    seg_rel = abs(seg_loss - fused_loss) / abs(fused_loss)
    print(f"[gt] segment path, one epoch: loss {seg_loss} against the fused "
          f"{fused_loss} (relative {seg_rel:.2e})")
    if not seg_rel <= 2e-4:
        raise AssertionError(f"segment epoch loss {seg_loss} vs fused {fused_loss}")
    gt["summary"]["segment_epoch"] = {"loss": seg_loss, "rel_diff": seg_rel}
    del gt["prog"], gt["ref"], seg
    phase_s["9"] = time.perf_counter() - t0

    # phase 10: LM serving at llama3.2-1B width, the flash kernel's main path
    t0 = time.perf_counter()
    lm_cfg = get_config(sizes.lm_arch)
    lm = lm_serving_phase(lm_cfg.reduced() if sizes.lm_reduced else lm_cfg, sizes,
                          device)
    lm_summary = lm["summary"]
    phase_s["10"] = time.perf_counter() - t0
    # phase 11: the flash kernel on phase 10's prefill inputs
    t0 = time.perf_counter()
    fa = flash_phase(lm, device, reps=10)
    phase_s["11"] = time.perf_counter() - t0
    del lm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # phase 12: Adam on the GCN and GAT paths' leaves, the mixed list, a
    # list over a launch's capacity; each path's opt.update host time
    t0 = time.perf_counter()
    adam = adam_checks(adam_leaves, device, reps=20)
    adam["update_host_ms"] = {p: r["summary"]["update_host_ms"] for p, r in (
        ("train", train), ("quickstart", quick), ("gat", gat), ("gt", gt))}
    print(f"[adam] opt.update host ms by path: {json.dumps(adam['update_host_ms'])}")
    phase_s["12"] = time.perf_counter() - t0

    # phase 13: GAT serving on the sampled path
    t0 = time.perf_counter()
    gat_serve = sampled_gat_serving(ds, sizes, device)
    phase_s["13"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # phase 14: sampled training (SAGE, GAT; one step of GT and of SAGE-max)
    t0 = time.perf_counter()
    sampled = sampled_training(ds, qds, sizes, device)
    phase_s["14"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # phases 15-16: gemma3-1b serving (windows, flash at D = 256), then
    # llama3.2-1b training
    lm2 = gemma_and_training(sizes, device)
    phase_s.update(lm2["phase_s"])
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 17: the layout stage and γ; a fresh cache, which the lowering's
    # layout="auto" reads too
    t0 = time.perf_counter()
    with layout_cache() as cache:
        lay = {"train": plan_phase("layout-arxiv", ds.graph, dims[1], device, cache)}
        auto = {"train": auto_path("train-auto", gnn, train, device, sizes.epochs,
                                   train_expect)}
        lay["quickstart"] = plan_phase("layout-quickstart", qds.graph, qdims[1],
                                       device, cache)
        auto["quickstart"] = auto_path("quickstart-auto", qgnn, quick, device,
                                       sizes.epochs, quick_expect)
    gamma = gamma_phase(qgnn, quick, qds, device, sizes.epochs)
    phase_s["17"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # phase 18: the runtime (guard, injector, checkpoints, resume)
    t0 = time.perf_counter()
    runtime = runtime_phase(gnn, train, device, sizes.epochs, train_expect)
    resume = sampled_resume(ds, sizes, device)
    phase_s["18"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # phase 19: the verifier on every plan above, its cost to the lowering,
    # mutations on card-resident operands, the chaos soak
    verified = [serve["verify"], train["summary"]["verify"],
                quick["summary"]["verify"], gat["summary"]["verify"],
                gt["summary"]["verify"], gat_serve["verify"],
                *(sampled[p]["verify"] for p in ("sage", "gat", "gt", "max")),
                auto["train"]["verify"], auto["quickstart"]["verify"]]
    verify = verifier_phase(ds, qds, sizes, device, verified)
    phase_s["19"] = verify["s"]

    attn_err = max(ak["err"]["edge"], attn_pair_err)
    nonfinite = max(edge["nonfinite"], fk["err"]["nonfinite"])
    errs = {"bsr_spmm": max(kern["max_abs_err"], fk["err"]["spmm"], pair_err,
                            qk["err"], nonfinite, sampled["sage"]["max_abs_err"]),
            "bsr_spmm_fused_epilogue": max(fk["err"]["fused"], edge["fused"], pair_err,
                                           nonfinite),
            "bsr_spmm_masked": max(fk["err"]["masked"], edge["masked"], pair_err,
                                   nonfinite),
            "fused_adam": adam["err"],
            **{name: max(ak["err"][kind], attn_err, sampled["gat"]["err"][kind],
                         gat_serve["max_abs_err"] if kind == "fwd" else 0.0)
               for kind, (name, _, _) in ATTENTION.items()}}
    for name, c in verify["soak"]["checked"].items():
        errs[name] = max(errs[name], c["max_abs_err"])
    serving_counts = {k: 0 for k in KERNELS}
    serving_counts["bsr_spmm"] = serve["launches"]
    by_path = {"serving": serving_counts,
               "train": train["summary"]["launches"],
               "quickstart": quick["summary"]["launches"],
               "gat": gat["summary"]["launches"],
               "gt": gt["summary"]["launches"],
               "lm_serving": lm_summary["launches"],
               "lm_serving_gemma": lm2["gemma"]["launches"],
               "lm_training": lm2["lm_train"]["launches"],
               "gat_serving_sampled": gat_serve["launched"],
               **{f"{p}_sampled": sampled[p]["launches"]
                  for p in ("sage", "gat", "gt", "max")},
               "train_auto": auto["train"]["launches"],
               "quickstart_auto": auto["quickstart"]["launches"],
               "gamma": gamma["launches"], "runtime": runtime["launches"],
               "sage_resume": resume["launches"], "chaos": verify["launches"]}
    entries = kernel_entries(serving_entry, by_path, fk, ak, adam, errs, dims,
                             train["summary"]["profile"],
                             gat["summary"]["profile"], flash_entry(fa))
    entries[0]["quickstart"] = qk["rows"]
    sampled_entries(entries, gat_serve, sampled)
    lm_entries(entries, lm2)
    layout_entries(entries, auto, gamma)
    return {"kernels": entries, "layers": layers, "serve": serve,
            "sample_s": kern["sample_s"], "train": train["summary"],
            "quickstart": quick["summary"], "gat": gat["summary"],
            "gt": gt["summary"], "lm": lm_summary, "flash": fa, "adam": adam,
            "gemma": lm2["gemma"], "gemma_flash": lm2["gemma_flash"],
            "lm_train": lm2["lm_train"], "layout": lay, "auto": auto,
            "gamma": gamma, "runtime": runtime, "resume": resume,
            "verify": {k: v for k, v in verify.items() if k != "launches"},
            "gat_serving_sampled": {k: v for k, v in gat_serve.items() if k != "rows"},
            "sampled": {p: {k: v for k, v in r.items() if k != "rows"}
                        for p, r in sampled.items()},
            "sampled_rows": {f"{p} {k}": v for p, r in (
                ("gat_serving", gat_serve), ("sage", sampled["sage"]),
                ("gat", sampled["gat"])) for k, v in r["rows"].items()},
            "phase_s": phase_s,
            "attention_hub": ak["hub"], "quickstart_spmm": qk["rows"],
            "kernel_rows": {str(k): v for k, v in fk["rows"].items()},
            "attention_rows": {str(k): v for k, v in ak["rows"].items()}}


def print_summary(result: dict, card: str) -> None:
    """One line a path of ``run``'s result, each beside the card's name
    and power limit."""
    serve = result["serve"]
    print(f"[serve] {serve['requests']} requests, {serve['req_per_s']:.2f} req/s, "
          f"p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms, "
          f"warmup {serve['warmup_s']:.2f}s, sample one 256-seed batch "
          f"{result['sample_s']:.3f}s on {card}")
    gs = result["gat_serving_sampled"]
    print(f"[gat-serving] {gs['requests']} requests, {gs['req_per_s']:.2f} req/s, "
          f"p50 {gs['p50_ms']:.2f} ms, p99 {gs['p99_ms']:.2f} ms, column builds "
          f"{gs['column_build_ms']:.2f} ms a batch on {card}")
    for path, r in result["sampled"].items():
        print(f"[{path}-sampled] {len(r['losses'])} epochs of {r['steps_per_epoch']} "
              f"steps, {r['step_ms_mean']:.1f} ms a step (torch reference "
              f"{r['ref_step_ms_mean']:.1f} ms), loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}, max rel diff {r['max_rel_diff']:.2e}, "
              f"peak {r['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    for path in ("train", "quickstart", "gat", "gt"):
        r = result[path]
        print(f"[{path}] {len(r['losses'])} epochs, median epoch "
              f"{r['epoch_ms_median']:.1f} ms (torch reference "
              f"{r['ref_epoch_ms_median']:.1f} ms), loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}, max rel diff {r['max_rel_diff']:.2e}, "
              f"peak {r['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    lm = result["lm"]
    print(f"[lm] {lm['arch']}: {lm['requests']} requests in {lm['waves']} waves, "
          f"prefill {', '.join(f'{x:.1f}' for x in lm['prefill_ms'])} ms a wave "
          f"(torch {', '.join(f'{x:.1f}' for x in lm['ref_prefill_ms'])}), decode "
          f"{lm['decode_step_ms_median']:.2f} ms a step (torch "
          f"{lm['ref_decode_step_ms_median']:.2f}), {lm['tokens_per_s']:.1f} tokens/s, "
          f"peak {lm['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    g = result["gemma"]
    gf = result["gemma_flash"]["row"]
    print(f"[gemma] {g['arch']}: {g['requests']} requests in {g['waves']} waves, "
          f"{g['flash_per_wave']} flash launches a wave, prefill "
          f"{', '.join(f'{x:.1f}' for x in g['prefill_ms'])} ms a wave, decode "
          f"{g['decode_step_ms_median']:.2f} ms a step, {g['tokens_per_s']:.1f} "
          f"tokens/s, peak {g['peak_mem_bytes'] / 2**30:.2f} GiB; flash at D = "
          f"{gf['D']}: {gf['ms']:.3f} ms a call (bound {gf['bound_ms']:.3f}, SDPA "
          f"{gf['library_ms']:.3f}) on {card}")
    t = result["lm_train"]
    print(f"[lm-train] {t['arch']}: {t['steps']} steps of B {t['batch']} x T "
          f"{t['seq']}, {t['step_ms_median']:.1f} ms a step (torch program "
          f"{t['ref_step_ms_median']:.1f}), {t['tokens_per_s']:.0f} tokens/s, loss "
          f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}, max rel diff "
          f"{t['max_rel_diff']:.2e}, peak {t['peak_mem_bytes'] / 2**30:.2f} GiB; Adam "
          f"{t['adam']['ms']:.3f} ms a launch (bound {t['adam']['bound_ms']:.3f}, "
          f"AdamW(fused=True) {t['adam']['library_ms']:.3f}) on {card}")
    for path, a in result["auto"].items():
        print(f"[{path}-auto] {a['layout']}: median epoch {a['epoch_ms_median']:.2f} "
              f"ms (identity layout {a['identity_epoch_ms_median']:.2f}), loss "
              f"within {a['identity_rel_diff']:.2e} of the identity layout's on {card}")
    g = result["gamma"]
    print(f"[gamma] " + "; ".join(
        f"{k}: gamma {m['gamma']:.4f} (t_dense {m['t_dense'] * 1e3:.4f} ms, "
        f"t_sparse {m['t_sparse'] * 1e3:.4f} ms)" for k, m in g["measured"].items())
          + f"; quickstart epoch sparse {g['epoch_ms_median']['sparse']:.3f} ms, "
          f"dense {g['epoch_ms_median']['dense']:.3f} ms on {card}")
    r = result["runtime"]
    print(f"[runtime] guarded epoch {r['epoch_ms_median']:.2f} ms (unguarded "
          f"{r['unguarded_epoch_ms_median']:.2f}), save {r['save_ms_median']:.1f} "
          f"ms, restore {r['restore_ms_median']:.1f} ms; sampled resume "
          f"{'bitwise' if result['resume']['bitwise'] else 'within the repeat'} "
          f"on {card}")
    v = result["verify"]
    low = v["lowering"]
    print(f"[verify] {len(v['plans'])} plans verified in full, 0 violations; "
          f"the check against one unchecked lowering: arxiv GCN fast "
          f"{low['gcn']['fast_share']:.2%}, full {low['gcn']['full_share']:.2%}; "
          f"sampled SAGE fast {low['sage_sampled']['fast_share']:.2%}, full "
          f"{low['sage_sampled']['full_share']:.2%}; {len(v['mutations'])} card "
          f"mutations flagged by name; chaos soak {v['soak']['schedules']} "
          f"schedules held in {v['soak']['s']:.1f}s, its "
          f"{sum(c['calls'] for c in v['soak']['checked'].values())} kernel "
          f"calls within {TOL} of the plain versions on {card}")
    print_moe_summary(result["moe"], card)
    print_hybrid_summary(result["hybrid"], card)
    print_encdec_summary(result["encdec"], card)
    print_distributed_summary(result["distributed"], card)


def print_moe_summary(m: dict, card: str) -> None:
    """Phase 20's lines: each served model's, flash at D = 128, the
    training cut's."""
    for key in ("dbrx", "deepseek"):
        r = m[key]
        print(f"[moe] {r['arch']}: {r['n_params']:,} parameters, {r['requests']} "
              f"requests in {r['waves']} waves, {r['flash_per_wave']} flash launches a "
              f"wave, prefill {', '.join(f'{x:.1f}' for x in r['prefill_ms'])} ms a "
              f"wave, decode {r['decode_step_ms_median']:.2f} ms a step, "
              f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_abs_bytes'] / 2**30:.2f} "
              f"GiB, routing parted in {len(r['routing_parted'])} calls on {card}")
    f = m["dbrx_flash"]["row"]
    print(f"[moe] flash at D = {f['D']} (B {f['B']}, H {f['H']}, Hkv {f['Hkv']}, T "
          f"{f['Tq']}): {f['ms']:.3f} ms a call (bound {f['bound_ms']:.3f}, SDPA "
          f"{f['library_ms']:.3f}, SDPA enable_gqa {f['library_enable_gqa_ms']:.3f}) "
          f"on {card}")
    t = m["train"]
    print(f"[moe] {t['arch']}: {t['n_params']:,} parameters, {t['steps']} steps of B "
          f"{t['batch']} x T {t['seq']}, {t['step_ms_median']:.1f} ms a step (torch "
          f"program {t['ref_step_ms_median']:.1f}), {t['tokens_per_s']:.0f} tokens/s, "
          f"loss {t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}, max rel diff "
          f"{t['max_rel_diff']:.2e}, peak {t['peak_abs_bytes'] / 2**30:.2f} GiB; Adam "
          f"{t['adam']['ms']:.3f} ms a launch (bound {t['adam']['bound_ms']:.3f}, "
          f"AdamW(fused=True) {t['adam']['library_ms']:.3f}) on {card}")


def print_hybrid_summary(m: dict, card: str) -> None:
    """Phase 21's lines: each served model's with its prefill by block
    kind and its chunked-against-recurrent gap, flash at D = 112, the
    xlstm-1.3b training run's."""
    for key in ("zamba2", "xlstm"):
        r = m[key]
        share = ", ".join(f"{k} {v:.1%}" for k, v in r["blocks"]["share"].items())
        print(f"[hybrid] {r['arch']}: {r['n_params']:,} parameters, {r['requests']} "
              f"requests in {r['waves']} waves, {r['flash_per_wave']} flash launches a "
              f"wave, prefill {', '.join(f'{x:.1f}' for x in r['prefill_ms'])} ms a "
              f"wave ({share} of a timed one), decode {r['decode_step_ms_median']:.2f} "
              f"ms a step, {r['tokens_per_s']:.1f} tokens/s, logits within "
              f"{r['max_logit_diff']:.3g}, chunked vs recurrent "
              f"{m['chunked'][key]['max_abs_diff']:.3g}, peak "
              f"{r['peak_abs_bytes'] / 2**30:.2f} GiB on {card}")
    f = m["zamba2_flash"]["row"]
    print(f"[hybrid] flash at D = {f['D']} (B {f['B']}, H {f['H']}, Hkv {f['Hkv']}, T "
          f"{f['Tq']}): {f['ms']:.3f} ms a call (bound {f['bound_ms']:.3f}, plain "
          f"{f['plain_ms']:.3f}, SDPA {f['library_ms']:.3f}) on {card}")
    t = m["train"]
    print(f"[hybrid] {t['arch']} training: {t['n_params']:,} parameters, {t['steps']} "
          f"steps of B {t['batch']} x T {t['seq']}, {t['step_ms_median']:.1f} ms a step "
          f"(torch program {t['ref_step_ms_median']:.1f}), {t['tokens_per_s']:.0f} "
          f"tokens/s, loss {t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}, max rel diff "
          f"{t['max_rel_diff']:.2e}, peak {t['peak_abs_bytes'] / 2**30:.2f} GiB; Adam "
          f"{t['adam']['ms']:.3f} ms a launch (bound {t['adam']['bound_ms']:.3f}) on {card}")


def print_encdec_summary(m: dict, card: str) -> None:
    """Phase 22's lines: each model's wave, whisper-tiny's engine run, the
    flash calls at the new shapes, each training run's."""
    for key in ("whisper", "pixtral"):
        r = m[key]
        prof = r["profile_prefill"]
        by = (", ".join(f"{k} {v:.1f}" for k, v in sorted(
            prof["device_ms"].items(), key=lambda kv: -kv[1])) if prof["complete"]
            else "not profiled")
        print(f"[encdec] {r['arch']}: {r['n_params']:,} parameters, a wave of "
              f"{r['batch']} x ({r['frontend_tokens']} + {r['text_tokens']}) tokens"
              + (f" with {r['encoder_frames']} frames" if r["encoder_frames"] else "")
              + f", {r['flash_per_prefill']} flash launches, prefill {r['prefill_ms']:.1f} "
              f"ms (torch {r['ref_prefill_ms']:.1f}; device ms {by}), decode "
              f"{r['decode_step_ms_median']:.2f} ms a step, {r['tokens_per_s']:.1f} "
              f"tokens/s, logits within {r['max_logit_diff']:.3g}, peak "
              f"{r['peak_abs_bytes'] / 2**30:.2f} GiB on {card}")
    e = m["whisper_engine"]
    print(f"[encdec] {e['arch']} engine (text alone): {e['requests']} requests in "
          f"{e['waves']} waves, {e['flash_per_wave']} flash launches a wave, prefill "
          f"{', '.join(f'{x:.1f}' for x in e['prefill_ms'])} ms a wave, decode "
          f"{e['decode_step_ms_median']:.2f} ms a step, {e['tokens_per_s']:.1f} "
          f"tokens/s on {card}")
    for label, f in m["flash_rows"].items():
        print(f"[encdec] flash {label} (B {f['B']}, H {f['H']}, Hkv {f['Hkv']}, Tq "
              f"{f['Tq']}, Tk {f['Tk']}, D {f['D']}, causal {f['causal']}): "
              f"{f['ms']:.3f} ms a call (bound {f['bound_ms']:.3f}, plain "
              f"{f['plain_ms']:.3f}, SDPA {f['library_ms']:.3f}) on {card}")
    for key in ("whisper_train", "pixtral_train"):
        t = m[key]
        print(f"[encdec] {t['arch']} training: {t['n_params']:,} parameters, {t['steps']} "
              f"steps of B {t['batch']} x T {t['seq']}, {t['step_ms_median']:.1f} ms a "
              f"step (torch program {t['ref_step_ms_median']:.1f}), loss "
              f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}, max rel diff "
              f"{t['max_rel_diff']:.2e}, peak {t['peak_abs_bytes'] / 2**30:.2f} GiB; Adam "
              f"{t['adam']['ms']:.3f} ms a launch (bound {t['adam']['bound_ms']:.3f}) on "
              f"{card}")


#: the libraries phases 20, 21 and 22 run
MOE_LIBRARIES = ("flash_attention", "fused_adam")
#: the libraries phase 23 runs
DIST_LIBRARIES = ("bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked", "bsr_attention",
                  "fused_adam")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", choices=("all", "20", "21", "22", "23", "24", "25"),
                    default="all",
                    help="every phase (the default), or phase 20, 21, 22, 23, 24 or 25 "
                         "alone after building the libraries it runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}")
    t0 = time.perf_counter()
    libraries = (LIBRARIES if args.phases == "all" else
                 DIST_LIBRARIES if args.phases in ("23", "24") else MOE_LIBRARIES)
    built = build.build(libraries)
    print(f"[build] nvcc sm_90a, in parallel, {time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in built.items()))
    for name in libraries:
        log = build.library_path(name).with_suffix(".so.log")
        if log.exists():
            text = log.read_text()
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
            spilling = {k: int(a) + int(b) for k, a, b in re.findall(
                r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                if int(a) + int(b)}
            print(f"[build] ptxas {name}: registers {regs[0]}-{regs[-1]}, "
                  f"spilled bytes {sum(spilling.values())}"
                  + (f" in {spilling}" if spilling else ""))

    clocks = {"query": CLOCKS, "start": card_line(CLOCKS)}
    print(f"[card] {CLOCKS}: {clocks['start']}")
    t_all = time.perf_counter()
    result = run(Sizes(), device, args.phases)
    clocks["end"] = card_line(CLOCKS)
    print(f"[card] {CLOCKS} after the phases: {clocks['end']}")
    if args.phases == "all":
        print_summary(result, card)
        print_streaming_summary(result["streaming"], card)
        print_dryrun_summary(result["dryrun"], card)
    elif args.phases == "20":
        print_moe_summary(result["moe"], card)
    elif args.phases == "21":
        print_hybrid_summary(result["hybrid"], card)
    elif args.phases == "22":
        print_encdec_summary(result["encdec"], card)
    elif args.phases == "23":
        print_distributed_summary(result["distributed"], card)
    elif args.phases == "25":
        print_dryrun_summary(result["dryrun"], card)
    else:
        print_streaming_summary(result["streaming"], card)
    print(f"[done] phases {'2-25' if args.phases == 'all' else args.phases} in "
          f"{time.perf_counter() - t_all:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in result["phase_s"].items()))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "clocks": clocks, "build_s": built, **result}, fh,
                  indent=1)
    print(card)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
