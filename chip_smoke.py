"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of the main path from ``kernels/csrc``,
     one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's decode and prefill shapes (bf16) and at
     adversarial shapes (f32 and bf16), with its time, its bound, the
     plain version's time and one PyTorch library call's time — the
     int8-weight kernels at the EP slot plane's shapes (64 slots, 16 of
     them active); the path of ``moe_gmm`` and of the int8 kernels
     ("simt" or "wgmma") is named for every shape, the main path's decode
     and prefill shapes must take "wgmma" (the int8 kernels in one launch
     a call, torch.profiler, with no workspace), and each is timed in
     turns against the simt path (the int8 decode also against the same
     active slots packed into a bank of their own); ``decode_attn``'s path ("mma" or "simt") and cluster size
     are named for every case (rows with no visible lane, lanes past
     kv_len holding 1e4, k/v off alignment among them), the main shapes
     must take "mma" and run one launch a call (torch.profiler), and
     beside the eager time each has ``device_ms``, 20 launches captured
     in a CUDA graph and timed by replay, as has its library call; then
     the same records at phase 8's new geometries: ``fused_gate_up`` and
     ``gmm`` at llama4's decode (E 128, C 1) and prefill (C 5),
     grok-1's (F 32768) and jamba's (E 16, C 2 and 80), decode
     attention (both layouts) at (H, KV, hd)
     = (32, 8, 160), (96, 8, 128) and (12, 2, 128), each on the path its
     geometry takes;
  4. the slice at full width: mixtral-8x7b at its published widths (8 of
     32 layers, bf16, random seeded weights) serving 12 requests through
     ``ServingEngine`` with the MoEless controller attached, counting
     every kernel launch of that run and timing each model call; then
     every layer's attention and MoE sublayer through the kernels against
     the plain path from the same input (a prefill and a batched decode
     step), and the full-model logits of both paths compared;
  4b. paged KV at full width, with the same weights: the paged pool
     (16-token blocks), chunked prefill (256 tokens) and the radix prefix
     cache serving two waves of 8 requests that share a 256-token system
     prompt (prefix hits, one copy-on-write, no leaked block), counting
     that run's launches and timing mixed and decode-only steps; then
     every layer's paged attention sublayer through the kernel against
     the plain path from the same input and pool;
  4c. the expert runtime on the EP slot plane at full width with int8
     slot banks: mixtral-8x7b (4 of 32 layers, bf16) serving 12 requests
     through ``ServingEngine(expert_runtime="on")`` with a session
     MoEless controller (64 single-buffered slots a layer), counting
     that run's launches
     (prefill and decode both through the int8 kernels, every launch on
     their "wgmma" path, none through the unquantized kernels), checking
     the runtime's byte meters, then
     every layer's EP MoE sublayer through the kernels against the plain
     path from the same input and tables; then the same burst with the
     load predictor (gate replicas at distance 1) on the session
     controller: its cold/warm/prewarmed starts, transfers and bytes
     against the first session's, every int8 launch on "wgmma";
  6. the OpenAI-compatible gateway at full width, on phase 4's weights
     (so it runs right after 4b, before 4c's slot banks take the
     memory): a ``GatewayServer`` on 127.0.0.1 in a thread over a
     ``Router`` of 2 replicas on 4b's paged spec, drop-free, each with a
     session MoEless controller; a greedy and a sampled request sent
     alone over HTTP give ``engine.serve``'s tokens for each alone, the
     sampled one sent again (SSE) gives them again; each sent again
     with a stop sequence taken from its own answer ends there, finish
     "stop"; 16 concurrent clients (half sampled, half SSE, completions
     and chat) all end with their budget; ``/metrics`` is Prometheus text
     with the router, scheduler, KV and control families; the paged
     kernel and both bf16 ``moe_gmm`` kernels launched, counted after
     the replicas stop; then the wall TTFT/TPOT medians over HTTP and
     through offline engines, and the sampler's launches a step;
  5. token identity: the mixtral-8x7b smoke config at float32 gives the
     same greedy tokens through the kernels as the plain path on the
     contiguous cache, at its own capacity factor (where tokens are
     dropped) and at a drop-free one, where the paged runs (solo,
     chunked, prefix-warm) through the kernels give them too, as they
     give the tokens of a trace where half the requests sample, and
     sampled batched serving gives the tokens of one request at a time;
     with the expert runtime on, the kernels give the plain path's
     tokens with float32 and int8 slot banks, and at the drop-free
     factor the runtime gives the tokens of the runtime-off engine;
     with the load predictor on the session controller, the kernels give
     the plain path's tokens and controller meters (contiguous, paged
     with chunked prefill), and the runtime the runtime-off tokens;
  7. the expert load predictor at full width, on phase 4's weights:
     the gate dataset (4 batches of 4 x 512 tokens) through
     ``transformer.forward``, whose MoE layers must launch the bf16
     kernels on "wgmma" at (E, C, D) = (8, 640, 4096), where each is
     timed beside its bound; forward's logits against ``decode_step``'s
     and the plain path's; same-layer replicas against the router
     (>= 0.98), replicas at distance 1 and 2, layer-aware fine-tuning at
     distance 1 on the card (the tuned layers' mean accuracy must rise),
     the load correlation; then phase 4's burst served with the tuned
     predictor and with the oracle controller in turns, two rounds
     each: the same tokens, one host transfer an iteration, the
     predictor's launches and device time a call, decode wall and the
     modeled clock under predicted against actual loads.

  8. the decoder model families at their published widths, each built
     on the card in turn (depth cut where the weights do not fit:
     ``FAMILY_LAYERS``) and freed before the next: 8 requests through
     ``ServingEngine`` on the contiguous cache, then on the paged pool
     with chunked prefill and the prefix cache (half sampled), the MoE
     families (llama4-maverick with its dense/MoE interleave, grok-1)
     with a MoEless controller: every request ends with its budget, no
     pool block leaks, each kernel's launches counted (every expert
     kernel launch on "wgmma"), the median decode step and prefill
     timed; every layer's sublayers through the kernels against the
     plain path; qwen2-vl also with 64 patch embeddings and 3-axis
     M-RoPE positions. The recurrent stacks, jamba-v0.1-52b (one
     8-layer period: 1 attention, 7 mamba, 4 MoE layers of 16 experts)
     with a MoEless controller and xlstm-125m (all 12 layers, no kernel
     on its path), serve the same 8 requests on the contiguous cache
     only (paged KV must raise ``ValueError``), prompts prefilled at
     exact length: every request to its budget, jamba's expert launches
     all on "wgmma" and its sublayers kernels vs plain, each mixer's
     ``*_seq`` and ``*_step`` held to each other at float32, and a
     prefill into a fresh cache held to ``forward``'s logits (the
     reference's prefill into a cache runs its mixers over the first
     prompt token only). Phase 5 then holds each family's smoke config
     (and llama4's at its interleave) to the plain path's tokens on
     the contiguous and (attention-only stacks) paged-chunked caches.
  9. training at full width (``train_loop.train``, impl "ref": no
     kernel has a backward): mixtral-8x7b at its published widths, 1 of
     32 layers (two do not fit the card: ``train_reckoning``), bf16, 8
     steps of ``TokenStream`` batches of 8 x 256 tokens: every loss
     finite and the last three below the first three, every step's
     expert loads summing to B*S*top_k a layer, the peak memory beside
     the reckoning, one step profiled (forward and backward against the
     optimizer update, the top device operations); the trained weights
     serve 4 requests through the kernels (``fused_gate_up``, ``gmm``
     on "wgmma", ``decode_attention``); from the initial weights every
     leaf's gradient is finite and nonzero, one step changes every leaf
     (but norm scales at 1.0, which a step under half a bf16 ulp cannot
     move); at a drop-free capacity factor two microbatches give the
     one-microbatch step's loss within 1e-4 and its gradients within 5%
     of each leaf's norm, remat "none" both bit for bit (with their
     peaks); and the
     step at impl "auto" raises ``NotImplementedError`` naming
     ``fused_gate_up`` with no launch; xlstm-125m trains at all 12
     layers for 3 steps (the recurrent cells' token loop under
     backward); a run resumed from a checkpoint on the card (the
     mixtral smoke config, float32) equals the uninterrupted run bit
     for bit in parameters, moments and step.

  10. whisper-base at its published widths (6 encoder and 6 decoder
     layers, d_model 512, 1500 frames, vocab 51865; no depth cut),
     seeded weights and frame embeddings, through the fixed-batch API
     (``ServingEngine.prefill``/``decode``), the only way the reference
     serves an encoder-decoder: ``start()`` and paged KV must refuse it;
     two batches of 8 prompts (4 and 128 tokens) each decode 64 steps,
     launching ``decode_attention`` once a decoder layer a step, all on
     "mma", and no other kernel; the encoder, the prefill and a decode
     step timed (wall, device busy, launches, idle share) with the share
     of a step that cross-attention and its key/value products over the
     frames take; gated at bf16: every decoder layer's self-attention
     sublayer through the kernel against the plain path from the same
     input and cache, a stand-in kernel blind to the newest eighth of
     the keys must fail that gate, and the whole-model logits are
     reported, not gated; then
     at float32: each batch's greedy tokens through the kernels equal the
     plain path's, a prefill into a fresh cache and the 8 decode steps
     after it give ``forward``'s logits within 1e-4, and a zeroed encoder
     output moves the prefill's logits by more than 0.1 (the reference's
     ``decode_step`` applies no cross-attention and gives every prompt
     token one position). Phase 3 first times decode attention at its
     geometry (B 8, H 8, KV 8, hd 64, "mma"); phase 5 adds whisper's
     smoke config through the fixed-batch API and mixtral-8x7b's at act
     gelu (``gmm`` launched, ``fused_gate_up`` never).

  11. multi-rank EP: ``ServingEngine(mesh=...)`` over local ranks that
     share cuda:0 (``launch.mesh.spawn_local`` over gloo, NCCL refusing
     two ranks on one device; their collectives move the card's tensors
     through staging buffers all ranks map, ``launch.transport``), mixtral-8x7b at its published
     widths (``MR_WORLDS``): W1 (1,4,1) bf16 and W2 (1,4,1) float32 at 1
     of 32 layers, W3 (1,2,2) with int8 slot banks at 2; each rank holds
     the replicated non-expert layers and its slice of the slot banks.
     The parent runs each world's (1,1,1) session in its own turn, then
     the world. Gated: each world's layer-0 MoE output on one fixed
     input against one rank's (at its dtype's tolerance), with a
     control (rank 1 keeping its gather all-to-all's input) that must
     fail it; W2's float32 tokens, loads, drops, runtime meters, summed
     rank_bytes and modeled latencies equal the (1,1,1) session's, and
     the control's burst must change its tokens or loads; every rank
     launches the expert kernels and ``decode_attention``; each rank's
     bytes written x tp equal its rank_bytes share. Printed: per-rank
     launches, peak memory beside its reckoning, expert FFN device ms,
     each collective's host ms, decode step wall, and W1/W3 against
     (1,1,1).

  12. the dry-run and sharding: (a) ``launch.dryrun.run_one`` for all
     12 archs x 4 input shapes on the 16x16 logical mesh, built and
     counted on the meta device in 8 processes (``launch.dryrun.
     sweep``); gated: every combination builds, the card's allocation
     is unchanged and no worker initialised CUDA, flops and peak bytes a
     rank positive, a train step at least 6 N T operations (N without an
     untied embedding table, which only a lookup reads); (b) ZeRO-2
     (``make_train_step(grad_shardings=)`` over a (2, 1)
     ``launch.mesh.ProcessMesh``): mixtral-8x7b at published widths, 1
     of 32 layers, bf16, 8 x 256 tokens in 2 microbatches, 2 steps, two
     ranks on cuda:0, after the one-process oracle at dispatch
     groups 2 in this process (which then holds nothing on the card);
     gated at phase 9's drop-free capacity: each step's loss within
     ``MB_LOSS_TOL`` of the one-process step from the same weights, the
     gathered step-1 accumulator within ``GRAD_REL_TOL`` of each leaf's
     norm, the sharded AdamW within one bf16 ulp of the unsharded update
     of the same gradients, both ranks' parameters equal after each
     step, accumulator, mu and nu exactly half the one-process bytes,
     resident parameters + optimizer + batch bytes equal to
     ``launch.dryrun.build_step``'s shardings on the same mesh; printed:
     peak a rank against ``zero2_reckoning``, step walls, each
     collective's host ms, the bytes moved to the front and gathered;
     (c) the Mamba levers at jamba-v0.1-52b's mixer widths over 512
     tokens, forward and backward: float32 outputs and gradients of each
     within ``MAMBA_TOL`` of the default path, bf16 reported, each
     timed.

  13. tensor parallelism (model > 1): ``fused_gate_up`` and ``gmm`` at
     the F-shard shapes of the (1, 2) prefill and at the one-process
     prefill's, each against its plain version and timed; the
     one-process oracles in this process (phase 12's training step at
     dispatch groups 1 and 2, the prefill on the kernel path at float32
     and bf16), which then holds nothing on the card; (a) phase 12's
     training cell through ``make_train_step(grad_shardings=)`` on
     (data, model) = (1, 2) for 2 steps and (2, 2) for 1 (``TP_TRAIN``),
     ranks on cuda:0, gated: each step's loss within
     ``MB_LOSS_TOL`` of the one-process step from the same weights, the
     step-1 accumulator assembled from every rank's shard within
     ``GRAD_REL_TOL`` of each leaf's norm, the sharded AdamW within one
     bf16 ulp of the unsharded update of those gradients, data replicas
     and the model ranks' whole leaves equal, resident parameter +
     optimizer + batch bytes equal to ``launch.dryrun.build_step``'s
     shardings (``fsdp_params`` False) on the same mesh; printed: peak a
     rank against ``tp_reckoning``, step walls, each collective's host
     ms, the bytes gathered over the model group; (b) on the (1, 2)
     ranks, ``make_prefill_step(param_shardings=)`` at impl "auto" over
     8 x 512 tokens: float32 at 2 layers, logits within TOL[float32] of
     the one-process prefill, greedy tokens, loads and drops equal;
     bf16 at 2 layers, every MoE sublayer from the one-process path's
     own input within TOL[bf16] and a control (rank 1 adding zeros for
     its partial sum, ``SkipPartial``) leaving more than
     ``TP_CONTROL_SHARE`` of each sublayer out of it; both kernels
     launched once a layer a rank at (E, C, D, F) = (8, 1280, 4096,
     7168) and (8, 1280, 7168, 4096), on "wgmma" at bf16; printed: the
     prefill wall a rank against one process, the model group's host ms
     and bytes.

  14. the sharded decode step (``make_serve_step(param_shardings=,
     cache_shardings=)``): (a) ``decode_attention(return_stats=True)``
     at the (1, 2) sequence shard of mixtral-8x7b (B 8, H 32, KV 8, hd
     128, S 2048), bf16 ("mma") and float32 ("simt"), kv_len 0, 1, 17,
     1000, 2047, 2048, a row hidden by position, a window of 256: the
     float32 output within TOL of the plain version and each row within
     ``DEC_REL`` in norm, m and l within ``DEC_STATS_TOL`` of the plain
     version fed the kernel's own q * scale, m = NEG_INF and l = S
     exactly on rows with no visible lane; two S 2048 shards merged by
     ``merge_softmax`` within TOL of one S 4096 call; timed with and
     without statistics beside its bound, the plain version, SDPA and
     the merge; ``fused_gate_up`` and ``gmm`` at the bf16 decode
     F-shard shapes (F 7168, C 3, 2 and 4) against their plain versions
     (``dec_kernel_shapes``); (b) in this process the one-process
     oracles on the kernel path (prefill of 8 x 2040 tokens into a
     4096-slot cache, then 16 greedy decode steps) and their witnesses
     (bf16: the same steps at impl "ref"; float32: ``ExpertHalves``,
     the ranks' expert sum in one process), after which it holds nothing on
     the card; mixtral-8x7b at its published widths on (1, 2) ranks on
     cuda:0, float32 at 2 layers (every step's logits within
     TOL[float32], greedy tokens, loads and drops equal, the cache
     assembled from the ranks' shards: positions equal, K/V within
     ``DEC_KV_TOL`` in the first layer and ``DEC_KV_DEEP_TOL`` after)
     and bf16 at 2 (every attention sublayer of every decode step
     against one process on the whole cache from the same input:
     elementwise within TOL[bf16] and within ``DEC_REL`` in norm; the
     ``PlainMean`` control moved past ``DEC_CONTROL`` x ``DEC_REL`` on
     every step before step 9, whose write is the first into rank 1's
     slots; every MoE sublayer of every decode step from the one-process
     input, ``moe_sublayer_gates``, at the same bounds, its
     ``SkipPartial`` control leaving more than ``TP_CONTROL_SHARE`` out
     and moving the norm past ``DEC_CONTROL`` x ``DEC_REL``), and on
     (2, 2) ranks bf16 at 1 layer under the default layout,
     ``seq_over_dp`` and ``cache_heads_model``, with the same bf16
     gates; on every run ``decode_attention``, ``fused_gate_up`` and
     ``gmm`` launched once a layer a step a rank, at the shard's S (with
     statistics) and F 7168 and the run's C, on "mma"/"wgmma" at bf16,
     and each rank's parameter and cache bytes equal to
     ``launch.dryrun.build_step``'s decode shardings; printed: the
     decode step's wall a rank against one process, host ms and bytes
     of each collective by name, peak a rank against
     ``dec_reckoning``, the witnesses' drift beside the ranks'.

  15. the ZeRO-3 layout (``params_shardings(fsdp=True)``: every leaf
     split over data as well, gathered over the data group at use a
     layer period at a time, ``tensor_parallel.gather_from_data``), ranks
     on cuda:0: (a) mixtral-8x7b at its published widths, 1 of
     32 layers (phase 14's (2, 2) depth), bf16, impl "auto", on (2, 1)
     and (2, 2):
     phase 13's prefill cell (8 x 512) and phase 14's decode cell (B 8, a
     2040-token prefill into 4096 slots, then steps fed the same tokens:
     4 under the default cache layout on (2, 1), 10 under
     ``seq_over_dp`` on (2, 2), through the step that first writes its
     second data rank's slots; ``Z3_SERVE``)
     through ``make_prefill_step`` and ``make_serve_step`` on the
     ZeRO-3 shards, against the same mesh's ``fsdp=False`` steps from the
     same weights and inputs: two ``fsdp=False`` runs must agree bit for
     bit (the witness), and then the ZeRO-3 logits and caches must equal
     theirs bit for bit (else the gate is TOL[bf16] elementwise and
     ``DEC_REL`` in norm); the control (``SwappedShards``: layer 0's
     attention output projection gathered with its data shards swapped,
     in the prefill and in the first decode step) must fail that gate; ``fused_gate_up`` and ``gmm`` launched once a
     layer a call on "wgmma", ``decode_attention`` once a layer a step on
     "mma"; resident parameter bytes a rank equal to ``launch.dryrun.
     build_step``'s default variant (``fsdp_params`` on) and below the
     ``fsdp=False`` layout's; (b) phase 12's training cell through
     ``make_train_step(param_shardings=)`` on (2, 1) for two steps and
     (2, 2) for one, against the ZeRO-2 step on the same mesh from the same
     weights and batches (phase 12's ranks, phase 13's (2, 2) ranks):
     each step's loss within ``MB_LOSS_TOL``, the assembled parameters
     after the last step within one bf16 ulp (bit for bit reported), the
     parameters still this rank's (data, model) shards, resident
     parameter and optimizer bytes equal to the dry-run's reckoning and
     below ZeRO-2's; printed: walls a step a rank, host ms and bytes of
     ``all_gather/data/params`` and ``reduce_scatter/data/grads``, peaks.

  16. the sharded decode step of recurrent and encoder-decoder caches
     (``make_serve_step(param_shardings=, cache_shardings=)`` for
     jamba-v0.1-52b, xlstm-125m and whisper-base at their published
     widths), on phase 14's ranks after phase 14's runs (one spawn of
     ranks a mesh serves both phases): (a) ``decode_attention(
     return_stats=True)`` at jamba's (1, 2) sequence shard (B 8, H 32,
     KV 8, hd 128, S 128, bf16, "mma") and whisper's (2, 2) one (B 4, H
     8, KV 8, hd 64, S 128, float32 timed, "simt"), phase 14's checks
     at each; ``fused_gate_up`` and ``gmm`` at jamba's F-shard (E 16, D
     4096, F 7168, C 2) against their plain versions; (b) in this
     process the one-process oracles on the kernel path (8 prompts of
     126 tokens prefilled into a 256-slot cache, 4 greedy steps), then
     on the ranks (``ST_RUNS``): xlstm-125m (12 layers) float32 on (1,
     2) under the default layout and bf16 on (2, 2) under
     ``seq_over_dp``; whisper-base (6 + 6 layers, 1500 frames) float32
     on (1, 2) under ``cache_heads_model`` and on (2, 2) under the
     default layout with ZeRO-3 parameters; jamba-v0.1-52b (one 8-layer
     period of 32) bf16 on (1, 2) under the default layout. Gated:
     float32 every step's logits within TOL[float32] of one process,
     greedy tokens equal, every cache leaf assembled from the ranks'
     shards within ``ST_STATE_TOL`` (positions exactly); bf16 every
     attention, recurrent mixer and MoE sublayer of every step against
     one process from the same input (the mixers' new state too) within
     ``DEC_REL`` in norm, each with a control that must fail (the plain
     mean before step 3, the rank writing back the other rank's slice
     of a state leaf, rank 1's expert partial skipped); the kernels
     launched once a sublayer a step at the shard's S and F 7168 on
     their paths; each rank's parameter and cache bytes the dry-run's.

  17. the expert-parallel layout (``params_shardings(ep_experts=True)``:
     each model rank holds E/model whole experts, runs ``fused_gate_up``
     and ``gmm`` on its experts' rows of the dispatch buffer and
     all-gathers their outputs before the combine; no expert leaf is
     gathered over "model"), on phase 14's ranks after phase 16: (a)
     ``fused_gate_up`` and ``gmm`` at (E, C, D, F) = (4, C, 4096, 14336)
     and (4, C, 14336, 4096), C of the decode cells (3, 2) and the
     prefills (1280, 640), against their plain versions and timed; (b)
     in this process the one-process bf16 prefill of 8 x 512 tokens at
     each mesh's depth and dispatch groups (its MoE calls kept), then on
     the ranks mixtral-8x7b at its published widths, bf16, impl "auto":
     on (1, 2) ``fsdp=False`` at 2 layers and on (2, 2) ZeRO-3 at 1, the
     prefill and phase 14's decode cell under the default cache layout,
     and on (2, 2) phase 15's training cell for one ZeRO-3 step (impl
     "ref"). Gated: every MoE sublayer from the one-process input bit
     for bit or within TOL[bf16] and ``DEC_REL``, the control
     (``RolledExperts``: the gathered outputs rolled by one rank's
     experts) past ``DEC_CONTROL`` x ``DEC_REL``; the (1, 2) prefill's
     logits bit for bit or within TOL[bf16] and ``DEC_REL``, loads and
     drops equal; every decode step's tokens, loads and logits against
     one process where phase 14's own run of the cell agrees with it,
     and always against that run on the same ranks (tokens, and rows
     within ``DEC_CONTROL`` x ``DEC_REL`` in norm, in ``EP_DEC_AGREE``
     of the rows and steps); the expert kernels once a layer a call at E/2 experts with F whole
     on "wgmma"; each call's ``all_gather/model`` bytes the weights
     phase 14's run gathers (no expert leaf) and
     ``all_gather/model/experts`` E x C x D x 2 a layer; resident bytes
     the dry-run's ``ep_experts`` variant's; each rank's peak less what
     it held, less under ZeRO-3 the E/model experts its gather over data
     makes whole, below one period's whole expert banks; training: the loss within ``MB_LOSS_TOL`` of
     phase 13's ZeRO-2 step, the step-1 gradients within
     ``GRAD_REL_TOL`` of its accumulator in each leaf's norm, the
     sharded update within one bf16 ulp of the unsharded update of those
     gradients. Printed: the walls a rank against the same mesh's
     default layout (phases 13, 14, 15) and one process, each
     collective's host ms and bytes, the bytes the expert gather moves
     into a rank, peaks.

  18. the paper's trace replay (``launch/serve_trace.py``: ``replay`` ->
     ``ServingEngine.serve`` -> ``ControlPlane.step`` ->
     ``ExpertRuntime.apply`` -> the kernels) at published widths, one
     ``generate_requests`` trace of 23 requests (``REPLAY_TRACE``, 16
     new tokens at most, 8 slots, time_scale 20): first the expert
     kernels at phi-3.5-moe's shapes against their plain versions, timed
     beside their bounds (``fused_gate_up``/``gmm`` at E 16, C 2 and 40,
     F 6400; the int8 pair on 40 and 128 slots); (a) phi-3.5-moe (d_model
     4096, 32/8 heads, 16 experts x 6400, top-2, vocab 32064, bf16) at 8
     of 32 layers under MoEless with the runtime off, then at 4 under
     megatron-lm, eplb, oracle and moeless with the runtime on and int8
     slot banks (MoEless at E slots a device); (b) mixtral-8x7b at 4
     layers under the four, int8 banks; each replay's launches gated:
     ``decode_attention`` and its path's expert kernels, on "mma" and
     "wgmma", none of the other path's and no plain version called;
     printed a replay: requests, iterations, occupancy, drops, wall,
     median iteration wall, decode tokens/s by wall, the runtime's
     starts, copies, bytes and the host ms of ``apply``, peak memory,
     and the modeled (v5e cost model) TTFT/TPOT/E2E; bf16 tokens are
     reported, not gated; (c) the float32 gate: the four strategies on
     phi-3.5-moe at 2 layers with int8 banks over 7 requests, kernels
     (impl "cuda") equal to the plain versions on the card (impl "ref")
     in tokens, iterations, clock, drops, the control plane's latencies,
     replica counts, cost and host transfers, and the runtime's starts,
     copies and bytes; the control, MoEless with decode attention blind
     to the newest keys, must differ.

  19. the JAX package's last entry points as the port's
     ``repro_torch.launch`` modules, in one process: (a)
     ``quickstart.run`` on mixtral-8x7b at its published widths and the
     example's 4 layers, bf16, seeded weights (the gate dataset's
     forward, fine-tuning at distance 1, 8 requests through start /
     submit / stream / cancel / run with the fine-tuned predictor, the
     cost model): 7 records and 1 cancelled, every other request to its
     12 tokens, the streamed tokens handle 0's, the gate dataset's
     forward and the serving launching ``fused_gate_up``/``gmm`` on
     "wgmma" and the serving ``decode_attention`` on "mma", no plain
     version called, the tuned layers' mean accuracy not lower; then the
     float32 gate at 2 layers, kernels (impl "cuda") against the plain
     versions (impl "ref") from the same weights: every handle's
     tokens, the streamed tokens, the records (but their wall-clock
     latencies), the cancelled count and the fine-tuned layers equal,
     the accuracies within one top-k overlap; its control, request 1's
     sampling seed changed, must change request 1's tokens; (b)
     ``train_moe.run`` at the example's config, 200 steps: every loss
     finite and the loss dropping; (c) ``python -m
     repro_torch.launch.gateway_smoke --device cuda`` as a subprocess
     (the launcher with the expert runtime on, paged KV, chunked prefill
     and the prefix cache, ``--impl auto``, over HTTP against the
     contiguous runtime-off engine): exit code 0, and this process's
     offline engine gives the tokens it printed, its launches counted.

  20. ``ep_shardmap_serving.run`` on the example's (data 2, ep 2, tp 2)
     mesh of 8 ranks sharing cuda:0, at mixtral-8x7b's expert widths (E
     8, D 4096, F 14336, top-2, bf16, 8 slots a rank, 16 replicas at
     most), the example's 4 iterations and 2 more re-planned from a
     skewed load vector, after the one-process run on the same inputs
     (freed before the spawn): gated as ``ep_example_phase`` says, with
     the expert kernels first timed at a rank's geometry (8 slots, C 64,
     D 4096, F 7168) beside their bounds and library calls.

Phases run in the order 1, 2, 3, 4, 4b, 6, 7, 4c, 8, 9, 10, 5, 18, 19,
11, 20, 12, 13, 14, 16 and 17 (one spawn of ranks a mesh), 15.

The second-to-last line is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402

# H100 SXM data sheet: HBM rate and dense peak rates by input type
HBM_BYTES_S = 3.35e12
PAGED_BLOCK, PAGED_CHUNK = 16, 256   # the paged phase's serving knobs
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # atol = rtol
# how the multi-rank phases' ranks share the card: spawned over gloo,
# their collectives through staging buffers every rank maps
# (launch.transport, the mesh's transport="shared")
ON_CARD = "on cuda:0 (collectives through shared staging buffers)"
# the multi-rank phases' ranks and the dry-run's workers fork from one
# server process that imported torch, this script and the port's modules
# once; a spawned process imports them again, seconds a rank. They are
# named as modules: Python 3.12's forkserver skips a "__main__" preload
# (it asks the parent for a "main_path" that ``multiprocessing.spawn``
# does not give), so that preload imported nothing and every rank
# imported torch and the script anew.
START_METHOD = "forkserver"
FORKSERVER_PRELOAD = [
    "chip_smoke", "repro_torch.models.model", "repro_torch.serving.engine",
    "repro_torch.serving.expert_runtime", "repro_torch.distributed.ep",
    "repro_torch.distributed.sharding",
    "repro_torch.distributed.tensor_parallel", "repro_torch.launch.dryrun",
    "repro_torch.launch.transport", "repro_torch.training.train_loop",
    "repro_torch.training.checkpoint",
    "repro_torch.launch.ep_shardmap_serving"]
SOURCES = {
    "fused_gate_up": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm.py:198"),
    "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm.py:69"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:71"),
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                               "src/repro/kernels/decode_attn.py:127"),
    "fused_gate_up_quant": ("src/repro_torch/kernels/csrc/moe_gmm_q.cu",
                            "src/repro/kernels/moe_gmm.py:268"),
    "gmm_quant": ("src/repro_torch/kernels/csrc/moe_gmm_q.cu",
                  "src/repro/kernels/moe_gmm.py:130"),
}
# phase 4c's session controller: MoElessController(num_devices=8,
# slots_per_device=8). With E = 8 experts a device never holds more than
# 8 instances, so no slot allocation can fail; the default 3 slots a
# device (24 a layer) fill up within a few iterations of this burst, as
# the modeled clock spans well under the 60 s keep-alive and no instance
# is ever reaped (the reference runtime raises there too). The bank is
# single-buffered (the engine's runtime_double_buffer=False): 64 int8
# slots x 176.25 MB = 11.3 GB a layer, 15.7 GB with the layer's padded
# quantized bank and its own bf16 experts, so 4 layers fit the card;
# double buffering would take 26 GB a layer. Phase 5 and the CPU tests
# hold double- and single-buffered banks equal.
EP_DEVICES, EP_SLOTS_PER_DEVICE = 8, 8
RUNTIME_LAYERS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Milliseconds per launch: CUDA events around `iters` back-to-back
    launches, over the count; the median of `reps` such runs after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, got, want, dtype) -> float:
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} "
                             f"beyond atol=rtol={tol}")
    return err


# ------------------------------------------------------------ phase 3


def _gmm_inputs(gen, e, c, d, f, dtype, gs, fused):
    dev = "cuda"
    x = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    scale = 1.0 / math.sqrt(d)
    wg = (torch.randn((e, d, f), generator=gen, device=dev, dtype=dtype)
          .mul_(scale))
    wu = (torch.randn((e, d, f), generator=gen, device=dev, dtype=dtype)
          .mul_(scale)) if fused else None
    return x, wg, wu, torch.tensor(gs, dtype=torch.int32, device=dev)


def _gmm_bytes_flops(x, wg, wu, gs):
    """Bytes and operations this call's data needs: weights of experts
    with rows, x rows inside their group, every output element."""
    e, c, d = x.shape
    f = wg.shape[2]
    isz = x.element_size()
    g = gs.clamp(0, c).cpu()
    rows = int(g.sum())
    n_w = 2 if wu is not None else 1
    live = int((g > 0).sum())
    nbytes = (rows * d + n_w * live * d * f + e * c * f) * isz + 4 * e
    return nbytes, 2.0 * n_w * rows * d * f


def _gmm_run(name, fused, x, wg, wu, g, path=None):
    """The kernel on `path` (None: its plan's; else a key of MG.PATHS,
    forced to time one path against another)."""
    return MG._launch(name, fused, x, wg, wu if fused else None, g,
                      path=path)


def _gmm_check(name, fused, label, x, wg, wu, g, dtype, path=None):
    """The kernel (on `path`) against its plain version, rows past the
    group size exactly 0; returns the largest error."""
    got = _gmm_run(name, fused, x, wg, wu, g, path)
    want = (MG.fused_gate_up_ref(x, wg, wu, g) if fused
            else MG.gmm_ref(x, wg, g))
    torch.cuda.synchronize()
    err = check(f"{name} [{label}, {dtype}]", got, want, dtype)
    zero = torch.arange(x.shape[1], device="cuda")[None] >= g[:, None]
    if got[zero].abs().sum() != 0:
        raise AssertionError(f"{name} [{label}]: rows past the group size "
                             "are not zero")
    return err


def _gmm_plain_library(fused, x, wg, wu, g):
    """The plain version of the call and one library call computing the
    same function (``bmm``, silu and a row mask)."""
    mask = torch.arange(x.shape[1], device="cuda")[None, :, None] \
        < g[:, None, None]
    if fused:
        return (lambda: MG.fused_gate_up_ref(x, wg, wu, g),
                lambda: torch.where(mask, F.silu(torch.bmm(x, wg))
                                    * torch.bmm(x, wu), 0.0))
    return (lambda: MG.gmm_ref(x, wg, g),
            lambda: torch.where(mask, torch.bmm(x, wg), 0.0))


def _alternate(fn_a, fn_b, timer=None) -> tuple[float, float]:
    """Times of two versions taken in turns (a, b, b, a) by `timer`
    (default time_ms): the mean of each."""
    timer = timer or time_ms
    ta1, tb1, tb2, ta2 = timer(fn_a), timer(fn_b), timer(fn_b), timer(fn_a)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: `iters` calls of `fn` captured once in
    a CUDA graph, each replay timed by CUDA events, over the count; the
    median of `reps` replays after a warm-up replay. Unlike time_ms, the
    host's cost of a call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return float(np.median(times))


def one_launch(name: str, fn, kernel: str = "decode_attn",
               n: int = 4) -> None:
    """Fail unless each call of `fn` runs exactly one device operation,
    a kernel whose name holds `kernel`, in a torch.profiler trace of `n`
    calls after a warm-up. A trace that misses some of the kernel's
    events (and shows nothing else) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count / n for e in prof.key_averages()
               if "cuda" in str(getattr(e, "device_type", "")).lower()}
        if len(ops) != 1 or kernel not in next(iter(ops)) \
                or next(iter(ops.values())) > 1:
            break
        if next(iter(ops.values())) == 1:
            log(f"  {name:<22} one launch a call: "
                f"{next(iter(ops))[:72]}")
            return
    raise AssertionError(f"{name}: a call should run one kernel launch; "
                         f"the profiler saw {ops}")


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of `fn`, `n` calls enqueued back to back
    (far fewer than the launch queue holds, so the host never waits on
    the card), from the host clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def check_gmm_kernels(gen, shapes) -> dict:
    """fused_gate_up and gmm against their plain versions at adversarial
    shapes (both dtypes; bf16 with D, F multiples of 8 takes wgmma), then
    at the main path's decode and prefill shapes (bf16), which must take
    the wgmma path, timed beside the bound, the plain version and the
    library call, and at decode in turns against the simt path. Returns
    the per-kernel records."""
    rec = {}
    cases = [  # (label, E, C, D, F, group sizes)
        ("C7/D96/F40", 3, 7, 96, 40, [7, 3, 0]),
        ("all-zero gs", 2, 16, 96, 40, [0, 0]),
        ("one partial expert", 4, 33, 64, 72, [0, 0, 17, 0]),
        ("E=1", 1, 40, 128, 136, [40]),
        ("odd F=37", 2, 12, 40, 37, [12, 5]),
        ("C9 D40 F72 gs 9/1/0", 3, 9, 40, 72, [9, 1, 0]),
        ("C64 D200 F136", 2, 64, 200, 136, [64, 33]),
        ("C65 F200", 2, 65, 64, 200, [65, 0]),
        ("C160 E=1", 1, 160, 128, 256, [160]),
        ("C200: 2 row groups", 2, 200, 96, 136, [200, 161]),
        ("long D: C24 D4104", 2, 24, 4104, 136, [24, 7]),
        ("C300", 2, 300, 64, 72, [300, 257]),
        ("C40 D4104 F200", 3, 40, 4104, 200, [1, 40, 0]),
    ]
    for name, fused in (("fused_gate_up", True), ("gmm", False)):
        for label, e, c, d, f, gs in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, dtype, gs, fused)
                err = _gmm_check(name, fused, label, x, wg, wu, g, dtype)
                path, info = MG.kernel_path(x, wg, fused)
                tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
                if path != ("wgmma" if tma else "simt"):
                    raise AssertionError(f"{name} [{label}]: path {path}")
                log(f"  {name:<16} {label:<20} {str(dtype):<15} "
                    f"{path:<5} N={info['rows']:<3} max_abs_err={err:.3e}")
                if not tma:
                    continue
                # the forced path timed below holds at every shape too
                err = _gmm_check(name, fused, f"{label}, simt", x, wg, wu, g,
                                 dtype, "simt")
                log(f"  {name:<16} {label:<20} forced simt "
                    f"max_abs_err={err:.3e}")
        # x 2 bytes past an aligned buffer: no tensor map takes it
        e, c, d, f, gs = 2, 64, 96, 136, [64, 30]
        x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, torch.bfloat16, gs,
                                   fused)
        buf = torch.zeros(x.numel() + 8, dtype=x.dtype, device="cuda")
        xm = buf[1:1 + x.numel()].view(x.shape)
        xm.copy_(x)
        path = MG.kernel_path(xm, wg, fused)[0]
        if path != "simt" or xm.data_ptr() % 16 != 2:
            raise AssertionError(f"{name}: misaligned x took {path}")
        err = _gmm_check(name, fused, "x misaligned by 2 B", xm, wg, wu, g,
                         torch.bfloat16)
        log(f"  {name:<16} {'x misaligned by 2 B':<20} torch.bfloat16  "
            f"{path:<5} max_abs_err={err:.3e}")
        for phase in ("decode", "prefill"):
            e, c, d, f, gs = shapes[name][phase]
            dtype = torch.bfloat16
            x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, dtype, gs, fused)
            path, info = MG.kernel_path(x, wg, fused)
            if path != "wgmma":
                raise AssertionError(f"{name}: the {phase} shape took "
                                     f"{path}, not wgmma")
            alt = "simt" if phase == "decode" else None
            run = lambda: _gmm_run(name, fused, x, wg, wu, g)  # noqa: E731
            plain, library = _gmm_plain_library(fused, x, wg, wu, g)
            err = _gmm_check(name, fused, f"{phase} {e}x{c}x{d}x{f}", x, wg,
                             wu, g, dtype)
            if alt is None:
                ms, alt_ms = time_ms(run), None
            else:
                alt_err = _gmm_check(name, fused, f"{phase}, {alt}", x, wg,
                                     wu, g, dtype, alt)
                run_alt = lambda: _gmm_run(  # noqa: E731
                    name, fused, x, wg, wu, g, alt)
                ms, alt_ms = _alternate(run, run_alt)
                if phase == "decode":   # the host cost of each path a call
                    us, alt_us = _alternate(run, run_alt, host_us)
                    log(f"  {name:<16} {phase:<8} host us a call, in turns: "
                        f"{path} {us:.1f}, {alt} {alt_us:.1f}")
            plain_ms = time_ms(plain)
            lib_ms = time_ms(library)
            nbytes, flops = _gmm_bytes_flops(x, wg, wu, g)
            b_ms, b_by = bound(nbytes, flops, dtype)
            log(f"  {name:<16} {phase:<8} E={e} C={c} D={d} F={f} bf16 "
                f"({path}, N={info['rows']}, {info['stages']} stages, "
                f"{info['smem']} B shared a CTA) max_abs_err={err:.3e} "
                f"ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f}")
            if alt is not None:
                log(f"  {name:<16} {phase:<8} in turns with the plan's: "
                    f"{alt} ms={alt_ms:.4f} (max_abs_err={alt_err:.3e})")
            if phase == "decode":
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, path=path,
                                 **{f"decode_{alt}_ms": alt_ms})
            else:
                rec[name].update(
                    prefill_ms=ms, prefill_bound_ms=b_ms,
                    prefill_plain_ms=plain_ms, prefill_library_ms=lib_ms,
                    prefill_max_abs_err=err, prefill_path=path)
            del x, wg, wu
            torch.cuda.empty_cache()
    return rec


def _quant_inputs(gen, e, c, d, f, dtype, gs, fused):
    """x, per-slot quantized weights (int8 values, f32 row scales: the
    slot-bank layout, one slot at a time so no float bank exists), gs."""
    from repro_torch.kernels import quant as QT
    dev = gen.device
    x = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    ws = []
    for _ in range(2 if fused else 1):
        q = torch.empty((e, d, f), dtype=torch.int8, device=dev)
        sc = torch.empty((e, d), dtype=torch.float32, device=dev)
        for i in range(e):
            w = torch.randn((d, f), generator=gen, device=dev,
                            dtype=dtype).mul_(1.0 / math.sqrt(d))
            q[i], sc[i] = QT.quantize_rows(w)
        ws += [q, sc]
    return x, ws, torch.tensor(gs, dtype=torch.int32, device=dev)


def _quant_bytes_flops(x, ws, gs):
    """Bytes and operations this call's data needs: int8 weights and f32
    scales of slots with rows, x rows inside their group, every output
    element; two operations per multiply-add of the rows in groups."""
    e, c, d = x.shape
    f = ws[0].shape[2]
    isz = x.element_size()
    g = gs.clamp(0, c).cpu()
    rows = int(g.sum())
    n_w = len(ws) // 2
    live = int((g > 0).sum())
    nbytes = (rows * d + e * c * f) * isz + n_w * live * (d * f + 4 * d) \
        + 4 * e
    return nbytes, 2.0 * n_w * rows * d * f


def _quant_run(name, fused, x, ws, g, max_active=0, path=None):
    """The int8 kernel on `path` (None: its plan's; else a key of
    MG.PATHS, forced to time one path against another)."""
    qs = [(ws[i], ws[i + 1]) for i in range(0, len(ws), 2)]
    return MG._launch_quant(name, fused, x, qs, g, max_active, path=path)


def _quant_check(name, fused, label, x, ws, g, dtype, max_active=0,
                 path=None):
    """The int8 kernel (on `path`) against its plain version, in x's
    dtype, rows past the group size exactly 0; returns the largest
    error."""
    got = _quant_run(name, fused, x, ws, g, max_active, path)
    want = (MG.fused_gate_up_quant_ref(x, *ws, g) if fused
            else MG.gmm_quant_ref(x, *ws, g))
    torch.cuda.synchronize()
    err = check(f"{name} [{label}, {dtype}]", got, want, dtype)
    zero = torch.arange(x.shape[1], device=x.device)[None] >= g[:, None]
    if got.dtype != dtype or got[zero].abs().sum() != 0:
        raise AssertionError(f"{name} [{label}]: wrong dtype or rows past "
                             "the group size not zero")
    return err


def _quant_library(fused, x, ws, g):
    """The library composition of an int8 kernel's function on these
    inputs (dequantize the slots with rows to x's dtype, ``bmm``, silu,
    mask), and the indices of those slots."""
    e, c, _ = x.shape
    f, dtype = ws[0].shape[2], x.dtype
    idx = torch.nonzero(g > 0).flatten()
    mask = torch.arange(c, device=x.device)[None, :, None] \
        < g[idx].long()[:, None, None]

    def library():
        xa = x[idx]
        deq = [ws[i][idx].to(dtype) * ws[i + 1][idx, :, None].to(dtype)
               for i in range(0, len(ws), 2)]
        y = torch.bmm(xa, deq[0])
        if fused:
            y = F.silu(y) * torch.bmm(xa, deq[1])
        out = torch.zeros((e, c, f), dtype=dtype, device=x.device)
        out[idx] = torch.where(mask, y, 0.0)
        return out
    return library, idx


def check_quant_kernels(gen, shapes) -> dict:
    """fused_gate_up_quant and gmm_quant against their plain versions at
    adversarial shapes (f32 and bf16; bf16 with D % 8 == 0 and F % 16 ==
    0 takes wgmma, the rest simt; the path is asserted and logged), then
    at the EP slot plane's decode and prefill shapes (bf16, 16 of 64
    slots active), which must take wgmma in one launch with no workspace,
    timed in turns against the simt path, beside the bound, the plain
    version and the library composition (dequantize the active slots to
    x's dtype, ``bmm``, silu, mask). Returns the per-kernel records."""
    rec = {}
    active16 = [(i % 3) + 1 if i % 4 == 1 else 0 for i in range(64)]
    cases = [  # (label, E, C, D, F, group sizes)
        ("C7/D96/F40", 3, 7, 96, 40, [7, 3, 0]),
        ("all-zero gs", 2, 16, 96, 40, [0, 0]),
        ("E=1", 1, 7, 96, 40, [5]),
        ("odd F=37", 2, 12, 40, 37, [12, 5]),
        ("split D, F%16=0", 4, 3, 1024, 64, [3, 0, 1, 2]),
        ("C=40", 3, 40, 96, 48, [40, 17, 0]),
        ("C=70 D=200", 2, 70, 200, 64, [70, 65]),
        ("C=1", 2, 1, 96, 48, [1, 0]),
        ("C=8 F=144", 2, 8, 128, 144, [8, 5]),
        ("C=9 D=200", 3, 9, 200, 64, [9, 1, 0]),
        ("C=160", 1, 160, 128, 256, [160]),
        ("C=161 D=200 F=144", 2, 161, 200, 144, [161, 9]),
        ("C=320", 2, 320, 64, 48, [320, 161]),
        ("C=160, rows 100/70/33", 3, 160, 64, 48, [100, 70, 33]),
        ("E=64, 16 active", 64, 3, 128, 144, active16),
        ("all-zero gs, F=48", 2, 16, 96, 48, [0, 0]),
    ]
    for name, fused in (("fused_gate_up_quant", True), ("gmm_quant", False)):
        run_k = MG.fused_gate_up_quant if fused else MG.gmm_quant
        run_p = MG.fused_gate_up_quant_ref if fused else MG.gmm_quant_ref
        for label, e, c, d, f, gs in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, ws, g = _quant_inputs(gen, e, c, d, f, dtype, gs, fused)
                path, info = MG.quant_plan(x, ws[0], scale=ws[1])
                tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 16 == 0
                if path != ("wgmma" if tma else "simt"):
                    raise AssertionError(f"{name} [{label}]: path {path}")
                err = _quant_check(name, fused, label, x, ws, g, dtype)
                log(f"  {name:<20} {label:<18} {str(dtype):<15} "
                    f"{path:<5} N={info['rows']:<3} D split "
                    f"{info['ksplit']:<2} max_abs_err={err:.3e}")
        # x 2 bytes past an aligned buffer: no tensor map takes it
        e, c, d, f, gs = 2, 64, 96, 144, [64, 30]
        x, ws, g = _quant_inputs(gen, e, c, d, f, torch.bfloat16, gs, fused)
        xm = _offset_copy(x)
        path = MG.quant_plan(xm, ws[0], scale=ws[1])[0]
        if path != "simt":
            raise AssertionError(f"{name}: misaligned x took {path}")
        err = _quant_check(name, fused, "x misaligned by 2 B", xm, ws, g,
                           torch.bfloat16)
        log(f"  {name:<20} {'x misaligned by 2 B':<18} torch.bfloat16  "
            f"{path:<5} max_abs_err={err:.3e}")
        for phase in ("decode", "prefill"):
            e, c, d, f, gs = shapes[name][phase]
            ma = shapes["max_active"][phase]
            dtype = torch.bfloat16
            x, ws, g = _quant_inputs(gen, e, c, d, f, dtype, gs, fused)
            path, info = MG.quant_plan(x, ws[0], ma, scale=ws[1])
            work = MG._qplan(fused, x, ws, f, ma)[1][4]
            if path != "wgmma" or work != 0:
                raise AssertionError(f"{name}: the {phase} shape took "
                                     f"{path} with {work} floats of "
                                     "workspace, not wgmma with none")
            simt_split = MG._qplan(fused, x, ws, f, ma, "simt")[1][0]
            run = lambda: run_k(x, *ws, g, max_active=ma)  # noqa: E731
            run_simt = lambda: _quant_run(  # noqa: E731
                name, fused, x, ws, g, ma, "simt")
            plain = lambda: run_p(x, *ws, g)  # noqa: E731
            one_launch(name, run, "wgmma_q_kernel")
            library, idx = _quant_library(fused, x, ws, g)
            err = _quant_check(name, fused, f"{phase} {e}x{c}x{d}x{f}", x,
                               ws, g, dtype, ma)
            simt_err = _quant_check(name, fused, f"{phase}, simt", x, ws, g,
                                    dtype, ma, "simt")
            want = plain()
            lib_err = float((library().float() - want.float()).abs().max())
            # the simt path at prefill takes ~10x the wgmma's time a call
            timer = None if phase == "decode" else \
                (lambda fn: time_ms(fn, iters=5, reps=3))
            ms, simt_ms = _alternate(run, run_simt, timer)
            if phase == "decode":   # the host cost of each path a call
                us, simt_us = _alternate(run, run_simt, host_us)
                log(f"  {name:<20} {phase:<8} host us a call, in turns: "
                    f"wgmma {us:.1f}, simt {simt_us:.1f}")
                # the same active slots packed into a bank of their own:
                # what the bank's empty slots cost a call
                xp, gp = x[idx].contiguous(), g[idx].contiguous()
                wsp = [w[idx].contiguous() for w in ws]
                run_packed = lambda: run_k(  # noqa: E731
                    xp, *wsp, gp, max_active=ma)
                sparse_ms, packed_ms = _alternate(run, run_packed)
                log(f"  {name:<20} {phase:<8} in turns: E={e} with "
                    f"{len(idx)} active ms={sparse_ms:.4f}, the same slots "
                    f"packed as E={len(idx)} ms={packed_ms:.4f}")
                del xp, gp, wsp
            plain_ms = time_ms(plain, iters=5, reps=3)
            lib_ms = time_ms(library, iters=5, reps=3)
            nbytes, flops = _quant_bytes_flops(x, ws, g)
            b_ms, b_by = bound(nbytes, flops, dtype)
            log(f"  {name:<20} {phase:<8} E={e} C={c} D={d} F={f} bf16 x, "
                f"int8 W, {len(idx)} active slots ({path}, N="
                f"{info['rows']}, {info['stages']} stages, {info['smem']} B "
                f"shared a CTA) max_abs_err={err:.3e} ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB) "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"(library max err {lib_err:.3e})")
            log(f"  {name:<20} {phase:<8} in turns with the plan's: simt "
                f"ms={simt_ms:.4f} (D split {simt_split}, max_abs_err="
                f"{simt_err:.3e})")
            if phase == "decode":
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, path=path,
                                 decode_simt_ms=simt_ms)
            else:
                rec[name].update(
                    prefill_ms=ms, prefill_bound_ms=b_ms,
                    prefill_plain_ms=plain_ms, prefill_library_ms=lib_ms,
                    prefill_max_abs_err=err, prefill_path=path,
                    prefill_simt_ms=simt_ms)
            del x, ws, want
            torch.cuda.empty_cache()
    return rec


def _offset_copy(t):
    """A contiguous copy of `t` starting one element (2 bytes in bf16, 4
    in f32) past a 16-byte-aligned buffer: no 16-byte copy can take it."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


def _attn_inputs(gen, b, h, kvh, hd, s, dtype, kv_len, q_pos, wrap,
                 past=None, offset=False):
    """Seeded inputs; with `past`, k and v hold that value in every lane
    at or past the row's kv_len; with `offset`, k and v start one
    element past an aligned buffer."""
    dev = "cuda"
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q_pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    slot = torch.arange(s, dtype=torch.int32, device=dev)[None]
    if past is not None:
        beyond = (slot >= kv_len[:, None])[:, :, None, None]
        k = torch.where(beyond, past, k).to(dtype)
        v = torch.where(beyond, past, v).to(dtype)
    if offset:
        k, v = _offset_copy(k), _offset_copy(v)
    if wrap:
        # ring holding the last s positions up to q_pos: slot i holds the
        # largest position p <= q_pos with p % s == i
        qp = q_pos[:, None]
        pos = qp - torch.remainder(qp - slot, s)
    else:
        pos = slot.expand(b, s)
    return q, k, v, pos.contiguous().to(torch.int32), kv_len, q_pos


def _path_label(q, k, v, tables=None) -> str:
    path, info = DA.kernel_path(q, k, v, block_tables=tables)
    return f"{path}, cluster {info['nsplit']}"


# rows with no visible lane: kv_len = 0; every lane below kv_len hidden
# by position (q_pos = -1); under a window of 16, every lane older than
# it (q_pos = 100, positions 0..19); beside a partial and a full row
HIDDEN_LEN = [0, 10, 23, 40, 20]
HIDDEN_QPOS = [5, -1, 22, 39, 100]


def check_decode_attention(gen, shape) -> dict:
    """The contiguous kernel against its plain version: GQA groups 1-8,
    hd 18/32/64/128, kv_len < S, wrapped rings, windows, rows with no
    visible lane, lanes past kv_len holding 1e4, an unsplit grid, the
    largest cluster and k/v one element off alignment, in float32 and
    bfloat16, each with its path; then the main path's shape: its path
    ("mma"), one launch a call, and its time eager and in a CUDA graph
    beside its bound, the plain version and SDPA."""
    cases = [  # (label, B, H, KV, hd, S, kv_len, q_pos, wrap, window,
        #          past, offset)
        ("GQA 1", 2, 4, 4, 64, 96, [96, 50], [95, 49], False, 0, None,
         False),
        ("GQA 2", 3, 8, 4, 128, 70, [70, 1, 33], [69, 0, 32], False, 0,
         None, False),
        ("GQA 4, kv_len<S", 2, 8, 2, 128, 130, [77, 130], [76, 129],
         False, 0, None, False),
        ("wrapped ring", 2, 8, 2, 64, 64, [64, 64], [150, 64], True, 0,
         None, False),
        ("window 16", 2, 8, 2, 64, 100, [100, 60], [99, 59], False, 16,
         None, False),
        ("ring + window", 2, 4, 2, 32, 48, [48, 48], [200, 90], True, 20,
         None, False),
        ("hd=18 (scalar loads)", 2, 4, 2, 18, 50, [50, 31], [49, 30],
         False, 0, None, False),
        ("B=40, S unsplit", 40, 8, 8, 64, 40,
         [40 - i % 7 for i in range(40)], [39 - i % 7 for i in range(40)],
         False, 0, None, False),
        ("no visible lane", 5, 8, 2, 128, 40, HIDDEN_LEN, HIDDEN_QPOS, False,
         16, 1e4, False),
        ("no visible lane, G 1", 5, 2, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("no visible lane, G 8", 5, 16, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("no visible lane, hd 18", 5, 8, 2, 18, 40, HIDDEN_LEN, HIDDEN_QPOS,
         False, 16, 1e4, False),
        ("past kv_len 1e4", 3, 32, 8, 128, 561, [560, 301, 17],
         [559, 300, 16], False, 0, 1e4, False),
        ("B*KV 288, unsplit", 36, 32, 8, 128, 40,
         [40 - i % 9 for i in range(36)], [39 - i % 9 for i in range(36)],
         False, 0, 1e4, False),
        ("one group, cluster 8", 1, 4, 1, 128, 2000, [1777], [1776], False,
         300, 1e4, False),
        ("k/v off alignment", 5, 8, 2, 64, 40, HIDDEN_LEN, HIDDEN_QPOS, False,
         16, 1e4, True),
    ]
    for label, b, h, kvh, hd, s, kl, qp, wrap, win, past, off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pos, kv_len, q_pos = _attn_inputs(
                gen, b, h, kvh, hd, s, dtype, kl, qp, wrap, past, off)
            got = DA.decode_attention(q, k, v, pos, kv_len, q_pos,
                                      window=win)
            want = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                           window=win)
            torch.cuda.synchronize()
            err = check(f"decode_attention [{label}, {dtype}]", got, want,
                        dtype)
            log(f"  {'decode_attention':<16} {label:<22} {str(dtype):<15} "
                f"{_path_label(q, k, v):<16} max_abs_err={err:.3e}")
    return {"decode_attention": decode_attention_timed(
        gen, shape, "decode", "mma", main=True)}


def decode_attention_timed(gen, shape, label: str, want_path: str,
                           main: bool = False,
                           dtype=torch.bfloat16) -> dict:
    """``decode_attention`` at one serving shape (B, H, KV, hd, S,
    kv_len) in `dtype`: its path must be `want_path`; against its plain
    version,
    at the `main` path's shape one launch a call (torch.profiler; at
    phase 8's geometries its traces missed one record of four), and its
    time eager and in a CUDA graph beside its bound, the plain version
    and SDPA (float additive mask from the finite NEG_INF). Returns the
    record."""
    b, h, kvh, hd, s, kl = shape
    q, k, v, pos, kv_len, q_pos = _attn_inputs(
        gen, b, h, kvh, hd, s, dtype, kl, [x - 1 for x in kl], False)
    path, info = DA.kernel_path(q, k, v)
    if path != want_path:
        raise AssertionError(f"decode_attention: the {label} shape took "
                             f"{path!r}, not {want_path!r}")
    run = lambda: DA.decode_attention(q, k, v, pos, kv_len, q_pos)  # noqa
    plain = lambda: DA.decode_attention_ref(q, k, v, pos, kv_len,  # noqa
                                            q_pos)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = check(f"decode_attention [{label}]", got, want, dtype)
    if main:
        one_launch("decode_attention", run)
    g = h // kvh
    kr = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vr = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    slot = torch.arange(s, device="cuda")[None]
    vis = (slot < kv_len[:, None]) & (pos <= q_pos[:, None])
    amask = torch.where(vis, 0.0, DA.NEG_INF).to(dtype)[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kr, vr, attn_mask=amask)
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(library)
    dev_ms, lib_dev_ms = _alternate(run, library, graph_ms)
    n_vis = int(kv_len.clamp(max=s).sum())
    isz = q.element_size()
    nbytes = (2 * b * h * hd + 2 * n_vis * kvh * hd) * isz \
        + 4 * (n_vis + 2 * b)
    flops = 4.0 * n_vis * h * hd
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  {'decode_attention':<16} {label:<8} B={b} H={h} KV={kvh} "
        f"hd={hd} S={s} {dtype} path={path} cluster={info['nsplit']} "
        f"stages={info['stages']} smem={info['smem']} B "
        f"max_abs_err={err:.3e} ms={ms:.4f} device_ms={dev_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} library_device_ms={lib_dev_ms:.4f} "
        f"(SDPA; device times in a CUDA graph, in turns)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, path=path,
                cluster=info["nsplit"])


def _paged_inputs(gen, b, h, kvh, hd, blk, nbs, kv_len, dtype, share=0,
                  q_pos=None, past=None, offset=False):
    """A shuffled pool: each row's chain is a random choice of pool
    blocks (not contiguous), rows 0 and 1 share their first `share`
    blocks, unassigned table entries point at trash block 0, and every
    pool lane not on a chain holds a random position. q_pos defaults to
    kv_len - 1 (at least 0); with `past`, k and v hold that value in
    block 0 and in every chain lane at or past the row's kv_len; with
    `offset`, k and v start one element past an aligned buffer."""
    dev = gen.device
    nb = 1 + b * nbs
    order = torch.randperm(nb - 1, generator=gen, device=dev).cpu() + 1
    tables = torch.zeros((b, nbs), dtype=torch.int32)
    used = [-(-n // blk) for n in kv_len]
    at = 0
    for r in range(b):
        tables[r, :used[r]] = order[at:at + used[r]]
        at += used[r]
    tables[1, :share] = tables[0, :share]
    kv_pos = torch.randint(-50, 1000, (nb, blk), generator=gen, device=dev,
                           dtype=torch.int32)
    for r in range(b):
        ids = tables[r, :used[r]].long().to(dev)
        kv_pos[ids] = (torch.arange(used[r] * blk, dtype=torch.int32,
                                    device=dev).reshape(used[r], blk))
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((nb, blk, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((nb, blk, kvh, hd), generator=gen, device=dev).to(dtype)
    if past is not None:
        for t in (k, v):
            t[0] = past
            for r, n in enumerate(kv_len):
                if n % blk:
                    t[int(tables[r, n // blk]), n % blk:] = past
    if offset:
        k, v = _offset_copy(k), _offset_copy(v)
    q_pos = (torch.tensor(kv_len, dtype=torch.int32, device=dev) - 1).clamp(
        min=0) if q_pos is None else torch.tensor(q_pos, dtype=torch.int32,
                                                  device=dev)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, kv_pos, tables.to(dev), kv_len, q_pos


def _paged_bytes_flops(q, k, tables, kv_len, window, kv_pos, q_pos):
    """Bytes and operations these inputs need: K, V and positions of each
    distinct visible pool lane (a shared block counts once), V of every
    lane of a fully hidden row (it averages them), the tables, q, the
    output and the lengths; two products per visible (row, lane, head)
    and the hidden rows' averaging."""
    b, h, hd = q.shape
    blk, kvh = k.shape[1], k.shape[2]
    nbs = tables.shape[1]
    s = nbs * blk
    slot = torch.arange(s, device=q.device)
    lane = tables.long().repeat_interleave(blk, dim=1) * blk + slot % blk
    pos = kv_pos.reshape(-1)[lane]
    vis = (slot[None] < kv_len[:, None]) & (pos <= q_pos[:, None])
    if window:
        vis = vis & (pos > q_pos[:, None] - window)
    hidden = ~vis.any(dim=1)
    n_vis = int(vis.sum())
    lanes_vis = int(torch.unique(lane[vis]).numel())
    lanes_hidden = int(torch.unique(lane[hidden]).numel())
    isz = q.element_size()
    row = kvh * hd * isz
    nbytes = (lanes_vis * (2 * row + 4) + lanes_hidden * row
              + 2 * b * h * hd * isz + 4 * (b * nbs + 2 * b))
    flops = 4.0 * n_vis * h * hd + 2.0 * int(hidden.sum()) * s * h * hd
    return nbytes, flops


def check_decode_attention_paged(gen, shape) -> dict:
    """The paged kernel against its plain version: adversarial block
    sizes (1, 3, 16, 32), rows with no visible lane beside lanes past
    kv_len and a trash block holding 1e4, k/v one element off alignment,
    then the main path's shape with shuffled tables, two rows sharing
    prefix blocks, a kv_len = 0 row and a full row, with and without a
    window, in float32 and bfloat16, each with its path; timed at the
    main path's shape, eager and in a CUDA graph, beside its bound, the
    plain version and the nearest library composition (gather then
    SDPA: two calls)."""
    cases = [  # (label, B, H, KV, hd, blk, nbs, kv_len, share, window,
        #          q_pos, past, offset)
        ("blk 1", 3, 8, 2, 64, 1, 40, [40, 17, 0], 10, 0, None, None,
         False),
        ("blk 3", 3, 8, 4, 32, 3, 13, [39, 20, 5], 4, 0, None, None, False),
        ("blk 16, GQA 4", 4, 8, 2, 128, 16, 6, [96, 50, 0, 33], 3, 0, None,
         None, False),
        ("blk 32 > tile", 2, 4, 2, 64, 32, 3, [96, 70], 2, 0, None, None,
         False),
        ("blk 16, window 12", 3, 8, 2, 64, 16, 5, [80, 61, 30], 3, 12, None,
         None, False),
        ("hd=18 (scalar loads)", 2, 4, 2, 18, 3, 7, [21, 10], 3, 0, None,
         None, False),
    ]
    for cblk in (1, 3, 16, 32):
        cnbs = -(-40 // cblk)
        kl = [0, 10, 23, cnbs * cblk, 20]
        qp = [5, -1, 22, cnbs * cblk - 1, 100]
        cases.append((f"no visible lane, blk {cblk}", 5, 8, 2, 128, cblk,
                      cnbs, kl, 0, 16, qp, 1e4, False))
    cases.append(("k/v off alignment", 3, 8, 2, 64, 16, 3, [40, 0, 17], 0, 0,
                  None, 1e4, True))
    b, h, kvh, hd, blk, nbs = shape
    main_len, share = _paged_main_lens(b, nbs, blk)
    cases += [("main shape", b, h, kvh, hd, blk, nbs, main_len, share, 0,
               None, 1e4, False),
              ("main shape, window 64", b, h, kvh, hd, blk, nbs, main_len,
               share, 64, None, 1e4, False)]
    for (label, cb, ch, ckv, chd, cblk, cnbs, kl, sh, win, qp, past,
         off) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _paged_inputs(gen, cb, ch, ckv, chd, cblk, cnbs, kl,
                                 dtype, sh, qp, past, off)
            got = DA.decode_attention_paged(*args, window=win)
            want = DA.decode_attention_paged_ref(*args, window=win)
            torch.cuda.synchronize()
            err = check(f"decode_attention_paged [{label}, {dtype}]", got,
                        want, dtype)
            log(f"  {'decode_attention_paged':<22} {label:<22} "
                f"{str(dtype):<15} "
                f"{_path_label(*args[:3], args[4]):<16} "
                f"max_abs_err={err:.3e}")
    return {"decode_attention_paged": decode_attention_paged_timed(
        gen, shape, "decode", "mma", main=True)}


def _paged_main_lens(b, nbs, blk):
    """The serving shape's row lengths: a full row, a kv_len = 0 row and
    partial rows; and how many blocks rows 0 and 1 share."""
    full = nbs * blk
    lens = [full, full - blk, 0, full - 3 * blk - 5, 2 * full // 3,
            full // 2 + 3, full // 4 + 1, 17][:b]
    return lens, max(full // blk - 3, 0)


def decode_attention_paged_timed(gen, shape, label: str,
                                 want_path: str, main: bool = False) -> dict:
    """``decode_attention_paged`` at one bf16 serving shape (B, H, KV,
    hd, block, blocks a row) with shuffled tables and two rows sharing
    prefix blocks: its path must be `want_path`; against its plain
    version, at the `main` path's shape one launch a call, and timed
    eager and in a CUDA graph beside its bound, the plain version and
    the nearest library composition (gather, then SDPA with a float
    additive mask). Returns the record."""
    b, h, kvh, hd, blk, nbs = shape
    full = nbs * blk
    main_len, share = _paged_main_lens(b, nbs, blk)
    dtype = torch.bfloat16
    args = _paged_inputs(gen, b, h, kvh, hd, blk, nbs, main_len, dtype,
                         share)
    q, k, v, kv_pos, tables, kv_len, q_pos = args
    path, info = DA.kernel_path(q, k, v, block_tables=tables)
    if path != want_path:
        raise AssertionError(f"decode_attention_paged: the {label} shape "
                             f"took {path!r}, not {want_path!r}")
    run = lambda: DA.decode_attention_paged(*args)  # noqa: E731
    plain = lambda: DA.decode_attention_paged_ref(*args)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = check(f"decode_attention_paged [{label}]", got, want, dtype)
    if main:
        one_launch("decode_attention_paged", run)
    g = h // kvh
    tab = tables.long()
    slot = torch.arange(full, device=q.device)
    gpos = kv_pos[tab].reshape(b, full)
    vis = (slot[None] < kv_len[:, None]) & (gpos <= q_pos[:, None])
    amask = torch.where(vis, 0.0, DA.NEG_INF).to(dtype)[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():   # two calls: the gather, then SDPA over repeated KV
        gk = k[tab].reshape(b, full, kvh, hd)
        gv = v[tab].reshape(b, full, kvh, hd)
        return F.scaled_dot_product_attention(
            q4, gk.repeat_interleave(g, dim=2).transpose(1, 2),
            gv.repeat_interleave(g, dim=2).transpose(1, 2), attn_mask=amask)
    lib_err = float((library()[:, :, 0].float() - want.float())[
        vis.any(dim=1)].abs().max())
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(library)
    dev_ms, lib_dev_ms = _alternate(run, library, graph_ms)
    nbytes, flops = _paged_bytes_flops(q, k, tables, kv_len, 0, kv_pos,
                                       q_pos)
    b_ms, b_by = bound(nbytes, flops, dtype)
    log(f"  {'decode_attention_paged':<22} {label} B={b} H={h} KV={kvh} "
        f"hd={hd} blk={blk} nbs={nbs} NB={k.shape[0]} bf16 path={path} "
        f"cluster={info['nsplit']} stages={info['stages']} "
        f"smem={info['smem']} B max_abs_err={err:.3e} ms={ms:.4f} "
        f"device_ms={dev_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{nbytes / 1e6:.2f} MB) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} library_device_ms={lib_dev_ms:.4f} "
        f"(gather + SDPA, 2 calls; its max err on rows with a visible lane "
        f"{lib_err:.3e}; device times in a CUDA graph, in turns)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, path=path,
                cluster=info["nsplit"])


def main_path_shapes(cfg, slots: int, bucket: int, max_len: int):
    """Kernel shapes the full-width serving runs give each wrapper."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    d, f = cfg.d_model, cfg.moe.d_ff
    cap_dec = max(1, math.ceil(cf * k * slots / e))
    cap_pre = max(1, math.ceil(cf * k * bucket / e))
    rng = np.random.default_rng(0)
    gs_dec = rng.integers(1, cap_dec + 1, e).tolist()
    gs_pre = rng.integers(cap_pre // 2, cap_pre + 1, e).tolist()
    # the EP slot plane of phase 4c: 64 slots (8 devices x 8), each with
    # the per-expert capacity; at decode at most slots * k of them get
    # rows, the bound the EP layer hands the kernels (prefill: all)
    n_slots = EP_DEVICES * EP_SLOTS_PER_DEVICE
    active = rng.choice(n_slots, 2 * e, replace=False)
    q_dec, q_pre = [0] * n_slots, [0] * n_slots
    for i in active:
        q_dec[i] = int(rng.integers(1, cap_dec + 1))
        q_pre[i] = int(rng.integers(cap_pre // 4, cap_pre + 1))
    return {
        "fused_gate_up": {"decode": (e, cap_dec, d, f, gs_dec),
                          "prefill": (e, cap_pre, d, f, gs_pre)},
        "gmm": {"decode": (e, cap_dec, f, d, gs_dec),
                "prefill": (e, cap_pre, f, d, gs_pre)},
        "fused_gate_up_quant": {"decode": (n_slots, cap_dec, d, f, q_dec),
                                "prefill": (n_slots, cap_pre, d, f, q_pre)},
        "gmm_quant": {"decode": (n_slots, cap_dec, f, d, q_dec),
                      "prefill": (n_slots, cap_pre, f, d, q_pre)},
        "max_active": {"decode": min(n_slots, slots * k),
                       "prefill": min(n_slots, bucket * k)},
        "decode_attention": (slots, cfg.num_heads, cfg.num_kv_heads,
                             cfg.resolved_head_dim, max_len,
                             [max_len - 1 - 37 * i for i in range(slots)]),
        "decode_attention_paged": (slots, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, PAGED_BLOCK,
                                   -(-max_len // PAGED_BLOCK)),
    }


# the model families of phase 8 at their published widths, and the
# depth each serves at: cut only where the weights (bf16) do not fit one
# card beside the kernels' phase-3 inputs, or the run's time
FAMILY_LAYERS = {
    "llama4-maverick-400b-a17b": 2,   # one dense + one MoE period of 48
    "grok-1-314b": 2,                 # of 64
    "qwen3-32b": 8,                   # of 64
    "qwen2-72b": 4,                   # of 80
    "command-r-plus-104b": 2,         # of 64
    "stablelm-12b": 40,               # all
    "qwen2-vl-2b": 28,                # all
    "jamba-v0.1-52b": 8,              # one period of 32: 1 attention,
    #                                   7 mamba, 4 MoE (E16) + 4 dense
    "xlstm-125m": 12,                 # all
}
# the recurrent stacks: contiguous KV only (a paged pool has no place
# for per-slot recurrent state), prompts prefilled at exact length
RECURRENT = ("jamba-v0.1-52b", "xlstm-125m")
FAMILY_LENS, FAMILY_GENS = (128, 256, 384, 512), (16, 32)
FAMILY_MAX_LEN = max(FAMILY_LENS) + max(FAMILY_GENS) + 1


def family_config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).with_(num_layers=FAMILY_LAYERS[arch])


def attention_path(cfg) -> str:
    """The decode-attention path a bf16 config's geometry takes
    (``csrc/decode_attn.cu``'s plan: "mma" for hd a multiple of 16 up to
    128 and G = H / KV <= 8, else "simt")."""
    hd, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    return "mma" if hd % 16 == 0 and hd <= 128 and g <= 8 else "simt"


def family_shapes(slots: int, bucket: int):
    """Phase 8's new kernel geometries: ``fused_gate_up``/``gmm`` at
    llama4's (E 128, top-1), grok-1's (F 32768) and jamba's (E 16,
    top-2) decode and prefill (group sizes from a seeded routing of
    `slots` and `bucket` tokens, clipped at the capacity), and the
    decode-attention geometries that no earlier phase runs: (H, KV, hd)
    = (32, 8, 160) stablelm, (96, 8, 128) command-r+, (12, 2, 128)
    qwen2-vl."""
    gmm = []
    for arch, short in (("llama4-maverick-400b-a17b", "llama4"),
                        ("grok-1-314b", "grok-1"),
                        ("jamba-v0.1-52b", "jamba")):
        cfg = family_config(arch)
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        d, f = cfg.d_model, cfg.moe.d_ff
        rng = np.random.default_rng(5)
        for phase, n in (("decode", slots), ("prefill", bucket)):
            cap = max(1, math.ceil(cfg.moe.capacity_factor * k * n / e))
            gs = np.minimum(np.bincount(rng.integers(0, e, n * k),
                                        minlength=e), cap).tolist()
            gmm.append((f"{short} {phase}", (e, cap, d, f, gs),
                        (e, cap, f, d, gs)))
    attn = []
    for arch in ("stablelm-12b", "command-r-plus-104b", "qwen2-vl-2b"):
        cfg = family_config(arch)
        attn.append((arch, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim, attention_path(cfg)))
    return gmm, attn


def check_family_shapes(gen, slots: int, max_len: int) -> dict:
    """Phase 3's checks at phase 8's new geometries: each kernel against
    its plain version, its path, and its time beside its bound, the
    plain version and a library call. Returns {kernel: [record, ...]},
    each record with its "shape"."""
    gmm, attn = family_shapes(slots, 512)
    out = {n: [] for n in ("fused_gate_up", "gmm", "decode_attention",
                           "decode_attention_paged")}
    for label, up, down in gmm:
        for name, fused, shape in (("fused_gate_up", True, up),
                                   ("gmm", False, down)):
            e, c, d, f, _ = shape
            r = gmm_shape_timed(gen, name, fused, label, shape)
            out[name].append(dict(shape=f"{label} E{e} C{c} D{d} F{f}",
                                  **r))
    nbs = -(-max_len // PAGED_BLOCK)
    kl = [max_len - 1 - 37 * i for i in range(slots)]
    for arch, h, kvh, hd, path in attn:
        label = f"H{h} KV{kvh} hd{hd}"
        r = decode_attention_timed(gen, (slots, h, kvh, hd, max_len, kl),
                                   label, path)
        out["decode_attention"].append(dict(shape=f"{arch} {label}", **r))
        r = decode_attention_paged_timed(
            gen, (slots, h, kvh, hd, PAGED_BLOCK, nbs), label, path)
        out["decode_attention_paged"].append(dict(shape=f"{arch} {label}",
                                                  **r))
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 4


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def make_requests(cfg, lens, gens, n, seed=0, sampled=False):
    """`n` requests at t=0 with random prompts; with `sampled`, every
    odd request samples (temperature 0.9, top-p 0.9, top-k 40 on every
    other one, its own seed)."""
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=i, arrival=0.0,
                       prompt=rng.integers(0, cfg.vocab_size,
                                           size=lens[i % len(lens)],
                                           dtype=np.int32),
                       max_new_tokens=gens[i % len(gens)],
                       sampling=SamplingParams(
                           temperature=0.9, top_p=0.9,
                           top_k=40 * (i % 4 == 1), seed=100 + i)
                       if sampled and i % 2 else SamplingParams())
            for i in range(n)]


def serve_timed(engine, reqs, slots: int, control=None):
    """Serve `reqs` to completion (with `control` as the session control
    plane), timing every model call (prefill by bucket, batched decode)
    between host syncs. Returns (result, launch counts of this run,
    prefill seconds by bucket, decode seconds, decode tokens, wall
    seconds)."""
    prefill_s: dict[int, list[float]] = {}
    decode_s: list[float] = []
    decode_tok = [0]
    inner = engine._step

    def timed(batch, cache, cache_len, collect, ep=None):
        t = time.perf_counter()
        out = inner(batch, cache, cache_len, collect, ep=ep)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if isinstance(cache_len, int):
            prefill_s.setdefault(batch["tokens"].shape[1], []).append(dt)
        else:
            decode_s.append(dt)
            decode_tok[0] += int(batch["active"].sum())
        return out

    engine._step = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        engine.start(num_slots=slots, control=control)
        for r in reqs:
            engine.submit(r)
        res = engine.run()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        engine.close()
    finally:
        del engine._step
    return res, launches, prefill_s, decode_s, decode_tok[0], wall


def compare_logits(name, got, want, loads_got, loads_want) -> dict:
    """Kernel-path logits against plain-path logits from the same state:
    max |diff|, the relative L2 error, the share of elements outside
    the bf16 elementwise tolerance, argmax agreement per row, and
    whether every MoE layer routed the same expert loads (a near-tied
    router choice flips on a last-bit difference, and a token sent to
    another expert changes its logits by far more than rounding)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel-path logits")
    tol = TOL[torch.bfloat16]
    out = {
        "max_abs_err": float((g - w).abs().max()),
        "rel_l2": float((g - w).norm() / w.norm()),
        "outside_elementwise_tol": float(
            (~torch.isclose(g, w, atol=tol, rtol=tol)).float().mean()),
        "argmax_equal": float((g.argmax(-1) == w.argmax(-1)).float().mean()),
    }
    if loads_want is not None:
        out["same_expert_loads"] = bool(torch.equal(loads_got, loads_want))
    log(f"  logits {name}: " + ", ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out.items()))
    return out


def clone_tree(tree):
    """A copy of a cache tree (dicts, lists and tuples of tensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def _attention_pair(name, layer, cfg, p, c, h, pos, cache_len, block_tables,
                    errs):
    """One attention sublayer through the kernel and the plain path,
    each on its own copy of the layer's cache: checked within the bf16
    tolerance, the plain output returned."""
    from repro_torch.models import layers as L
    outs = [L.attention_block(p["attn"], cfg, h, pos, cache=clone_tree(c),
                              cache_len=cache_len, impl=impl,
                              block_tables=block_tables)[0]
            for impl in ("auto", "ref")]
    errs["attention"] = max(errs["attention"], check(
        f"{name}, layer {layer} attention", outs[0], outs[1],
        torch.bfloat16))
    return outs[1]


def sublayer_check(name, cfg, params, tokens, cache, cache_len,
                   token_mask, block_tables=None, ep=None,
                   extra=None, enc_out=None) -> dict:
    """Every layer's attention and MoE sublayer through the kernels and
    through the plain path, both from the same input (the plain path's
    hidden state), so both route identically: each output pair must
    agree elementwise within the bf16 tolerance. A recurrent mixer and a
    dense sublayer's FFN (plain torch on both paths) carry the state on.
    With `block_tables` the cache is the paged pool and every row writes
    one token. With `ep` = (EPContext, ep_state) the MoE sublayers run
    through the EP slot plane on the runtime's tables and banks. `extra`
    adds a VLM's vis_embeds/vis_mask and (B, S, 3) positions. An
    encoder-decoder's decoder adds its sinusoids and carries the state
    on through each layer's cross-attention over `enc_out` (plain torch
    on both paths). Returns the largest error of each sublayer kind."""
    from repro_torch.distributed.ep import moe_ep_ffn
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    pattern = T.layer_pattern(cfg)
    extra = extra or {}
    b, s = tokens.shape
    steps = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if "positions" in extra:
        pos = extra["positions"]
    elif isinstance(cache_len, int):
        pos = (cache_len + steps)[None].expand(b, s)
    else:
        pos = cache_len[:, None] + steps[None]
    errs = {"attention": 0.0, "moe": 0.0}
    x = T._embed(params, dict(extra, tokens=tokens))
    if cfg.encdec is not None:
        x = x + T._sinusoidal_at(pos[0], cfg.d_model).to(x.dtype)[None]
    layers = [(i, j, sub) for i in range(cfg.num_layers // len(pattern))
              for j, sub in enumerate(pattern)]
    for i, j, sub in layers:
        p = T._period(params["layers"][j], i)
        c = T._period(cache[j], i)
        h = L.norm(x, p["norm1"], cfg.norm)
        layer = i * len(pattern) + j
        if sub.mixer != "attn":
            x = x + T._apply_mixer(cfg, sub, p, h, clone_tree(c))
        else:
            x = x + _attention_pair(name, layer, cfg, p, c["attn"], h, pos,
                                    cache_len, block_tables, errs)
        if sub.cross_attn:
            x = x + T._cross_attention(
                cfg, p["xattn"], L.norm(x, p["norm_x"], cfg.norm), enc_out)
        if sub.ffn == "none":
            continue
        h = L.norm(x, p["norm2"], cfg.norm)
        if sub.ffn == "dense":
            x = x + L.ffn(p["ffn"], h, cfg.act)
            continue
        if ep is not None:
            ctx, state = ep
            outs = [moe_ep_ffn(p["moe"], h, T._period(state[j], i), ctx,
                               cfg.with_(impl=impl),
                               token_mask=token_mask)[0]
                    for impl in ("auto", "ref")]
        else:
            outs = [MOE.dispatch_moe(
                p["moe"], h, top_k=cfg.moe.top_k,
                num_experts=cfg.moe.num_experts,
                capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
                groups=T._moe_groups(h), token_mask=token_mask,
                impl=impl)[0]
                for impl in ("auto", "ref")]
        errs["moe"] = max(errs["moe"], check(
            f"{name}, layer {layer} MoE", outs[0], outs[1], torch.bfloat16))
        x = x + outs[1]
    moe = f"{errs['moe']:.3e}" if cfg.is_moe else "(no MoE layer)"
    log(f"  {name}: every layer's sublayers, kernels vs plain from the "
        f"same input: attention max_abs_err={errs['attention']:.3e}, MoE "
        f"max_abs_err={moe} (atol=rtol={TOL[torch.bfloat16]})")
    return errs


def logits_check(cfg, params, prompts, max_len: int, slots: int):
    """The longest prompt's prefill and one batched decode step from a
    pool of `slots` prefilled prompts, through the kernels and through
    the plain path from the same state: per-sublayer checks with the
    same inputs, then the full-model logits compared and reported."""
    from repro_torch.models import transformer as T
    ref_cfg = cfg.with_(impl="ref")
    dev = params["embed"].device
    res = {}
    with torch.no_grad():
        longest = max(prompts, key=len)
        toks = torch.from_numpy(longest[None].astype(np.int64)).to(dev)
        res["prefill sublayers"] = sublayer_check(
            f"prefill of {len(longest)} tokens", cfg, params, toks,
            T.init_cache(cfg, params, 1, max_len), 0, None)
        outs = []
        for c in (cfg, ref_cfg):
            cache = T.init_cache(c, params, 1, max_len)
            lg, _, m = T.decode_step(c, params, {"tokens": toks}, cache, 0)
            outs.append((lg[0, -1], m.get("expert_load")))
        res["prefill logits"] = compare_logits(
            "prefill, last position", outs[0][0], outs[1][0], outs[0][1],
            outs[1][1])
        # a batched state: `slots` prompts prefilled (plain path) into
        # one pool at per-row lengths, then one decode step
        lens = [min(len(p), 128 + 16 * i) for i, p in
                enumerate(prompts[:slots])]
        plen = max(lens)
        batch_toks = torch.from_numpy(np.stack(
            [np.pad(p[:n], (0, plen - n)) for p, n in
             zip(prompts[:slots], lens)]).astype(np.int64)).to(dev)
        pool = T.init_cache(ref_cfg, params, slots, max_len)
        lg, _, _ = T.decode_step(ref_cfg, params, {"tokens": batch_toks},
                                 pool, 0)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        active = torch.ones(slots, dtype=torch.bool, device=dev)
        res["decode sublayers"] = sublayer_check(
            "batched decode step", cfg, params, nxt, pool, lengths,
            active[:, None])
        outs = []
        for c in (cfg, ref_cfg):
            state = clone_tree(pool)
            lg, _, m = T.decode_step(c, params, {"tokens": nxt,
                                                 "active": active},
                                     state, lengths)
            outs.append((lg[:, -1], m.get("expert_load")))
        res["decode logits"] = compare_logits(
            "batched decode step", outs[0][0], outs[1][0], outs[0][1],
            outs[1][1])
    return res


# ------------------------------------------------------------ phase 4b


def serve_waves(engine, waves, slots: int):
    """Serve each wave of requests to completion in ONE session (start,
    submit, run, submit, run), timing every model call between host
    syncs by kind: mixed (prompt chunks in the step) or decode-only.
    Returns (launch counts of this run, mixed seconds, decode seconds,
    wall seconds)."""
    mixed_s: list[float] = []
    decode_s: list[float] = []
    inner = engine._step

    def timed(batch, cache, cache_len, collect, ep=None):
        t = time.perf_counter()
        out = inner(batch, cache, cache_len, collect, ep=ep)
        torch.cuda.synchronize()
        (mixed_s if batch["tokens"].shape[1] > 1 else decode_s).append(
            time.perf_counter() - t)
        return out

    engine._step = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        engine.start(num_slots=slots)
        for wave in waves:
            for r in wave:
                engine.submit(r)
            engine.run()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    finally:
        del engine._step
    return launches, mixed_s, decode_s, wall


def check_budgets(reqs, what: str) -> None:
    """Every request ended by its token budget."""
    for r in reqs:
        if r.finish_reason != "length" or \
                len(r.tokens) != r.max_new_tokens:
            raise AssertionError(f"{what} {r.rid}: {len(r.tokens)} of "
                                 f"{r.max_new_tokens} tokens "
                                 f"({r.finish_reason!r})")


def check_pool_clean(kv) -> None:
    """After a run no request holds a pool block: every block in use is
    held once, by the prefix cache."""
    nodes = list(kv.prefix._walk()) if kv.prefix is not None else []
    if kv.used_blocks != len(nodes) or kv.num_active or any(
            kv.refcount[n.block] != 1 for n in nodes):
        raise AssertionError(f"leaked blocks: {kv.used_blocks} in use, "
                             f"{len(nodes)} cached")


def shared_prefix_waves(cfg, system_len: int, suffixes, gens, seed=1):
    """Two waves of requests that share one system prompt: wave 1 has a
    unique suffix per request; wave 2 repeats wave 1's request
    `repeat[0]` exactly (its length chosen so the prefix match ends
    inside a block: a copy-on-write) and gives the others new suffixes."""
    from repro_torch.serving.scheduler import GenRequest
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, system_len, dtype=np.int32)
    prompts = []
    for wave in suffixes:
        prompts.append([np.concatenate([system, rng.integers(
            0, cfg.vocab_size, n, dtype=np.int32)]) for n in wave])
    repeat = next(i for i, p in enumerate(prompts[0])
                  if (len(p) - 1) % PAGED_BLOCK)
    prompts[1][0] = prompts[0][repeat].copy()
    waves, rid = [], 0
    for wave in prompts:
        waves.append([])
        for p in wave:
            waves[-1].append(GenRequest(rid=rid, arrival=float("nan"),
                                        prompt=p,
                                        max_new_tokens=gens[rid % len(gens)]))
            rid += 1
    return waves


def paged_phase(cfg, params, max_len: int, slots: int, card: str) -> dict:
    """Phase 4b: the paged pool, chunked prefill and the prefix cache at
    full width, then every layer's paged attention sublayer through the
    kernel against the plain path. Returns this run's launch counts."""
    from repro_torch.configs import ServingSpec
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import MoElessController, ServingEngine
    spec = ServingSpec(kv="paged", kv_block=PAGED_BLOCK,
                       prefill_chunk=PAGED_CHUNK, prefix_cache=True)
    log(f"  serving: {spec}, {slots} slots, max_len {max_len}, "
        f"MoElessController(num_devices=8)")
    ctrl = MoElessController(cfg, num_devices=8)
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl,
                           serving=spec)
    waves = shared_prefix_waves(
        cfg, 256, [[64 + 27 * i for i in range(slots)],
                   [0] + [100 + 19 * i for i in range(slots - 1)]],
        (16, 32, 48))
    torch.cuda.reset_peak_memory_stats()
    launches, mixed_s, decode_s, wall = serve_waves(engine, waves, slots)
    peak = torch.cuda.max_memory_allocated()
    kv = engine._session.kv
    reqs = [r for w in waves for r in w]
    check_budgets(reqs, "paged request")
    nodes = list(kv.prefix._walk())
    log(f"  served 2 waves x {slots} requests, "
        f"{sum(len(r.tokens) for r in reqs)} tokens in "
        f"{len(mixed_s)} mixed + {len(decode_s)} decode-only steps; prefix "
        f"hits {kv.prefix.hits}, tokens saved {kv.prefix.tokens_saved}, "
        f"copy-on-write blocks {kv.cow_blocks}; pool {kv.num_blocks} blocks "
        f"of {kv.block_bytes} B, {kv.used_blocks} in use after the run, "
        f"{len(nodes)} held by the prefix cache")
    log(f"  launches in this run: {launches}")
    if kv.prefix.hits < slots or kv.prefix.tokens_saved <= 0:
        raise AssertionError("the second wave did not hit the prefix cache")
    if kv.cow_blocks < 1:
        raise AssertionError("the exact repeat made no copy-on-write")
    check_pool_clean(kv)
    for k_name in ("decode_attention_paged", "fused_gate_up", "gmm"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the paged "
                                 "path")
    n_tok = sum(len(r.tokens) for r in reqs)
    log(f"  wall times on {card}:")
    log(f"    mixed step: median {np.median(mixed_s) * 1e3:.2f} ms over "
        f"{len(mixed_s)}; decode-only step: median "
        f"{np.median(decode_s) * 1e3:.2f} ms over {len(decode_s)}; "
        f"decode_attention_paged launches per decode-only step "
        f"{launches['decode_attention_paged'] / len(decode_s):.1f}, per "
        f"mixed step 0 (chunked attention over the gathered view)")
    log(f"    whole run: {wall:.2f} s, {n_tok / wall:.1f} tokens/s; "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    del engine, ctrl, kv
    torch.cuda.empty_cache()
    # every layer's paged attention sublayer from one batched state: the
    # wave-1 prompts prefilled (plain path) through shuffled tables into
    # a fresh pool, rows 0 and 1 sharing their system-prompt blocks,
    # then one decode step with every row writing one token
    ref_cfg = cfg.with_(impl="ref")
    dev = params["embed"].device
    nbs = -(-max_len // PAGED_BLOCK)
    prompts = [r.prompt for r in waves[0]]
    lens = [len(p) for p in prompts]
    gen = torch.Generator().manual_seed(3)
    order = (torch.randperm(slots * nbs, generator=gen) + 1).tolist()
    tables = torch.zeros((slots, nbs), dtype=torch.int32)
    for r, n in enumerate(lens):
        need = -(-(n + 1) // PAGED_BLOCK)
        tables[r, :need] = torch.tensor(order[:need], dtype=torch.int32)
        del order[:need]
    tables[1, :256 // PAGED_BLOCK] = tables[0, :256 // PAGED_BLOCK]
    tables = tables.to(dev)
    pool = T.init_paged_cache(cfg, params, 1 + slots * nbs, PAGED_BLOCK)
    toks = torch.from_numpy(np.stack([np.pad(p, (0, max(lens) - len(p)))
                                      for p in prompts]).astype(np.int64))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    with torch.no_grad():
        lg, _, _ = T.decode_step(
            ref_cfg, params, {"tokens": toks.to(dev), "block_tables": tables,
                              "new_counts": lengths},
            pool, torch.zeros(slots, dtype=torch.int32, device=dev))
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        errs = sublayer_check("paged batched decode step", cfg, params, nxt,
                              pool, lengths,
                              torch.ones((slots, 1), dtype=torch.bool,
                                         device=dev), block_tables=tables)
    del pool, lg
    torch.cuda.empty_cache()
    return {"launches": launches, "sublayers": errs}


# ------------------------------------------------------------ phase 6

SYSTEM_LEN, GATEWAY_GEN = 256, 32   # phase 6: shared system prompt, budget


class HostedGateway:
    """A ``GatewayServer`` on 127.0.0.1 (a free port) on an asyncio loop
    in a background thread, over `router`; ``close`` stops the server,
    the loop, the thread and the router's replica threads."""

    def __init__(self, router):
        import asyncio
        import threading

        from repro_torch.serving.gateway import GatewayServer
        self.router = router
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.srv = GatewayServer(router, host="127.0.0.1", port=0)
        _, self.port = asyncio.run_coroutine_threadsafe(
            self.srv.start(), self.loop).result(60)

    def close(self) -> None:
        import asyncio
        try:
            asyncio.run_coroutine_threadsafe(self.srv.close(),
                                             self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            self.router.stop()
        alive = [d.replica_id for d in self.router.replicas.values()
                 if d._thread is not None and d._thread.is_alive()]
        if self.thread.is_alive() or alive:
            raise AssertionError(f"gateway threads still running (replicas "
                                 f"{alive})")


def _choice_tokens(choice: dict) -> list[int]:
    if "tokens" in choice:
        return choice["tokens"]
    return choice.get("message", choice.get("delta", {})).get("content", [])


def http_completion(port: int, body: dict, chat: bool) -> dict:
    """POST one completion to the gateway; SSE when body['stream']. Returns
    the tokens, the finish reason, the send time and each token's
    arrival time (host clock; unary: all at the response)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions" if chat else
                 "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, times, reason = [], [], None
    try:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()[:300]}")
        if body.get("stream"):
            while line := resp.readline():
                if not line.startswith(b"data: ") or \
                        line.strip() == b"data: [DONE]":
                    continue
                ch = json.loads(line[6:])["choices"][0]
                got = _choice_tokens(ch)
                toks += got
                times += [time.perf_counter()] * len(got)
                reason = ch.get("finish_reason") or reason
        else:
            ch = json.loads(resp.read())["choices"][0]
            toks, reason = _choice_tokens(ch), ch["finish_reason"]
            times = [time.perf_counter()] * len(toks)
    finally:
        conn.close()
    return {"tokens": toks, "finish": reason, "t0": t0, "times": times}


def gateway_traffic(cfg, n: int = 16, seed: int = 6):
    """`n` requests sharing a SYSTEM_LEN-token system prompt, with
    128-384-token tails and a budget of GATEWAY_GEN: odd ones sample
    (temperature 0.8, top-k 50, top-p 0.95, a seed each), requests 2-3
    of every 4 stream (SSE), 4-7 of every 8 use the chat endpoint.
    Returns [(GenRequest, HTTP body, chat)]."""
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size, 128 + 16 * i).tolist()
        samp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=1000 + i) if i % 2 else SamplingParams()
        body = {"max_tokens": GATEWAY_GEN, "stream": i % 4 >= 2,
                "temperature": samp.temperature, "top_k": samp.top_k,
                "top_p": samp.top_p, "seed": samp.seed}
        chat = i % 8 >= 4
        if chat:
            body["messages"] = [{"role": "system", "content": system},
                                {"role": "user", "content": tail}]
        else:
            body["prompt"] = system + tail
        req = GenRequest(rid=i, arrival=0.0,
                         prompt=np.asarray(system + tail, np.int32),
                         max_new_tokens=GATEWAY_GEN,
                         sampling=samp)
        out.append((req, body, chat))
    return out


def _stop_cut(tokens: list[int], stop: list[int]) -> list[int]:
    """`tokens` cut where they first end with `stop`, as the scheduler
    ends a request on a stop sequence (the stop tokens kept)."""
    for j in range(len(stop), len(tokens) + 1):
        if tokens[j - len(stop):j] == stop:
            return tokens[:j]
    raise ValueError(f"{stop} is not in {tokens}")


def _latencies(t0: float, times: list[float]) -> tuple[float, float, float]:
    """(TTFT, TPOT, E2E) seconds of one request from its token times."""
    ttft, e2e = times[0] - t0, times[-1] - t0
    tpot = (times[-1] - times[0]) / (len(times) - 1) if len(times) > 1 \
        else float("nan")
    return ttft, tpot, e2e


def _medians_ms(rows) -> str:
    a = np.asarray(rows, float) * 1e3
    return (f"TTFT {np.nanmedian(a[:, 0]):.1f} ms, TPOT "
            f"{np.nanmedian(a[:, 1]):.2f} ms, E2E {np.nanmedian(a[:, 2]):.1f} "
            f"ms")


def offline_latencies(cfg, params, spec, max_len, slots, traffic):
    """The same requests through two offline engines (the gateway's two
    replicas' shapes; request i on engine i % 2), stepped in turns in
    this thread, every request submitted at once: per request (TTFT,
    TPOT, E2E) from host-clock token times, and its tokens."""
    from repro_torch.serving.engine import ServingEngine
    engines = [ServingEngine(cfg, params, max_len=max_len, serving=spec)
               for _ in range(2)]
    times: dict[int, list[float]] = {}

    def hook(events):
        now = time.perf_counter()
        for ev in events:
            times.setdefault(ev.rid, []).append(now)

    reqs = [r for r, _, _ in traffic]
    t0 = time.perf_counter()
    for i, eng in enumerate(engines):
        eng.add_step_hook(hook)
        eng.start(num_slots=slots)
        for r in reqs[i::2]:
            eng.submit(r)
    while any(e.has_work for e in engines):
        for e in engines:
            e.step()
    for e in engines:
        e.close()
    return {r.rid: _latencies(t0, times[r.rid]) for r in reqs}, \
        {r.rid: list(r.tokens) for r in reqs}


def gateway_phase(cfg, params, card: str) -> dict:
    """Phase 6: the OpenAI-compatible gateway at full width. A
    ``GatewayServer`` (127.0.0.1, a free port, its own thread) over a
    ``Router`` of 2 replicas that share `params`, each on the paged
    spec of phase 4b (16-token blocks, 256-token chunked prefill, prefix
    cache), drop-free (capacity factor = experts), 8 slots, with a
    session ``MoElessController``; telemetry on. Checks, each fatal: a
    greedy and a sampled request, each sent alone, give the tokens of
    ``engine.serve`` of the same request alone; the sampled one sent
    again (SSE) gives them again; each sent again with a stop sequence
    from its own answer (greedy: one token, unary; sampled: two, SSE)
    ends where its output first ends with it, finish "stop"; 16
    concurrent clients all end with their budget; /metrics is
    Prometheus text with the router, scheduler, KV and control
    families; the paged kernel and both bf16 ``moe_gmm`` kernels
    launched. Returns this phase's launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ServingSpec
    from repro_torch.launch.profile_decode import trace_sampler
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import MoElessController, ServingEngine
    from repro_torch.serving.gateway import (AutoscalerConfig, EngineDriver,
                                             Router)
    from repro_torch.serving.scheduler import GenRequest, SamplingParams
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    spec = ServingSpec(kv="paged", kv_block=PAGED_BLOCK,
                       prefill_chunk=PAGED_CHUNK, prefix_cache=True)
    slots, max_len = 8, SYSTEM_LEN + 128 + 16 * 15 + GATEWAY_GEN + 1
    tel = Telemetry()
    # host seconds of each replica step, and of each submission the
    # event loop makes (routing, subscribing and submitting take the
    # replicas' engine locks)
    step_s: list[float] = []
    submit_s: list[float] = []

    def timed(fn, out):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                out.append(time.perf_counter() - t)
        return run

    def factory(i: int):
        eng = ServingEngine(cfg, params, max_len=max_len, serving=spec,
                            telemetry=tel, name=f"replica{i}")
        eng.step = timed(eng.step, step_s)
        ctrl = MoElessController(cfg, num_devices=8, telemetry=tel,
                                 track=f"replica{i}/control")
        return EngineDriver(eng, replica_id=i, num_slots=slots,
                            max_pending=64, control=ctrl)

    log(f"  2 replicas sharing the weights: {spec}, {slots} slots each, "
        f"max_len {max_len}, capacity factor {cfg.moe.capacity_factor} "
        "(drop-free), a session MoElessController each, telemetry on")
    traffic = gateway_traffic(cfg)
    K.reset_launch_counts()
    router = Router(factory, threaded=True, telemetry=tel,
                    scaler=AutoscalerConfig(min_replicas=2, max_replicas=2))
    router.submit = timed(router.submit, submit_s)
    hosted = HostedGateway(router)
    try:
        # alone: a greedy and a sampled request (prompts of their own,
        # sharing no prefix) against engine.serve of the same request
        rng = np.random.default_rng(7)
        alone = []
        for samp in (SamplingParams(),
                     SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=77)):
            prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
            body = {"prompt": prompt, "max_tokens": GATEWAY_GEN,
                    "temperature": samp.temperature, "top_k": samp.top_k,
                    "top_p": samp.top_p, "seed": samp.seed}
            got = http_completion(hosted.port, body, chat=False)
            req = GenRequest(rid=0, arrival=0.0,
                             prompt=np.asarray(prompt, np.int32),
                             max_new_tokens=GATEWAY_GEN, sampling=samp)
            ServingEngine(cfg, params, max_len=max_len, serving=spec).serve(
                [req], num_slots=slots)
            if got["tokens"] != list(req.tokens):
                raise AssertionError(
                    f"alone, temperature {samp.temperature}: HTTP "
                    f"{got['tokens']} != engine.serve {list(req.tokens)}")
            alone.append((body, got["tokens"]))
        body, want = alone[1]
        again = http_completion(hosted.port, {**body, "stream": True},
                                chat=False)
        if again["tokens"] != want:
            raise AssertionError(f"the sampled request sent again (SSE) gave "
                                 f"{again['tokens']}, first {want}")
        # the stop path: each again with a stop sequence taken from its
        # own answer (greedy: one token, unary; sampled: two, SSE) ends
        # where its output first ends with it, finish "stop"
        for body, want, at, n, stream in ((*alone[0], 8, 1, False),
                                          (*alone[1], 12, 2, True)):
            stop = want[at:at + n]
            cut = _stop_cut(want, stop)
            got = http_completion(hosted.port, {**body, "stop": [stop],
                                                "stream": stream},
                                  chat=False)
            if got["finish"] != "stop" or got["tokens"] != cut:
                raise AssertionError(
                    f"stop {stop} (temperature {body['temperature']}): "
                    f"{got['tokens']} finish {got['finish']!r}, want {cut}")
            log(f"  stop {stop} (temperature {body['temperature']}, "
                f"{'SSE' if stream else 'unary'}): finish 'stop' after "
                f"{len(cut)} of {GATEWAY_GEN} tokens, ending with it")
        log(f"  alone: greedy and sampled (temperature 0.8, top-k 50, top-p "
            f"0.95, seed 77) requests over HTTP == engine.serve of each "
            f"alone ({GATEWAY_GEN} tokens each); the sampled one again over "
            f"SSE == its first answer")
        # 16 concurrent clients
        del submit_s[:], step_s[:]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(traffic)) as ex:
            futs = [ex.submit(http_completion, hosted.port, body, chat)
                    for _, body, chat in traffic]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        # /metrics as Prometheus text
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", hosted.port,
                                          timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        router_m = hosted.router.metrics()
    finally:
        hosted.close()
    launches = K.launch_counts()
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    missing = [p for p in ("router_", "scheduler_", "kv_", "control_")
               if not any(f.startswith(p) for f in families)]
    if resp.status != 200 or missing:
        raise AssertionError(f"/metrics: HTTP {resp.status}, families "
                             f"missing {missing}")
    for (req, body, chat), got in zip(traffic, results):
        if got["finish"] != "length" or len(got["tokens"]) != GATEWAY_GEN:
            raise AssertionError(f"request {req.rid}: {len(got['tokens'])} "
                                 f"tokens, finish {got['finish']!r}")
    for k_name in ("decode_attention_paged", "fused_gate_up", "gmm"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched through the "
                                 "gateway")
    streamed = [i for i, (_, body, _) in enumerate(traffic)
                if body["stream"]]
    http_lat = [_latencies(results[i]["t0"], results[i]["times"])
                for i in streamed]
    off, off_tokens = offline_latencies(cfg, params, spec, max_len, slots,
                                        traffic)
    n_tok = sum(len(r["tokens"]) for r in results)
    log(f"  16 clients (8 greedy, 8 sampled; 8 SSE; 8 chat): {n_tok} "
        f"tokens in {wall:.2f} s "
        f"({n_tok / wall:.1f} tokens/s), finish reasons "
        f"{sorted(set(r['finish'] for r in results))}; router admitted "
        f"{router_m['router']['admitted']}, completed "
        f"{router_m['router']['completed']}, by replica "
        f"{[r['completed'] for r in router_m['replicas']]}")
    log(f"  /metrics: {len(families)} families, router/scheduler/kv/control "
        "present")
    log(f"  the event loop blocked in Router.submit (route, subscribe, "
        f"submit: the replicas' engine locks) {np.median(submit_s) * 1e3:.1f}"
        f" ms median, {max(submit_s) * 1e3:.1f} ms max, {sum(submit_s):.2f} s "
        f"in all over {len(submit_s)} submissions; a replica step took "
        f"{np.median(step_s) * 1e3:.1f} ms median over {len(step_s)} steps")
    log(f"  launches in this phase (HTTP and the two engine.serve runs of "
        f"the alone checks): {launches}")
    log(f"  wall latencies on {card}, medians over the 8 SSE requests:")
    log(f"    over HTTP:                    {_medians_ms(http_lat)}")
    log(f"    offline engines (2, in turns): "
        f"{_medians_ms([off[i] for i in streamed])}")
    same = sum(off_tokens[i] == results[i]["tokens"]
               for i in range(len(traffic)))
    log(f"    offline tokens equal to HTTP's for {same} of {len(traffic)} "
        "requests (batch composition and prefix-cache timing differ "
        "between the runs; not a check)")
    s_launch, s_kern = trace_sampler(cfg.padded_vocab, rows=slots)
    log(f"  sampler: {s_launch:.1f} kernel launches a sampled step (8 rows x "
        f"{cfg.padded_vocab}), device busy "
        f"{sum(ms for _, ms in s_kern):.4f} ms a call (torch.profiler)")
    return launches


# ------------------------------------------------------------ phase 4c


def runtime_phase(full, max_len: int, slots: int, card: str) -> dict:
    """Phase 4c: the expert runtime on the EP slot plane at full width
    with int8 slot banks (4 of 32 layers: the quantized padded bank, one
    64-slot bank and the layer's own experts take ~15.7 GB a layer),
    then every layer's EP MoE sublayer through the kernels against the
    plain path from the same input and the runtime's tables and banks.
    Returns this run's launch counts."""
    from repro_torch.core.costmodel import param_bytes
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    cfg = full.with_(num_layers=RUNTIME_LAYERS, moe=dataclasses.replace(
        full.moe, slot_dtype="int8"))
    log(f"  reduced: num_layers {full.num_layers}->{cfg.num_layers}; "
        f"slot_dtype int8; {slots} slots, contiguous KV, session "
        f"MoElessController(num_devices={EP_DEVICES}, slots_per_device="
        f"{EP_SLOTS_PER_DEVICE})")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params made on the card in {time.perf_counter() - t0:.1f} s")
    ctrl = MoElessController(cfg, num_devices=EP_DEVICES,
                             slots_per_device=EP_SLOTS_PER_DEVICE)
    engine = ServingEngine(cfg, params, max_len=max_len,
                           expert_runtime="on", runtime_double_buffer=False)
    reqs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
    torch.cuda.reset_peak_memory_stats()
    res, launches, pre_s, dec_s, dec_tok, wall = serve_timed(
        engine, reqs, slots, control=ctrl)
    peak = torch.cuda.max_memory_allocated()
    check_budgets(reqs, "runtime request")
    rt = res.runtime
    st = rt.stats
    log(f"  served {len(reqs)} requests, {res.generated_tokens} tokens in "
        f"{res.iterations} decode steps + {res.prefills} prefills (the "
        f"wall time includes the session start: int8 quantization of the "
        f"bank and the bootstrap load)")
    log(f"  launches in this run: {launches}")
    for k_name in ("fused_gate_up_quant", "gmm_quant", "decode_attention"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the "
                                 "runtime path")
    for k_name in ("fused_gate_up", "gmm"):
        if launches[k_name] != 0:
            raise AssertionError(f"{k_name} launched {launches[k_name]} "
                                 "times: a MoE layer bypassed the slot plane")
    by_path = {k: dict(v) for k, v in MG.QUANT_PATH_LAUNCHES.items()}
    log(f"  int8 launches by path in this run: {by_path}")
    for k_name, paths in by_path.items():
        if paths["wgmma"] != launches[k_name] or paths["simt"] != 0:
            raise AssertionError(f"{k_name}: {paths} launches by path; every "
                                 "one of the bf16 run should take wgmma")
    row = param_bytes(cfg)
    if st.bytes_moved != st.transfers * row or \
            st.rank_bytes != {"rank0": st.bytes_moved}:
        raise AssertionError(f"runtime bytes {st.bytes_moved} != "
                             f"{st.transfers} transfers x {row} B, or rank "
                             f"bytes {st.rank_bytes}")
    bank_bytes = sum(t.numel() * t.element_size()
                     for j in rt.moe_positions
                     for bank in (rt.banks[j], rt.padded[j])
                     for t in bank.values())
    log(f"  runtime: cold/warm/prewarmed {st.counts()}, {st.transfers} "
        f"transfers, {st.bytes_moved:.0f} B moved ({row:.0f} B a copy), "
        f"rank bytes {st.rank_bytes}, evictions {st.evictions}, overlap "
        f"{st.overlap_eligible_copies} eligible / {st.exposed_copies} "
        f"exposed; by phase {st.by_phase}")
    log(f"  slot banks: {rt.phys_slots} slots a layer, single-buffered; "
        f"slot bank + padded quantized bank {bank_bytes / 1e9:.2f} GB over "
        f"{rt.n_layers} layers")
    med_dec = float(np.median(dec_s)) * 1e3
    log(f"  wall times on {card}:")
    for bucket in sorted(pre_s):
        log(f"    prefill bucket {bucket}: median "
            f"{np.median(pre_s[bucket]) * 1e3:.2f} ms over "
            f"{len(pre_s[bucket])}")
    log(f"    decode step: median {med_dec:.2f} ms over {len(dec_s)} "
        f"steps; {dec_tok / sum(dec_s):.1f} decode tokens/s")
    log(f"    whole run: {wall:.2f} s, {res.generated_tokens / wall:.1f} "
        f"tokens/s; max_memory_allocated {peak / 1e9:.2f} GB")
    del engine
    # every layer's EP MoE sublayer, kernels vs plain, on the runtime's
    # final tables and banks: the longest prompt's prefill, then one
    # batched decode step over `slots` prefilled prompts
    ep = (rt.ctx, rt.ep_state())
    dev = params["embed"].device
    ref_cfg = cfg.with_(impl="ref")
    prompts = [r.prompt for r in reqs]
    with torch.no_grad():
        longest = max(prompts, key=len)
        toks = torch.from_numpy(longest[None].astype(np.int64)).to(dev)
        sublayer_check(f"EP prefill of {len(longest)} tokens", cfg, params,
                       toks, T.init_cache(cfg, params, 1, max_len), 0, None,
                       ep=ep)
        lens = [min(len(p), 128 + 16 * i) for i, p in
                enumerate(prompts[:slots])]
        plen = max(lens)
        batch_toks = torch.from_numpy(np.stack(
            [np.pad(p[:n], (0, plen - n)) for p, n in
             zip(prompts[:slots], lens)]).astype(np.int64)).to(dev)
        pool = T.init_cache(ref_cfg, params, slots, max_len)
        lg, _, _ = T.decode_step(ref_cfg, params, {"tokens": batch_toks},
                                 pool, 0)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        nxt = lg[torch.arange(slots, device=dev), lengths - 1] \
            .argmax(-1)[:, None]
        active = torch.ones((slots, 1), dtype=torch.bool, device=dev)
        sublayer_check("EP batched decode step", cfg, params, nxt, pool,
                       lengths, active, ep=ep)
    del rt, res, ep, pool, lg
    gc.collect()
    torch.cuda.empty_cache()
    # the same burst with the load predictor (gate replicas at distance
    # 1) on the session controller: its plans move the slot traffic
    pst = runtime_predictor_session(cfg, params, max_len, slots)
    log(f"  runtime with the predictor (distance 1) against the oracle "
        f"session (actual loads): cold/warm/prewarmed {pst.counts()} "
        f"against {st.counts()}, {pst.transfers} against {st.transfers} "
        f"transfers, {pst.bytes_moved:.0f} against {st.bytes_moved:.0f} "
        f"B moved")
    del params
    torch.cuda.empty_cache()
    return launches


def runtime_predictor_session(cfg, params, max_len: int, slots: int):
    """Phase 4c's burst through a fresh runtime engine whose session
    controller carries the predictor (``from_gates`` at distance 1):
    every int8 launch on "wgmma", host transfers = iterations, bytes =
    transfers x a replica's bytes. Returns the runtime's meters."""
    from repro_torch.core.costmodel import param_bytes
    from repro_torch.core.predictor import from_gates
    from repro_torch.serving.engine import MoElessController, ServingEngine
    ctrl = MoElessController(cfg, num_devices=EP_DEVICES,
                             slots_per_device=EP_SLOTS_PER_DEVICE,
                             predictor=from_gates(cfg, params, 1))
    engine = ServingEngine(cfg, params, max_len=max_len,
                           expert_runtime="on", runtime_double_buffer=False)
    reqs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
    res, launches, _, dec_s, _, wall = serve_timed(engine, reqs, slots,
                                                   control=ctrl)
    del engine
    for r in reqs:
        if len(r.tokens) != r.max_new_tokens:
            raise AssertionError(f"predictor session, request {r.rid}: "
                                 f"{len(r.tokens)} of {r.max_new_tokens}")
    by_path = {k: dict(v) for k, v in MG.QUANT_PATH_LAUNCHES.items()}
    log(f"  predictor session: launches {launches}, int8 by path "
        f"{by_path}; decode step median {np.median(dec_s) * 1e3:.2f} ms, "
        f"whole run {wall:.2f} s; {ctrl.iterations} iterations = "
        f"{ctrl.host_transfers} host transfers")
    for k_name, paths in by_path.items():
        if launches[k_name] <= 0 or paths["wgmma"] != launches[k_name] \
                or paths["simt"] != 0:
            raise AssertionError(f"predictor session, {k_name}: {paths} "
                                 "launches by path; every one should take "
                                 "wgmma")
    if ctrl.host_transfers != ctrl.iterations:
        raise AssertionError("predictor session: more than one host "
                             "transfer an iteration")
    st = res.runtime.stats
    if st.bytes_moved != st.transfers * param_bytes(cfg):
        raise AssertionError(f"predictor session: {st.bytes_moved} B != "
                             f"{st.transfers} transfers x "
                             f"{param_bytes(cfg)} B")
    return st


# ------------------------------------------------------------ phase 7

PRED_BATCHES, PRED_SHAPE = 4, (4, 512)   # 8,192 tokens through forward


def forward_shape_kernels(gen, cfg, params, tokens: int) -> dict:
    """fused_gate_up and gmm at the shape ``forward`` gives them for
    `tokens` tokens in one dispatch group, (E, C, D) = (8, 640, 4096) at
    mixtral's width: the path of the real weights (must be "wgmma"),
    then one launch against its plain version (bf16 tolerance), timed
    beside its byte bound, the plain version and the library call.
    Returns {name: record}."""
    from repro_torch.models import transformer as T
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    d, f = cfg.d_model, cfg.moe.d_ff
    cap = max(1, math.ceil(cfg.moe.capacity_factor * k * tokens / e))
    experts = T._period(params["layers"][0], 0)["moe"]["experts"]
    x = torch.empty((e, cap, d), dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(3)
    gs = rng.integers(cap // 2, cap + 1, e).tolist()
    out = {}
    for name, fused, (cd, cf_) in (("fused_gate_up", True, (d, f)),
                                   ("gmm", False, (f, d))):
        w = experts["w_gate" if fused else "w_down"]
        xx = x if fused else torch.empty((e, cap, f), dtype=torch.bfloat16,
                                         device="cuda")
        path = MG.kernel_path(xx, w, fused)[0]
        if path != "wgmma":
            raise AssertionError(f"{name}: forward's ({e}, {cap}, {cd}) "
                                 f"shape took {path}, not wgmma")
        out[name] = gmm_shape_timed(gen, name, fused, "forward",
                                    (e, cap, cd, cf_, gs))
    return out


def gmm_shape_timed(gen, name, fused, label, shape) -> dict:
    """``fused_gate_up`` or ``gmm`` at one bf16 serving shape (E, C, D,
    F, group sizes) on seeded inputs: the path must be "wgmma"; against
    its plain version (rows past the group size exactly 0), timed beside
    its bound (the bytes of the experts with rows only), the plain
    version and the library call. Returns the record."""
    e, c, d, f, gs = shape
    x, wg, wu, g = _gmm_inputs(gen, e, c, d, f, torch.bfloat16, gs, fused)
    path, info = MG.kernel_path(x, wg, fused)
    if path != "wgmma":
        raise AssertionError(f"{name}: the {label} shape ({e}, {c}, {d}, "
                             f"{f}) took {path}, not wgmma")
    err = _gmm_check(name, fused, f"{label} {e}x{c}x{d}x{f}", x, wg, wu, g,
                     torch.bfloat16)
    plain, library = _gmm_plain_library(fused, x, wg, wu, g)
    ms = time_ms(lambda: _gmm_run(name, fused, x, wg, wu, g))
    plain_ms, lib_ms = time_ms(plain), time_ms(library)
    nbytes, flops = _gmm_bytes_flops(x, wg, wu, g)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    live = sum(1 for n in gs if n > 0)
    log(f"  {name:<16} {label:<8} E={e} ({live} with rows) C={c} D={d} "
        f"F={f} bf16 ({path}, N={info['rows']}, {info['stages']} stages, "
        f"{info['smem']} B shared a CTA) max_abs_err={err:.3e} "
        f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB) "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
    del x, wg, wu
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err, path=path)


def forward_logits_check(cfg, params, tokens, max_len: int) -> None:
    """``forward``'s last-position logits through the kernels against
    ``decode_step(cache_len=0)``'s from the same tokens (the same
    kernels: bf16 tolerance elementwise, fatal) and against ``forward``
    on the plain path (impl="ref"): compared as phase 4's logits are,
    and elementwise within the bf16 tolerance when every layer routed
    the same loads (a near-tied route flips on a last-bit difference)."""
    from repro_torch.models import transformer as T
    ref_cfg = cfg.with_(impl="ref")
    b = tokens.shape[0]
    with torch.no_grad():
        fl, fm = T.forward(cfg, params, {"tokens": tokens}, last_only=True)
        cache = T.init_cache(cfg, params, b, max_len)
        dl, _, dm = T.decode_step(cfg, params, {"tokens": tokens}, cache, 0)
        del cache
        rl, rm = T.forward(ref_cfg, params, {"tokens": tokens},
                           last_only=True)
    err = check("forward vs decode_step, last position", fl[:, 0],
                dl[:, -1], torch.bfloat16)
    log(f"  forward vs decode_step(cache_len=0), last position of "
        f"{b} x {tokens.shape[1]}: max_abs_err={err:.3e} "
        f"(atol=rtol={TOL[torch.bfloat16]}), same expert loads "
        f"{bool(torch.equal(fm['expert_load'], dm['expert_load']))}")
    res = compare_logits("forward, kernels vs impl=ref, last position",
                         fl[:, 0], rl[:, 0], fm["expert_load"],
                         rm["expert_load"])
    if res["same_expert_loads"]:
        check("forward kernels vs impl=ref (same routes)", fl, rl,
              torch.bfloat16)


def predictor_phase(cfg, params, max_len: int, slots: int,
                    card: str) -> dict:
    """Phase 7: the expert load predictor at full width on phase 4's
    weights. (a) the gate dataset through ``forward`` (4 batches of 4 x
    512 tokens) with its MoE launches and their path, the kernels at
    forward's shape, forward's logits checked; (b) same-layer replicas
    against the router, replicas at distance 1 and 2, layer-aware
    fine-tuning at distance 1 (timed); (c) phase 4's burst served with
    the fine-tuned predictor on the session controller and with the
    oracle controller (actual loads), in turns, two rounds each.
    Returns this phase's launch counts."""
    from repro_torch.core import predictor as P
    from repro_torch.launch.profile_decode import trace_predictor
    from repro_torch.serving.engine import MoElessController, ServingEngine
    k = cfg.moe.top_k
    dev = params["embed"].device
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, cfg.vocab_size, PRED_SHAPE, dtype=np.int32)
               for _ in range(PRED_BATCHES)]
    n_moe = cfg.num_layers // cfg.moe.every_n_layers
    phase_launches = dict.fromkeys(K.launch_counts(), 0)

    def count(launches):
        for n, v in launches.items():
            phase_launches[n] += v

    # (a) the dataset through forward
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = P.collect_gate_dataset(cfg, params, batches)
    dt = time.perf_counter() - t0
    fwd = K.launch_counts()
    count(fwd)
    n_tok = PRED_BATCHES * PRED_SHAPE[0] * PRED_SHAPE[1]
    log(f"  gate dataset: {PRED_BATCHES} batches of {PRED_SHAPE} tokens "
        f"through forward in {dt:.2f} s (host copies included): inputs "
        f"{ds['inputs'].shape} ({ds['inputs'].nbytes / 1e9:.2f} GB on the "
        f"host), logits {ds['logits'].shape}")
    log(f"  launches in forward: {fwd}")
    for name in ("fused_gate_up", "gmm"):
        if fwd[name] != PRED_BATCHES * n_moe:
            raise AssertionError(f"forward launched {name} {fwd[name]} "
                                 f"times, not {PRED_BATCHES * n_moe}")
    for name, arr in ds.items():
        if arr.shape[:2] != (n_moe, n_tok) or not np.isfinite(arr).all():
            raise AssertionError(f"gate dataset {name}: shape {arr.shape} "
                                 "or non-finite values")
    gen = torch.Generator(device="cuda").manual_seed(1)
    kern = forward_shape_kernels(gen, cfg, params,
                                 PRED_SHAPE[0] * PRED_SHAPE[1])
    forward_logits_check(cfg, params,
                         torch.from_numpy(batches[0]).long().to(dev),
                         max_len)

    # (b) replicas, accuracy, fine-tuning
    train, test = P.split_dataset(ds)
    del ds
    same = P.profile_accuracy(P.from_gates(cfg, params, 0), test, k)
    log(f"  same-layer replicas (distance 0) recover the router's top-{k}:"
        f" {np.round(same, 4).tolist()}")
    if same.min() < 0.98:
        raise AssertionError(f"a same-layer replica recovers {same.min()} "
                             "of the router's top-k (< 0.98)")
    preds = {d: P.from_gates(cfg, params, d) for d in (1, 2)}
    accs = {d: P.profile_accuracy(p, test, k) for d, p in preds.items()}
    for d, a in accs.items():
        log(f"  distance {d}: top-{k} accuracy per layer "
            f"{np.round(a, 4).tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ft = P.finetune(preds[1], train, test, k, threshold=0.85, steps=120)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    sel = ft.finetuned_layers
    after = P.profile_accuracy(ft, test, k)
    if not sel:
        raise AssertionError("no layer under the 0.85 threshold at "
                             "distance 1: nothing was fine-tuned")
    log(f"  finetune(threshold=0.85, steps=120) at distance 1 on "
        f"{ft.weights.device}: {ft_s:.2f} s; layers {sel}: accuracy "
        f"{np.round(accs[1][sel], 4).tolist()} -> "
        f"{np.round(after[sel], 4).tolist()} (mean "
        f"{accs[1][sel].mean():.4f} -> {after[sel].mean():.4f})")
    if not after[sel].mean() > accs[1][sel].mean():
        raise AssertionError("fine-tuning did not raise the fine-tuned "
                             "layers' mean accuracy")
    if not torch.isfinite(ft.weights).all():
        raise AssertionError("non-finite fine-tuned predictor weights")
    cors = []
    for l in range(1, n_moe):
        hid = test["inputs"][l - 1]
        true = torch.as_tensor(test["logits"][l], device=dev)
        actual = torch.bincount(P._topk_idx(true, k).reshape(-1),
                                minlength=cfg.moe.num_experts)
        cors.append(P.load_correlation(ft.predict_loads(l, hid, k),
                                       actual.cpu().numpy()))
    log(f"  load correlation at distance 1 (fine-tuned, test split, per "
        f"layer): {np.round(cors, 4).tolist()}, mean {np.mean(cors):.4f}")
    del train, test

    # (c) serving: the fine-tuned predictor and the oracle, in turns
    for n in (slots, PRED_SHAPE[1]):
        launches, kern_ms = trace_predictor(ft, cfg, n)
        busy = sum(ms for _, ms in kern_ms)
        log(f"  predict_loads_all at {n} tokens a layer ({n_moe} layers): "
            f"{launches:.1f} kernel launches a call, device busy "
            f"{busy:.4f} ms a call (torch.profiler)")
    runs = {"predictor": [], "oracle": []}
    tokens = None
    for _ in range(2):
        for label, pred in (("predictor", ft), ("oracle", None)):
            rs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
            ctrl = MoElessController(cfg, num_devices=8, predictor=pred)
            engine = ServingEngine(cfg, params, max_len=max_len)
            res, launches, _, dec_s, _, wall = serve_timed(
                engine, rs, slots, control=ctrl)
            count(launches)
            del engine
            toks = [list(r.tokens) for r in rs]
            tokens = tokens or toks
            if toks != tokens:
                raise AssertionError(f"{label}: tokens differ from the "
                                     "first run's")
            if ctrl.host_transfers != ctrl.iterations:
                raise AssertionError(f"{label}: {ctrl.host_transfers} host "
                                     f"transfers in {ctrl.iterations} "
                                     "iterations")
            runs[label].append((res, ctrl, dec_s, wall))
    for label, rows in runs.items():
        res, ctrl = rows[-1][:2]
        summ = res.summary()
        dec = [np.median(r[2]) * 1e3 for r in rows]
        log(f"  {label}: decode step wall median "
            f"{', '.join(f'{d:.2f}' for d in dec)} ms (rounds 1, 2); "
            f"modeled TTFT p50 {summ['ttft']['p50'] * 1e3:.4f} ms, TPOT "
            f"p50 {summ['tpot']['p50'] * 1e3:.4f} ms, E2E p50 "
            f"{summ['e2e']['p50'] * 1e3:.4f} ms, cost {ctrl.cost:.6g}, "
            f"{ctrl.iterations} iterations = {ctrl.host_transfers} host "
            f"transfers; replicas per layer "
            f"{[p.total_replicas for p in ctrl.plans]}")
    if runs["predictor"][-1][1].replica_counts == \
            runs["oracle"][-1][1].replica_counts:
        log("  note: the predictor's replica counts equal the oracle's in "
            "every iteration")
    log(f"  launches in this phase (forward, then the four serving runs): "
        f"{phase_launches}")
    return {"launches": phase_launches, "kernels": kern}


# ------------------------------------------------------------ phase 5


def capacity_identity(small, sp) -> None:
    """Float32 smoke config at its own capacity factor, where the MoE
    dispatch drops tokens: greedy tokens through the kernels on the
    contiguous cache equal the plain path's, request by request."""
    from repro_torch.serving.engine import MoElessController, ServingEngine
    sreqs = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(small, sp, max_len=64 + 24 + 1, impl=impl,
                            controller=MoElessController(small))
        rs = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10)
        eng.serve(rs, num_slots=4)
        sreqs[impl] = {r.rid: list(r.tokens) for r in rs}
    if sreqs["auto"] != sreqs["ref"]:
        bad = [i for i in sreqs["ref"] if sreqs["auto"][i] != sreqs["ref"][i]]
        raise AssertionError(f"float32 tokens differ for requests {bad}")
    log(f"  capacity factor {small.moe.capacity_factor}: "
        f"{len(sreqs['ref'])} requests, "
        f"{sum(map(len, sreqs['ref'].values()))} tokens: contiguous "
        "impl=auto == impl=ref")


def token_identity(small, sp) -> None:
    """Float32 smoke config at a drop-free capacity factor: greedy tokens
    through the kernels on the contiguous cache, the paged pool (solo),
    chunked prefill and a prefix-warm pool equal the plain path's on the
    contiguous cache, request by request; and so do the tokens of a
    trace where half the requests sample (temperature 0.9, top-p 0.9,
    seeded), which differ from that trace's greedy tokens."""
    from repro_torch.configs import ServingSpec
    from repro_torch.serving.engine import MoElessController, ServingEngine
    max_len = 64 + 24 + 1
    runs = [("contiguous", "ref", ServingSpec()),
            ("contiguous", "auto", ServingSpec()),
            ("paged solo", "auto", ServingSpec(kv="paged", kv_block=5)),
            ("paged chunked", "auto", ServingSpec(kv="paged", kv_block=5,
                                                  prefill_chunk=7)),
            ("paged chunked prefix-warm", "auto",
             ServingSpec(kv="paged", kv_block=4, prefill_chunk=8,
                         prefix_cache=True))]
    greedy = None
    for trace in ("random prompts", "shared system prompt, two waves",
                  "random prompts, half sampled"):
        got = {}
        for label, impl, spec in runs:
            eng = ServingEngine(small, sp, max_len=max_len, impl=impl,
                                controller=MoElessController(small),
                                serving=spec)
            if trace.startswith("random prompts"):
                waves = [make_requests(small, (64, 17, 40, 9, 33),
                                       (24, 7, 16), 10,
                                       sampled=trace.endswith("sampled"))]
            else:
                waves = shared_prefix_waves(small, 21, [[9, 30, 3, 17, 40],
                                                        [0, 5, 22, 11, 36]],
                                            (24, 7, 16))
            eng.start(num_slots=4)
            for wave in waves:
                for r in wave:
                    eng.submit(r)
                eng.run()
            kv = eng._session.kv
            eng.close()
            got[(label, impl)] = {r.rid: list(r.tokens)
                                  for w in waves for r in w}
            extra = ""
            if getattr(kv, "prefix", None) is not None:
                extra = (f" (prefix hits {kv.prefix.hits}, copy-on-write "
                         f"{kv.cow_blocks})")
                if trace.startswith("shared") and (kv.prefix.hits < 5
                                                   or kv.cow_blocks < 1):
                    raise AssertionError("prefix-warm run had no warm hits")
            base = got[("contiguous", "ref")]
            if got[(label, impl)] != base:
                bad = [i for i in base if got[(label, impl)][i] != base[i]]
                raise AssertionError(f"{trace}: {label} impl={impl} tokens "
                                     f"differ for requests {bad}")
            log(f"  {trace}: {label} impl={impl}: "
                f"{sum(map(len, base.values()))} tokens == contiguous "
                f"impl=ref{extra}")
        if trace == "random prompts":
            greedy = got[("contiguous", "ref")]
        elif trace.endswith("sampled"):
            base = got[("contiguous", "ref")]
            if any(base[i] == greedy[i] for i in base if i % 2) or \
                    any(base[i] != greedy[i] for i in base if i % 2 == 0):
                raise AssertionError("sampled requests gave their greedy "
                                     "tokens, or greedy ones did not")


def sampled_batching(small, sp) -> None:
    """Float32 smoke config at a drop-free capacity factor, through the
    kernels: a trace where half the requests sample gives, served in
    one batch, the tokens of serving each request alone (keys fold per
    request, not per slot), contiguous and paged with chunked prefill."""
    from repro_torch.configs import ServingSpec
    from repro_torch.serving.engine import ServingEngine
    for label, spec in (("contiguous", ServingSpec()),
                        ("paged chunked", ServingSpec(kv="paged",
                                                      kv_block=5,
                                                      prefill_chunk=7))):
        eng = ServingEngine(small, sp, max_len=64 + 24 + 1, serving=spec)
        alone = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10,
                              sampled=True)
        for r in alone:
            eng.serve([r], num_slots=4)
        batch = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10,
                              sampled=True)
        res = eng.serve(batch, num_slots=4)
        if [r.tokens for r in batch] != [r.tokens for r in alone] or \
                res.mean_batch_occupancy <= 1.0:
            bad = [r.rid for r, q in zip(batch, alone) if r.tokens != q.tokens]
            raise AssertionError(f"{label}: sampled batched tokens differ "
                                 f"from sequential for requests {bad}")
        log(f"  half sampled, {label} impl=auto: batched (occupancy "
            f"{res.mean_batch_occupancy:.2f}) == one request at a time "
            f"({sum(len(r.tokens) for r in batch)} tokens)")


def runtime_identity(small, sp) -> None:
    """Float32 smoke config with the expert runtime on (a session MoEless
    controller): greedy tokens through the kernels equal the plain
    path's with float32 and with int8 slot banks, at the config's own
    capacity factor, and a single-buffered slot bank (phase 4c's) gives
    the double-buffered one's tokens and runtime meters; at the drop-free
    factor the runtime's tokens equal the runtime-off engine's (capacity
    dispatch, same session controller)."""
    from repro_torch.serving.engine import MoElessController, ServingEngine
    max_len = 64 + 24 + 1

    def serve(cfg, impl, runtime, double_buffer=True):
        eng = ServingEngine(cfg, sp, max_len=max_len, impl=impl,
                            expert_runtime=runtime,
                            runtime_double_buffer=double_buffer)
        rs = make_requests(cfg, (64, 17, 40, 9, 33), (24, 7, 16), 10)
        K.reset_launch_counts()
        res = eng.serve(rs, num_slots=4, control=MoElessController(cfg))
        return {r.rid: list(r.tokens) for r in rs}, res, K.launch_counts()

    for sd in ("fp32", "int8"):
        cfg = small.with_(moe=dataclasses.replace(small.moe, slot_dtype=sd))
        got = {impl: serve(cfg, impl, "on") for impl in ("auto", "ref")}
        quant = got["auto"][2]["fused_gate_up_quant"]
        plain = got["auto"][2]["fused_gate_up"]
        if (quant > 0) != (sd == "int8") or (plain > 0) != (sd == "fp32"):
            raise AssertionError(f"{sd} banks launched {got['auto'][2]}")
        if got["auto"][0] != got["ref"][0]:
            bad = [i for i in got["ref"][0]
                   if got["auto"][0][i] != got["ref"][0][i]]
            raise AssertionError(f"runtime on, {sd} banks: tokens differ for "
                                 f"requests {bad}")
        st = got["auto"][1].runtime.stats
        one = serve(cfg, "auto", "on", double_buffer=False)
        if one[0] != got["auto"][0] or \
                dataclasses.asdict(one[1].runtime.stats) != \
                dataclasses.asdict(st):
            raise AssertionError(f"runtime on, {sd} banks: the single-"
                                 "buffered bank's tokens or meters differ "
                                 "from the double-buffered one's")
        n_tok = sum(map(len, got["ref"][0].values()))
        log(f"  runtime on, {sd} banks, capacity factor "
            f"{cfg.moe.capacity_factor}: {n_tok} tokens impl=auto == "
            f"impl=ref == single-buffered bank (runtime c/w/p "
            f"{st.counts()}, {st.transfers} transfers, "
            f"{st.bytes_moved:.0f} B)")
    free = small.with_(moe=dataclasses.replace(
        small.moe, capacity_factor=float(small.moe.num_experts)))
    on, off = serve(free, "auto", "on")[0], serve(free, "auto", "off")[0]
    if on != off:
        bad = [i for i in off if on[i] != off[i]]
        raise AssertionError(f"drop-free: runtime on tokens differ from off "
                             f"for requests {bad}")
    log(f"  drop-free capacity factor: runtime on == runtime off "
        f"({sum(map(len, off.values()))} tokens)")


def predictor_identity(small, sp) -> None:
    """Float32 smoke config at a drop-free capacity factor with the load
    predictor (gate replicas at distance 1) on the session controller:
    through the kernels, the plain path's tokens (half the requests
    sampled) and controller meters (iterations, host transfers, replica
    counts, modeled layer latencies, cost), contiguous and paged with
    chunked prefill; with the expert runtime on, the runtime-off
    engine's tokens."""
    from repro_torch.configs import ServingSpec
    from repro_torch.core.predictor import from_gates
    from repro_torch.serving.engine import MoElessController, ServingEngine
    free = small.with_(moe=dataclasses.replace(
        small.moe, capacity_factor=float(small.moe.num_experts)))
    pred = from_gates(free, sp, 1)
    max_len = 64 + 24 + 1
    off = None

    def serve(impl, spec, runtime="off"):
        # E slots a device: no device ever holds more than E instances
        ctrl = MoElessController(free, predictor=pred,
                                 slots_per_device=free.moe.num_experts)
        eng = ServingEngine(free, sp, max_len=max_len, impl=impl,
                            serving=spec, expert_runtime=runtime)
        rs = make_requests(free, (64, 17, 40, 9, 33), (24, 7, 16), 10,
                           sampled=True)
        res = eng.serve(rs, num_slots=4, control=ctrl)
        if ctrl.host_transfers != ctrl.iterations:
            raise AssertionError("predictor: more than one host transfer "
                                 "an iteration")
        meters = (ctrl.iterations, ctrl.host_transfers, ctrl.replica_counts,
                  ctrl.layer_latency, ctrl.cost, res.clock_s)
        return {r.rid: list(r.tokens) for r in rs}, meters

    for label, spec in (("contiguous", ServingSpec()),
                        ("paged chunked", ServingSpec(kv="paged", kv_block=5,
                                                      prefill_chunk=7))):
        got = {impl: serve(impl, spec) for impl in ("auto", "ref")}
        if got["auto"][0] != got["ref"][0]:
            raise AssertionError(f"predictor, {label}: kernel tokens differ "
                                 "from the plain path's")
        if got["auto"][1] != got["ref"][1]:
            raise AssertionError(f"predictor, {label}: controller meters "
                                 "differ between the kernels and the plain "
                                 "path")
        log(f"  predictor, {label}, half sampled: "
            f"{sum(map(len, got['ref'][0].values()))} tokens and the "
            f"controller's meters ({got['ref'][1][0]} iterations) impl=auto "
            f"== impl=ref")
        off = off or got["auto"][0]      # the contiguous run's tokens
    on = serve("auto", ServingSpec(), "on")[0]
    if on != off:
        bad = [i for i in off if on[i] != off[i]]
        raise AssertionError(f"predictor, drop-free: runtime on tokens "
                             f"differ from runtime off for requests {bad}")
    log(f"  predictor, drop-free, half sampled: runtime on == runtime off "
        f"({sum(map(len, off.values()))} tokens)")


# ------------------------------------------------------------ phase 8


class GmmPaths:
    """Within the block, counts the bf16 ``moe_gmm`` launches by the
    path each took: the kernel's own plan (``MG.kernel_path``) asked
    with each launch's operands. The wrapper's launch counts
    (``K.launch_counts``) are untouched."""

    def __enter__(self):
        self.counts = {"fused_gate_up": {}, "gmm": {}}
        self._launch = inner = MG._launch

        def launch(name, fused, x, wg, wu, group_sizes, path=None):
            taken = path or MG.kernel_path(x, wg, fused)[0]
            out = inner(name, fused, x, wg, wu, group_sizes, path=path)
            by = self.counts[name]
            by[taken] = by.get(taken, 0) + 1
            return out

        MG._launch = launch
        return self

    def __exit__(self, *exc):
        MG._launch = self._launch


def _check_launches(cfg, what: str, launches, paths, attn: str) -> None:
    """The run launched `attn` (decode attention, contiguous or paged)
    and, for a MoE config, both bf16 ``moe_gmm`` kernels, each launch on
    "wgmma"; a dense config launches no expert kernel."""
    need = [attn] + (["fused_gate_up", "gmm"] if cfg.is_moe else [])
    for k_name in need:
        if launches[k_name] <= 0:
            raise AssertionError(f"{what}: {k_name} was never launched")
    for k_name, by in paths.counts.items():
        if set(by) - {"wgmma"} or sum(by.values()) != launches[k_name]:
            raise AssertionError(f"{what}: {k_name} launches by path {by} "
                                 f"of {launches[k_name]}, not all wgmma")


def vlm_check(cfg, params, max_len: int) -> dict:
    """qwen2-vl: early fusion of 64 patch embeddings (a 8 x 8 grid at
    temporal position 0, M-RoPE positions (0, row, column)) ahead of
    text whose three axes agree: ``forward`` on the card (finite, kernels
    == plain logits), then every layer's sublayers, kernels vs plain,
    for the prefill into the cache and for one batched decode step at
    3-axis positions."""
    from repro_torch.models import transformer as T
    ref_cfg = cfg.with_(impl="ref")
    dev = params["embed"].device
    b, s, n_vis = 2, 256, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)
    vis = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                      dtype=torch.bfloat16) * 0.02
    mask = (torch.arange(s, device=dev) < n_vis)[None].expand(b, s)
    i = torch.arange(s, device=dev)
    grid = torch.stack([torch.zeros_like(i), i // 8, i % 8], -1)
    text = (i - n_vis + 8)[:, None].expand(s, 3)
    pos3 = torch.where((i < n_vis)[:, None], grid, text).to(torch.int32)
    pos3 = pos3[None].expand(b, s, 3).contiguous()
    extra = {"vis_embeds": vis, "vis_mask": mask, "positions": pos3}
    with torch.no_grad():
        outs = [T.forward(c, params, dict(extra, tokens=toks),
                          last_only=True)[0][:, -1]
                for c in (cfg, ref_cfg)]
        res = {"forward logits": compare_logits(
            "vlm forward, last position", outs[0], outs[1], None, None)}
        res["prefill sublayers"] = sublayer_check(
            "vlm prefill of 64 patches + 192 tokens", cfg, params, toks,
            T.init_cache(cfg, params, b, max_len), 0, None, extra=extra)
        pool = T.init_cache(ref_cfg, params, b, max_len)
        lg, _, _ = T.decode_step(ref_cfg, params, dict(extra, tokens=toks),
                                 pool, 0)
        nxt = lg[:, -1].argmax(-1)[:, None]
        step_pos = (pos3[:, -1:] + 1).contiguous()      # (B, 1, 3)
        res["decode sublayers"] = sublayer_check(
            "vlm batched decode step at 3-axis positions", cfg, params,
            nxt, pool, torch.full((b,), s, dtype=torch.int32, device=dev),
            torch.ones((b, 1), dtype=torch.bool, device=dev),
            extra={"positions": step_pos})
    return res


def family_phase(arch: str, card: str) -> dict:
    """Phase 8 for one family at its published widths: built on the card
    from a seed at bf16; 8 requests served through ``ServingEngine`` on
    the contiguous cache, then on the paged pool with chunked prefill
    and the prefix cache (half of those sampled), a MoE family with a
    MoEless controller over 8 devices: every request ends with its
    budget, no pool block leaks, each kernel's launches counted (the
    expert kernels' all on "wgmma"), the median decode step and prefill
    timed; then every layer's sublayers through the kernels against the
    plain path (the bf16 tolerance). Returns the family's record."""
    from repro_torch.configs import ServingSpec, get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    cfg = family_config(arch)
    slots, max_len = 8, FAMILY_MAX_LEN
    moe = (f", {cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff} top-"
           f"{cfg.moe.top_k} every {cfg.moe.every_n_layers}"
           if cfg.is_moe else "")
    log(f"  {arch}: layers {cfg.num_layers} of "
        f"{get_config(arch).num_layers}, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} kv, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}{moe}, vocab "
        f"{cfg.vocab_size}, {cfg.norm}, rope {cfg.rope}"
        f"{', qkv bias' if cfg.qkv_bias else ''}"
        f"{', qk norm' if cfg.qk_norm else ''}"
        f"{', tied embeddings' if cfg.tie_embeddings else ''}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    attn_path = attention_path(cfg)
    log(f"  params {n_par / 1e9:.2f} B, {n_par * 2 / 1e9:.1f} GB, made in "
        f"{time.perf_counter() - t0:.1f} s; decode attention path "
        f"{attn_path!r}")
    rec = {"layers": cfg.num_layers, "weights_gb": n_par * 2 / 1e9,
           "attention_path": attn_path}
    # contiguous KV, engine controller
    ctrl = MoElessController(cfg, num_devices=8) if cfg.is_moe else None
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl)
    reqs = make_requests(cfg, FAMILY_LENS, FAMILY_GENS, slots, seed=8)
    torch.cuda.reset_peak_memory_stats()
    with GmmPaths() as paths:
        res, launches, pre_s, dec_s, _, wall = serve_timed(engine, reqs,
                                                           slots)
    check_budgets(reqs, f"{arch} request")
    _check_launches(cfg, f"{arch} contiguous", launches, paths,
                    "decode_attention")
    pre = {bk: float(np.median(v)) * 1e3 for bk, v in sorted(pre_s.items())}
    rec["contiguous"] = dict(
        launches=launches, gmm_paths=paths.counts,
        decode_ms=float(np.median(dec_s)) * 1e3, prefill_ms=pre,
        wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  contiguous: {res.generated_tokens} tokens in {res.iterations} "
        f"steps + {res.prefills} prefills, launches {launches}, moe_gmm "
        f"by path {paths.counts}; on {card}: decode step median "
        f"{rec['contiguous']['decode_ms']:.2f} ms over {len(dec_s)}, "
        f"prefill median ms by bucket "
        f"{ {bk: round(v, 2) for bk, v in pre.items()} }, whole run "
        f"{wall:.2f} s, max_memory_allocated "
        f"{rec['contiguous']['peak_gb']:.2f} GB")
    if ctrl is not None and len(ctrl.plans) != \
            cfg.num_layers // cfg.moe.every_n_layers:
        raise AssertionError(f"{arch}: {len(ctrl.plans)} layer plans")
    del engine, ctrl
    # paged KV, chunked prefill, prefix cache; half the requests sampled
    spec = ServingSpec(kv="paged", kv_block=PAGED_BLOCK,
                       prefill_chunk=PAGED_CHUNK, prefix_cache=True)
    ctrl = MoElessController(cfg, num_devices=8) if cfg.is_moe else None
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl,
                           serving=spec)
    reqs = make_requests(cfg, FAMILY_LENS, FAMILY_GENS, slots, seed=9,
                         sampled=True)
    with GmmPaths() as paths:
        launches, mixed_s, dec_s, wall = serve_waves(engine, [reqs], slots)
    check_budgets(reqs, f"{arch} paged request")
    check_pool_clean(engine._session.kv)
    engine.close()
    _check_launches(cfg, f"{arch} paged", launches, paths,
                    "decode_attention_paged")
    rec["paged"] = dict(launches=launches, gmm_paths=paths.counts,
                        mixed_ms=float(np.median(mixed_s)) * 1e3,
                        decode_ms=float(np.median(dec_s)) * 1e3, wall_s=wall)
    log(f"  paged (chunked {PAGED_CHUNK}, prefix cache, half sampled): "
        f"{len(mixed_s)} mixed + {len(dec_s)} decode-only steps, launches "
        f"{launches}, no leaked block; on {card}: mixed step median "
        f"{rec['paged']['mixed_ms']:.2f} ms, decode-only step median "
        f"{rec['paged']['decode_ms']:.2f} ms, whole run {wall:.2f} s")
    del engine, ctrl
    rec["logits"] = logits_check(cfg, params, [r.prompt for r in reqs],
                                 max_len, slots)
    if cfg.rope == "mrope":
        rec["vlm"] = vlm_check(cfg, params, max_len)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mixer_identity(kind: str, cfg, s: int = 64, b: int = 2) -> dict:
    """One recurrent mixer at `cfg`'s full width, float32 (TF32 off),
    weights and inputs from a seed on the card: ``*_seq`` from the zero
    state against ``*_step`` token by token, and ``*_seq`` over the
    second half from the state after the first half against the tail of
    ``*_seq`` over all `s` tokens (what a prompt prefilled into a cache
    computes): outputs and final states within the float32 tolerance.
    Returns the largest error of each comparison."""
    from repro_torch.models import ssm as S
    f32, dev = torch.float32, "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    d, h = cfg.d_model, cfg.num_heads
    if kind == "mamba":
        p, arg = S.init_mamba(gen, d, cfg.ssm, f32, dev), cfg.ssm
        zero = S.init_mamba_state(p, cfg.ssm, b)
    elif kind == "mlstm":
        p, arg = S.init_mlstm(gen, d, h, cfg.ssm.expand, f32, dev), h
        zero = S.init_mlstm_state(cfg, b, cfg.ssm.expand, dev)
    else:
        p, arg = S.init_slstm(gen, d, h, f32, dev), h
        zero = S.init_slstm_state(d, h, b, dev)
    seq, step = getattr(S, f"{kind}_seq"), getattr(S, f"{kind}_step")
    x = torch.randn((b, s, d), generator=gen, device=dev)

    def leaves(st):
        return [st[k] for k in sorted(st)] if isinstance(st, dict) \
            else list(st)

    def held(what, y, st, y_ref, st_ref):
        return max([check(f"{kind} {what}, y", y, y_ref, f32)]
                   + [check(f"{kind} {what}, state", a, r, f32)
                      for a, r in zip(leaves(st), leaves(st_ref))])

    with torch.no_grad():
        y, st = seq(p, x, arg)
        ys, sts = [], zero
        for t in range(s):
            yt, sts = step(p, x[:, t:t + 1], sts, arg)
            ys.append(yt)
        err_step = held("step by step vs seq", torch.cat(ys, 1), sts, y, st)
        _, mid = seq(p, x[:, :s // 2], arg)
        y2, st2 = seq(p, x[:, s // 2:], arg, mid)
        err_cont = held("seq from a state vs seq", y2, st2, y[:, s // 2:],
                        st)
    log(f"  {kind} at d_model {d}, float32, {b} x {s} tokens: *_step token "
        f"by token vs *_seq max_abs_err={err_step:.3e}; *_seq from the "
        f"state after {s // 2} vs the tail of *_seq max_abs_err="
        f"{err_cont:.3e} (atol=rtol={TOL[f32]})")
    return {"step_vs_seq": err_step, "seq_from_state_vs_seq": err_cont}


def prefill_forward_check(cfg, params, prompt, max_len: int) -> dict:
    """The fault's guard on the card: a prompt prefilled into a fresh
    cache (``decode_step``, every recurrent mixer over every prompt
    token) gives ``forward``'s logits at every position, through the
    kernels. Fatal: elementwise within the bf16 tolerance where every
    MoE layer routed the same loads (a near-tied route may flip on a
    last-bit difference of the attention paths), else argmax agreement
    at 99% of the positions or more."""
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    toks = torch.from_numpy(prompt[None].astype(np.int64)).to(dev)
    with torch.no_grad():
        fl, fm = T.forward(cfg, params, {"tokens": toks})
        cache = T.init_cache(cfg, params, 1, max_len)
        dl, _, dm = T.decode_step(cfg, params, {"tokens": toks}, cache, 0)
        del cache
    res = compare_logits(f"prefill of {toks.shape[1]} tokens into a fresh "
                         "cache vs forward, every position", dl[0], fl[0],
                         dm.get("expert_load"), fm.get("expert_load"))
    if res.get("same_expert_loads", True):
        check("prefill into a cache vs forward", dl, fl, torch.bfloat16)
    elif res["argmax_equal"] < 0.99:
        raise AssertionError(f"prefill into a cache vs forward: argmax "
                             f"agrees at {res['argmax_equal']:.3f}")
    return res


def recurrent_phase(arch: str, card: str) -> dict:
    """Phase 8 for a recurrent stack at its published widths: built on
    the card from a seed at bf16; 8 requests served through
    ``ServingEngine`` on the contiguous cache (jamba with a MoEless
    controller over 8 devices), prompts prefilled at exact length:
    every request ends with its budget, the paged layout raises
    ``ValueError``, each kernel's launches counted (the expert kernels'
    all on "wgmma"; xlstm launches none), the median decode step and the
    prefill by prompt length timed; then jamba's sublayers through the
    kernels against the plain path, each mixer's ``*_seq`` and
    ``*_step`` held to each other at float32, and a prefill into a
    fresh cache held to ``forward``. Returns the family's record."""
    from repro_torch.configs import ServingSpec, get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import layer_pattern
    from repro_torch.serving.engine import MoElessController, ServingEngine
    cfg = family_config(arch)
    slots, max_len = 8, FAMILY_MAX_LEN
    subs = layer_pattern(cfg)
    pattern = [f"{sub.mixer}+{sub.ffn}" for sub in subs]
    moe = (f", {cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff} top-"
           f"{cfg.moe.top_k} every {cfg.moe.every_n_layers}"
           if cfg.is_moe else "")
    log(f"  {arch}: layers {cfg.num_layers} of "
        f"{get_config(arch).num_layers} (period {pattern}), d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} kv, "
        f"d_ff {cfg.d_ff}{moe}, {cfg.ssm}, vocab {cfg.vocab_size}, "
        f"{cfg.norm}, rope {cfg.rope}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    kernels = (["fused_gate_up", "gmm"] if cfg.is_moe else []) + \
        (["decode_attention"] if any(sub.mixer == "attn" for sub in subs)
         else [])
    log(f"  params {n_par / 1e9:.2f} B, {n_bytes / 1e9:.1f} GB, made in "
        f"{time.perf_counter() - t0:.1f} s; kernels on its path: "
        + (", ".join(kernels) if kernels else
           "none (its mixers are plain torch, as the reference's are "
           "plain jnp, and it has no attention or MoE layer)"))
    rec = {"layers": cfg.num_layers, "weights_gb": n_bytes / 1e9,
           "kernels": kernels}
    try:
        ServingEngine(cfg, params, max_len=max_len,
                      serving=ServingSpec(kv="paged", kv_block=PAGED_BLOCK))
    except ValueError as e:
        log(f"  paged KV refused: {e}")
    else:
        raise AssertionError(f"{arch}: paged KV did not raise")
    ctrl = MoElessController(cfg, num_devices=8) if cfg.is_moe else None
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl)
    reqs = make_requests(cfg, FAMILY_LENS, FAMILY_GENS, slots, seed=8)
    torch.cuda.reset_peak_memory_stats()
    with GmmPaths() as paths:
        res, launches, pre_s, dec_s, _, wall = serve_timed(engine, reqs,
                                                           slots)
    check_budgets(reqs, f"{arch} request")
    if kernels:
        _check_launches(cfg, f"{arch} contiguous", launches, paths,
                        "decode_attention")
    elif any(launches.values()):
        raise AssertionError(f"{arch}: kernels launched {launches}")
    pre = {n: float(np.median(v)) * 1e3 for n, v in sorted(pre_s.items())}
    rec["contiguous"] = dict(
        launches=launches, gmm_paths=paths.counts,
        decode_ms=float(np.median(dec_s)) * 1e3, prefill_ms=pre,
        wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  contiguous: {res.generated_tokens} tokens in {res.iterations} "
        f"steps + {res.prefills} prefills at exact length, launches "
        f"{launches}, moe_gmm by path {paths.counts}; on {card}: decode "
        f"step median {rec['contiguous']['decode_ms']:.2f} ms over "
        f"{len(dec_s)}, prefill median ms by prompt length "
        f"{ {n: round(v, 2) for n, v in pre.items()} }, whole run "
        f"{wall:.2f} s, max_memory_allocated "
        f"{rec['contiguous']['peak_gb']:.2f} GB")
    if ctrl is not None and len(ctrl.plans) != \
            cfg.num_layers // cfg.moe.every_n_layers:
        raise AssertionError(f"{arch}: {len(ctrl.plans)} layer plans")
    del engine, ctrl
    prompts = [r.prompt for r in reqs]
    if kernels:
        rec["logits"] = logits_check(cfg, params, prompts, max_len, slots)
    rec["prefill_vs_forward"] = prefill_forward_check(
        cfg, params, max(prompts, key=len), max_len)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["mixers"] = {kind: mixer_identity(kind, cfg) for kind in
                     sorted({sub.mixer for sub in subs} - {"attn"})}
    torch.cuda.empty_cache()
    return rec


def family_identity(arch: str, act: str | None = None, **over) -> None:
    """A family's smoke config at float32 (`act` replaces its FFN
    activation, `over` its MoE fields): greedy tokens through the
    kernels on the contiguous cache and (an attention-only stack) on the
    paged pool with chunked prefill equal the plain path's on the
    contiguous cache, request by request, a MoE config at a drop-free
    capacity factor with a MoEless controller. Gelu experts must launch
    ``gmm`` and never ``fused_gate_up``."""
    from repro_torch import kernels as K
    from repro_torch.configs import ServingSpec, get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine
    small = get_config(arch, smoke=True).with_(dtype="float32")
    if act is not None:
        small = small.with_(act=act)
    if small.is_moe:
        over.setdefault("capacity_factor", float(small.moe.num_experts))
        small = small.with_(moe=dataclasses.replace(small.moe, **over))
        small = small.with_(num_layers=2 * small.moe.every_n_layers)
    sp = init_params(small, seed=0, device="cuda")
    got = {}
    K.reset_launch_counts()
    runs = [("contiguous", "ref", ServingSpec()),
            ("contiguous", "auto", ServingSpec()),
            ("paged chunked", "auto", ServingSpec(kv="paged", kv_block=5,
                                                  prefill_chunk=7))]
    for label, impl, spec in runs[:2] if arch in RECURRENT else runs:
        ctrl = MoElessController(small) if small.is_moe else None
        eng = ServingEngine(small, sp, max_len=64 + 24 + 1, impl=impl,
                            controller=ctrl, serving=spec)
        rs = make_requests(small, (64, 17, 40, 9, 33), (24, 7, 16), 10)
        eng.serve(rs, num_slots=4)
        got[(label, impl)] = {r.rid: list(r.tokens) for r in rs}
        base = got[("contiguous", "ref")]
        if got[(label, impl)] != base:
            bad = [i for i in base if got[(label, impl)][i] != base[i]]
            raise AssertionError(f"{arch} {over}: {label} impl={impl} "
                                 f"tokens differ for requests {bad}")
    launches = K.launch_counts()
    if act == "gelu" and (launches["gmm"] <= 0
                          or launches["fused_gate_up"] != 0):
        raise AssertionError(f"{arch} at act gelu: launches {launches}, "
                             "expected gmm and no fused_gate_up")
    layouts = "contiguous" if arch in RECURRENT else \
        "contiguous and paged chunked"
    what = dict(over, act=act) if act else over
    gelu = (f" (gmm launches {launches['gmm']}, fused_gate_up "
            f"{launches['fused_gate_up']})" if act == "gelu" else "")
    log(f"  {arch}{' ' + str(what) if what else ''}: "
        f"{sum(map(len, base.values()))} tokens: {layouts} impl=auto == "
        f"contiguous impl=ref{gelu}")


def encdec_identity() -> None:
    """whisper-base's smoke config at float32 through the fixed-batch
    API (the frame embeddings given to the prefill, which runs the
    encoder, the encoder output to every decode step): greedy tokens
    through the kernels equal the plain path's, with one
    decode-attention launch a decoder layer a step."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    small = get_config("whisper-base", smoke=True).with_(dtype="float32")
    sp = init_params(small, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, plen, steps = 4, 9, 24
    toks = torch.randint(0, small.vocab_size, (b, plen), generator=gen,
                         device="cuda")
    emb = torch.randn((b, small.encdec.encoder_seq_len, small.d_model),
                      generator=gen, device="cuda")
    got, n = {}, {}
    with torch.no_grad():
        enc_out = T.run_encoder(small, sp, emb)
        for impl in ("auto", "ref"):
            eng = ServingEngine(small, sp, max_len=plen + steps + 1,
                                impl=impl)
            K.reset_launch_counts()
            first, cache, clen = eng.prefill({"tokens": toks,
                                              "enc_embeds": emb})
            tk, _, _ = eng.decode(first, cache, clen, steps,
                                  extra={"enc_out": enc_out})
            got[impl] = torch.cat([first[:, None], tk], 1)
            n[impl] = K.launch_counts()["decode_attention"]
    if not torch.equal(got["auto"], got["ref"]):
        raise AssertionError("whisper-base smoke: kernel tokens differ from "
                             "the plain path's")
    if n != {"auto": small.num_layers * steps, "ref": 0}:
        raise AssertionError(f"whisper-base smoke: decode attention "
                             f"launches {n}")
    log(f"  whisper-base (fixed-batch API): {got['ref'].numel()} tokens: "
        f"impl=auto ({n['auto']} decode-attention launches) == impl=ref")


# ------------------------------------------------------------ phase 9

# phase 9: mixtral-8x7b trained at its published widths, TRAIN_LAYERS of
# 32 (train_reckoning: two layers do not fit the card), 8 steps of
# TokenStream batches of 8 x 256 tokens at impl="ref" (no kernel has a
# backward); then xlstm-125m at all 12 layers for 3 steps at 8 x 128
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 1, 8, 256, 8
TRAIN_LR = 3e-4     # the reference's default; 1e-3 and above diverge here
XLSTM_STEPS, XLSTM_SEQ, XLSTM_BATCH = 3, 128, 8
RESUME_STEPS, RESUME_AT = 6, 3
# phase 9 holds a step in two microbatches to the step in one, at a
# drop-free capacity factor: the loss within MB_LOSS_TOL (the two
# halves' float32 mean against the whole batch's), each leaf's gradient
# within GRAD_REL_TOL of its norm (bf16 gradients against float32 sums
# of two bf16 halves); the step without remat is held to the one with
# remat full bit for bit, in its loss and gradients
MB_LOSS_TOL, GRAD_REL_TOL = 1e-4, 5e-2


def train_reckoning(cfg) -> dict:
    """Device memory of one train step in GB, from the parameter count n
    and the largest leaf L (an expert weight stacked over periods): bf16
    weights and gradients (2n + 2n), float32 moments (8n); the
    functional AdamW update holds besides the clipped float32 gradients
    (4n), the new weights (2n) and moments (8n), and about four float32
    temporaries of the leaf it is on (16L): 26n + 16L bytes."""
    n = cfg.num_params()
    big = (cfg.num_layers // cfg.moe.every_n_layers) * cfg.moe.num_experts \
        * cfg.d_model * cfg.moe.d_ff
    return {"params_b": n / 1e9, "weights_gb": 2 * n / 1e9,
            "grads_gb": 2 * n / 1e9, "moments_gb": 8 * n / 1e9,
            "step_gb": (26 * n + 16 * big) / 1e9}


def _device_total_us(evt) -> float:
    """Device microseconds of a profiler row, its children included."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_train_step(fn) -> dict:
    """One call of `fn` (a train step) under torch.profiler: device busy
    ms, the device ms of the kernels launched inside ``make_train_step``'s
    two named ranges, and the top device operations by own device time.
    The ranges hold what the calling thread launches: the forward in
    "train_step/grads" (autograd runs the backward, remat's recompute
    included, on a device thread of its own, outside the range) and the
    optimizer update; the backward is the rest of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import _device_events, _device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges = {}
    for e in prof.key_averages():     # the range's CPU row, or its
        if e.key.startswith("train_step/"):    # device annotation
            ranges[e.key] = max(ranges.get(e.key, 0.0),
                                _device_total_us(e) / 1e3)
    kernels = sorted(((e.key, _device_us(e) / 1e3, e.count)
                      for e in _device_events(prof)
                      if not e.key.startswith("train_step/")),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    fwd = ranges.get("train_step/grads", 0.0)
    upd = ranges.get("train_step/update", 0.0)
    return {"busy_ms": busy, "forward_ms": fwd, "update_ms": upd,
            "backward_ms": busy - fwd - upd,
            "launches": sum(k[2] for k in kernels
                            if not k[0].startswith(("Memcpy", "Memset"))),
            "top": kernels[:8]}


def _train_batch(stream, step: int):
    b = stream.batch(step)
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def _step_peak(step_fn, params, state, batch):
    """(new params, first moments, metrics, peak GB) of one step from a
    reset peak; the new second moments are dropped. From zero moments
    the first moments are 0.1 x the step's gradients, in float32."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, metrics = step_fn(params, state, batch)
    torch.cuda.synchronize()
    return params, state["mu"], metrics, \
        torch.cuda.max_memory_allocated() / 1e9


def _rel_diffs(a, b) -> dict:
    """||a - b|| / ||b|| of each leaf of two trees of moments."""
    from repro_torch.training.checkpoint import leaf_paths
    return {k: float(torch.linalg.vector_norm(x - y)
                     / torch.linalg.vector_norm(y))
            for (k, x), (_, y) in zip(leaf_paths(a), leaf_paths(b))}


def training_phase(card: str) -> dict:
    """Phase 9: mixtral-8x7b trained at its published widths (1 of 32
    layers, bf16, seed 0, impl="ref") through ``train_loop.train``: the
    loss falls over 8 steps, every step routes B*S*top_k tokens a layer;
    one step profiled (forward and backward against the update); from
    the same initial weights every leaf gets a finite nonzero gradient
    and one step changes every leaf but norm scales that bf16 cannot
    move at this lr; at a drop-free capacity two microbatches give the
    step's loss and gradients (``MB_LOSS_TOL``, ``GRAD_REL_TOL``) and
    remat "none" gives them bit for bit; and
    the step at impl="auto" refuses (``fused_gate_up``
    has no backward); the trained weights serve 4 requests through the
    kernels; xlstm-125m trains at all 12 layers; a resumed run on the
    card equals the uninterrupted one bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import optimizer as O
    from repro_torch.training.checkpoint import leaf_paths
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_loop import train
    full = get_config("mixtral-8x7b")
    cfg = full.with_(num_layers=TRAIN_LAYERS, impl="ref")
    need = train_reckoning(cfg)
    log(f"  mixtral-8x7b: layers {cfg.num_layers} of {full.num_layers}, "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} "
        f"kv, {cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff} top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, {cfg.dtype}, impl ref, "
        f"remat full; {need['params_b']:.3f} B parameters: weights "
        f"{need['weights_gb']:.2f} GB, grads {need['grads_gb']:.2f}, "
        f"moments {need['moments_gb']:.2f}, a step ~{need['step_gb']:.1f} "
        f"GB by the reckoning (two layers ~"
        f"{train_reckoning(cfg.with_(num_layers=2))['step_gb']:.1f})")
    rec = {"reckoning_gb": need["step_gb"]}

    # (a) train_loop.train
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, trained = train(cfg, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, lr=TRAIN_LR, seed=0,
                         verbose=False, device="cuda")
    rec["train_s"] = time.perf_counter() - t0
    rec["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    losses = res.losses
    rec["losses"] = losses
    rec["step_ms"] = float(np.median(res.step_s)) * 1e3
    log(f"  train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, lr {TRAIN_LR} (cosine, warmup 1): losses "
        f"{[round(v, 4) for v in losses]}")
    log(f"  on {card}: step wall median {rec['step_ms']:.1f} ms (first "
        f"{res.step_s[0] * 1e3:.1f} ms), {res.steps_per_s:.3f} steps/s, "
        f"max_memory_allocated {rec['train_peak_gb']:.2f} GB (reckoned "
        f"{need['step_gb']:.1f})")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the loss did not fall: {losses}")
    want = TRAIN_BATCH * TRAIN_SEQ * cfg.moe.top_k
    for i, load in enumerate(res.expert_loads):
        if load.shape != (cfg.num_layers, cfg.moe.num_experts) or \
                (load.sum(-1) != want).any():
            raise AssertionError(f"step {i}: expert loads {load} do not "
                                 f"sum to {want} a layer")
    log(f"  every step's expert_load sums to {want} a layer; last step "
        f"{res.expert_loads[-1].tolist()}")

    # (b) one step profiled, from the trained weights
    stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0))
    opt = O.adamw(O.cosine_schedule(TRAIN_LR, warmup=1, total=TRAIN_STEPS),
                  weight_decay=0.01)
    step_fn = M.make_train_step(cfg, opt)
    state = opt.init(trained)
    batch = _train_batch(stream, TRAIN_STEPS)
    prof = profile_train_step(lambda: step_fn(trained, state, batch))
    del state
    rec["profile"] = prof
    log(f"  one step under torch.profiler on {card}: device busy "
        f"{prof['busy_ms']:.2f} ms in {prof['launches']} launches: forward "
        f"{prof['forward_ms']:.2f} ms (train_step/grads), backward with "
        f"remat's recompute {prof['backward_ms']:.2f} (the rest), optimizer "
        f"update {prof['update_ms']:.2f} (train_step/update)")
    for key, ms, n in prof["top"]:
        log(f"    {ms:9.3f} ms {n:5d}x  {key[:90]}")

    # (c) the trained weights serve through the kernels
    reqs = make_requests(cfg, (128, 256), (16, 32), 4, seed=9)
    engine = ServingEngine(cfg, trained, max_len=256 + 32 + 1, impl="auto")
    with GmmPaths() as paths:
        sres, launches, _, dec_s, _, wall = serve_timed(engine, reqs, 4)
    check_budgets(reqs, "phase 9 request")
    _check_launches(cfg, "phase 9 serving", launches, paths,
                    "decode_attention")
    rec["serve_launches"] = {k: launches[k] for k in
                             ("fused_gate_up", "gmm", "decode_attention")}
    log(f"  the trained weights served 4 requests ({sres.generated_tokens} "
        f"tokens) at impl auto: launches {rec['serve_launches']}, moe_gmm "
        f"by path {paths.counts}, decode step median "
        f"{float(np.median(dec_s)) * 1e3:.2f} ms")
    del engine, trained
    gc.collect()
    torch.cuda.empty_cache()

    # (d) from the initial weights: step 1, microbatches, remat, refusal
    p0 = M.init_params(cfg, 0, "cuda")
    st0 = opt.init(p0)
    b0 = _train_batch(stream, 0)
    p1, mu1, m1, peak_full = _step_peak(step_fn, p0, st0, b0)
    del mu1
    # AdamW's first step moves an element by lr * (1 + weight decay) at
    # most: below half a bf16 ulp under 1.0 (2^-9), a norm scale at its
    # initial 1.0 cannot move, so only such leaves may stay
    stayed = [k for (k, a), (_, b) in zip(leaf_paths(p0), leaf_paths(p1))
              if torch.equal(a, b)]
    held = TRAIN_LR * 1.01 < 2 ** -9
    frozen = [k for k in stayed if not held
              or not torch.all(dict(leaf_paths(p0))[k] == 1)]
    if frozen:
        raise AssertionError(f"parameter leaves {frozen} did not change in "
                             "step 1")
    del p1
    loss1 = float(m1["loss"])
    log(f"  step 1 from the initial weights: loss {loss1:.4f}, "
        f"{len(list(_leaves(p0))) - len(stayed)} of "
        f"{len(list(_leaves(p0)))} leaves changed; unchanged: {stayed} "
        f"(norm scales at 1.0, where lr {TRAIN_LR} x 1.01 is under half a "
        f"bf16 ulp), peak {peak_full:.2f} GB")
    # the same step at a drop-free capacity (factor E / top_k: with
    # drops, a microbatch's capacity halves with its tokens and two
    # microbatches are another function), in one microbatch with remat
    # full, in two, and without remat: the loss (bit for bit without
    # remat, within MB_LOSS_TOL in two halves) and each leaf's gradient,
    # read from the first moments (bit for bit without remat, within
    # GRAD_REL_TOL of its norm in two halves). A step over half
    # the batch, or one that drops a microbatch's gradient, is off by
    # tens of percent in every leaf's gradient
    free = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    pf, mu1, mf, peak_free = _step_peak(M.make_train_step(free, opt), p0,
                                        st0, b0)
    del pf
    loss_free = float(mf["loss"])
    if float(mf["dropped"].sum()) != 0:
        raise AssertionError(f"capacity factor "
                             f"{free.moe.capacity_factor} dropped "
                             f"{mf['dropped']}")
    log(f"  at the drop-free capacity factor {free.moe.capacity_factor}: "
        f"loss {loss_free:.6f}, peak {peak_free:.2f} GB")
    checks = {}
    held_gb = sum(t.numel() * t.element_size() for t in _leaves(mu1)) / 1e9
    for label, kw, loss_tol, grad_tol in (
            ("microbatches=2", dict(microbatches=2), MB_LOSS_TOL,
             GRAD_REL_TOL),
            ('remat="none"', dict(remat="none"), 0.0, 0.0)):
        fn = M.make_train_step(free, opt, **kw)
        pk, muk, mk, peak = _step_peak(fn, p0, st0, b0)
        del pk
        rel = _rel_diffs(muk, mu1)
        del muk
        lk = float(mk["loss"])
        worst = max(rel, key=rel.get)
        checks[label] = {"loss": lk, "peak_gb": peak, "grad_rel": rel}
        log(f"  {label}: loss {lk:.6f} (|diff| {abs(lk - loss_free):.3e}, "
            f"held to {loss_tol:.0e}), gradients off by at most "
            f"{rel[worst]:.3e} of their norm ({worst}; held to "
            f"{grad_tol:.0e}), peak {peak:.2f} GB with the first moments' "
            f"{held_gb:.2f} held, against {peak_free:.2f}")
        if abs(lk - loss_free) > loss_tol:
            raise AssertionError(f"{label}: loss {lk} against {loss_free}")
        if rel[worst] > grad_tol:
            raise AssertionError(f"{label}: gradients against one "
                                 f"microbatch with remat full: {rel}")
    del mu1
    rec["checks"] = checks
    for label, remat in (("remat none", "none"), ("remat full", "full")):
        live = O._map(lambda t: t.detach().requires_grad_(), p0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        total, _ = M.loss_fn(cfg, live, b0, remat=remat)
        grads = torch.autograd.grad(total, list(_leaves(live)))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        dead = [k for (k, _), g in zip(leaf_paths(live), grads)
                if not (torch.isfinite(g).all() and g.any())]
        if dead:   # the graph must reach every leaf (the experts too)
            raise AssertionError(f"{label}: zero or non-finite gradients "
                                 f"of {dead}")
        del live, total, grads
        rec[f"grads_peak_gb_{remat}"] = peak
        log(f"  forward+backward alone, {label}: peak {peak:.2f} GB, "
            f"every leaf's gradient finite and nonzero")
    K.reset_launch_counts()
    try:
        M.make_train_step(cfg.with_(impl="auto"), opt)(p0, st0, b0)
    except NotImplementedError as e:
        if "fused_gate_up" not in str(e):
            raise
        log(f"  impl auto under autograd refused: {e}")
    else:
        raise AssertionError("a train step at impl auto did not refuse the "
                             "kernels")
    if any(K.launch_counts().values()):
        raise AssertionError(f"the refused step launched "
                             f"{K.launch_counts()}")
    del p0, st0
    gc.collect()
    torch.cuda.empty_cache()

    # (e) xlstm-125m at all 12 layers
    xfull = get_config("xlstm-125m")
    xcfg = xfull.with_(impl="ref")
    t0 = time.perf_counter()
    xres, xp = train(xcfg, steps=XLSTM_STEPS, seq_len=XLSTM_SEQ,
                     global_batch=XLSTM_BATCH, lr=TRAIN_LR, seed=0,
                     verbose=False, device="cuda")
    del xp
    if not all(math.isfinite(v) for v in xres.losses):
        raise AssertionError(f"xlstm: non-finite loss {xres.losses}")
    rec["xlstm"] = {"losses": xres.losses,
                    "step_ms": [s * 1e3 for s in xres.step_s]}
    log(f"  xlstm-125m, {xcfg.num_layers} layers, d_model {xcfg.d_model}, "
        f"vocab {xcfg.vocab_size}: {XLSTM_STEPS} steps of {XLSTM_BATCH} x "
        f"{XLSTM_SEQ} in {time.perf_counter() - t0:.1f} s, losses "
        f"{[round(v, 4) for v in xres.losses]}; step walls on {card}: "
        f"{[round(s * 1e3, 1) for s in xres.step_s]} ms")
    gc.collect()
    torch.cuda.empty_cache()
    rec["resume"] = resume_check()
    return rec


def resume_check() -> dict:
    """The mixtral-8x7b smoke config at float32 on the card: 6 steps
    uninterrupted against 3 steps, a checkpoint, a stop and a resume to 6:
    parameters, moments and step equal bit for bit."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import train_loop as TL
    cfg = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32",
                                                        impl="ref")
    kw = dict(steps=RESUME_STEPS, seq_len=64, global_batch=4, lr=1e-2,
              seed=0, verbose=False, device="cuda")

    class Stop(Exception):
        pass

    class Stream(TL.TokenStream):
        def batch(self, step):
            if step == RESUME_AT:
                raise Stop
            return super().batch(step)

    plain = TL.TokenStream
    with tempfile.TemporaryDirectory() as tmp:
        TL.train(cfg, checkpoint_path=f"{tmp}/full", **kw)
        TL.TokenStream = Stream
        try:
            TL.train(cfg, checkpoint_path=f"{tmp}/cut",
                     checkpoint_every=RESUME_AT, **kw)
        except Stop:
            pass
        finally:
            TL.TokenStream = plain
        if CK.latest_step(f"{tmp}/cut.npz") != RESUME_AT:
            raise AssertionError("no checkpoint at the stop")
        res, _ = TL.train(cfg, checkpoint_path=f"{tmp}/cut", **kw)
        n, differ = 0, []
        for suffix in (".npz", ".opt.npz"):
            with np.load(f"{tmp}/full{suffix}") as a, \
                    np.load(f"{tmp}/cut{suffix}") as b:
                if sorted(a.files) != sorted(b.files):
                    raise AssertionError(f"resume: {suffix} keys differ")
                n += len(a.files)
                differ += [k for k in a.files
                           if not np.array_equal(a[k], b[k])]
    if len(res.losses) != RESUME_STEPS - RESUME_AT or differ:
        raise AssertionError(f"resume: {len(differ)} of {n} leaves differ "
                             f"from the uninterrupted run: {differ[:6]}")
    log(f"  resume on the card (smoke config, float32): {RESUME_AT} steps, "
        f"a checkpoint, a stop and {len(res.losses)} resumed steps equal "
        f"{RESUME_STEPS} uninterrupted ones bit for bit in all {n} leaves "
        f"(parameters, moments, step)")
    return {"leaves": n}


# ------------------------------------------------------------ phase 10

# phase 10: whisper-base at its published widths, all 6 encoder and 6
# decoder layers, through the fixed-batch API: a batch of WHISPER_BATCH
# prompts of each length in WHISPER_LENS, each decoding WHISPER_STEPS
# tokens. At float32 the prefill into a fresh cache and the first
# WHISPER_HELD decode steps after it are held to ``forward`` within
# WHISPER_FWD_TOL (max abs), and a zeroed encoder output must move the
# prefill's logits by more than WHISPER_LIVE
WHISPER_BATCH, WHISPER_LENS, WHISPER_STEPS = 8, (4, 128), 64
WHISPER_HELD, WHISPER_FWD_TOL, WHISPER_LIVE = 8, 1e-4, 0.1


class AttnPaths:
    """Within the block, counts ``decode_attention`` launches by the
    path each took: the kernel's own plan (``DA.kernel_path``) asked
    with each launch's operands. The wrapper's launch counts are
    untouched."""

    def __enter__(self):
        self.counts = {}
        self._fn = inner = DA.decode_attention

        def run(q, k, v, *args, **kw):
            path = DA.kernel_path(q, k, v)[0]
            self.counts[path] = self.counts.get(path, 0) + 1
            return inner(q, k, v, *args, **kw)

        DA.decode_attention = run
        return self

    def __exit__(self, *exc):
        DA.decode_attention = self._fn


class BlindNewest:
    """Within the block, every ``decode_attention`` launch gets each
    row's kv_len an eighth short (at least one key): a kernel that never
    sees the newest keys (the token's own among them, in a cache that
    has not wrapped), the control that a gate must reject. An eighth and
    not one key, so that the fault does not shrink as the cache grows."""

    def __enter__(self):
        self._fn = inner = DA.decode_attention

        def run(q, k, v, kv_pos, kv_len, q_pos, **kw):
            return inner(q, k, v, kv_pos,
                         kv_len - torch.clamp(kv_len // 8, min=1), q_pos,
                         **kw)

        DA.decode_attention = run
        return self

    def __exit__(self, *exc):
        DA.decode_attention = self._fn


def device_busy(fn, n: int = 3, warm: bool = True):
    """(device busy ms, its three largest device operations as (name,
    ms), device launches, the last call's result) a call of `fn`, from a
    torch.profiler trace of `n` calls after one untraced call (none
    when not `warm`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import (_device_events,
                                                   _device_us, _kernel_ms,
                                                   _launches)
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
    busy = sum(_device_us(e) for e in _device_events(prof)) / n / 1e3
    top = [(k[:48], round(ms, 4)) for k, ms in _kernel_ms(prof, n)[:3]]
    return busy, top, _launches(prof, n), out


def wall_ms(fn):
    """(result, wall ms) of one call of `fn`, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def whisper_inputs(cfg, plen: int, dtype, seed: int):
    """Seeded prompts (B, plen) and frame embeddings (B, T, D) of unit
    scale, drawn in float32 and cast to `dtype` (the float32 and bf16
    runs see the same frames, up to rounding)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH, plen),
                         generator=gen, device="cuda")
    emb = torch.randn((WHISPER_BATCH, cfg.encdec.encoder_seq_len,
                       cfg.d_model), generator=gen, device="cuda")
    return toks, emb.to(dtype)


def cross_attention_ms(cfg, params, enc_out) -> tuple[float, float, list]:
    """Device ms of one decode step's cross-attention (every decoder
    layer, one query row a prompt) with its three largest device
    operations, and the device ms of its key/value products over the
    encoder's frames alone, which the reference recomputes at every
    step."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(7)
    h = torch.randn((enc_out.shape[0], 1, cfg.d_model), generator=gen,
                    device="cuda").to(enc_out.dtype)
    xps = [T._period(params["layers"][0], i)["xattn"]
           for i in range(cfg.num_layers)]

    def xattn():
        for pa in xps:
            T._cross_attention(cfg, pa, h, enc_out)

    def kv():
        for pa in xps:
            enc_out @ pa["wk"]
            enc_out @ pa["wv"]
    with torch.no_grad():
        xa_ms, top = device_busy(xattn)[:2]
        return xa_ms, device_busy(kv)[0], top


def whisper_batch(cfg, params, plen: int, card: str) -> dict:
    """One batch of phase 10 at bf16: the encoder over the frames (wall
    and device busy), the prefill and WHISPER_STEPS decode steps through
    ``ServingEngine.prefill``/``decode`` (one decode step traced: device
    busy, launches, idle share) with every launch counted, then from the
    state after the prefill every decoder layer's self-attention
    sublayer through the kernel against the plain path (gated at the
    bf16 tolerance) and the decode step's logits compared (reported)."""
    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    toks, emb = whisper_inputs(cfg, plen, torch.bfloat16, seed=plen)
    engine = ServingEngine(cfg, params, max_len=plen + WHISPER_STEPS + 1)
    rec = {}
    with torch.no_grad():
        T.run_encoder(cfg, params, emb)             # warm-up
        enc_out, rec["encoder_wall_ms"] = wall_ms(
            lambda: T.run_encoder(cfg, params, emb))
        rec["encoder_device_ms"] = device_busy(
            lambda: T.run_encoder(cfg, params, emb), n=1)[0]
    batch = {"tokens": toks, "enc_out": enc_out}
    extra = {"enc_out": enc_out}
    engine.prefill(batch)                           # warm-up
    rec["prefill_device_ms"] = device_busy(lambda: engine.prefill(batch),
                                           n=1)[0]
    K.reset_launch_counts()
    walls, out = [], []
    with AttnPaths() as paths:
        (first, cache, clen), rec["prefill_wall_ms"] = wall_ms(
            lambda: engine.prefill(batch))
        snap = clone_tree(cache)
        cur = first
        for i in range(WHISPER_STEPS):
            step = functools.partial(engine.decode, cur, cache, clen, 1,
                                     extra=extra)
            if i == WHISPER_STEPS // 2:   # one step traced
                rec["decode_device_ms"], _, rec["decode_launches"], \
                    (tk, cache, clen) = device_busy(step, n=1, warm=False)
            else:
                (tk, cache, clen), ms = wall_ms(step)
                walls.append(ms)
            cur = tk[:, 0]
            out.append(cur)
    launches = K.launch_counts()
    want = cfg.num_layers * WHISPER_STEPS
    others = {k: v for k, v in launches.items() if k != "decode_attention"}
    if launches["decode_attention"] != want or any(others.values()):
        raise AssertionError(f"whisper {plen}-token prompts: launches "
                             f"{launches}, expected decode_attention "
                             f"{want} and nothing else")
    if paths.counts != {"mma": want}:
        raise AssertionError(f"whisper decode attention by path "
                             f"{paths.counts}, not all {want} on 'mma'")
    rec["launches"] = launches
    rec["decode_wall_ms"] = float(np.median(walls))
    rec["decode_idle_share"] = 1.0 - rec["decode_device_ms"] \
        / rec["decode_wall_ms"]
    xa_ms, kv_ms, top = cross_attention_ms(cfg, params, enc_out)
    rec.update(cross_attention_device_ms=xa_ms, kv_products_device_ms=kv_ms,
               cross_attention_share=xa_ms / rec["decode_device_ms"],
               kv_products_share=kv_ms / rec["decode_device_ms"])
    log(f"  {plen}-token prompts: {WHISPER_BATCH} x {WHISPER_STEPS} tokens, "
        f"launches {launches}, decode attention by path {paths.counts}")
    log(f"  {plen}-token prompts on {card}: encoder wall "
        f"{rec['encoder_wall_ms']:.3f} ms, device {rec['encoder_device_ms']:.3f}"
        f" ms; prefill wall {rec['prefill_wall_ms']:.3f} ms, device "
        f"{rec['prefill_device_ms']:.3f} ms; decode step wall "
        f"{rec['decode_wall_ms']:.3f} ms (median of {len(walls)}), device "
        f"busy {rec['decode_device_ms']:.3f} ms in "
        f"{rec['decode_launches']:.0f} launches, idle share "
        f"{rec['decode_idle_share']:.3f}; cross-attention {xa_ms:.3f} "
        f"device ms a step ({rec['cross_attention_share']:.3f} of the "
        f"step), its key/value products over "
        f"{cfg.encdec.encoder_seq_len} frames {kv_ms:.3f} ms "
        f"({rec['kv_products_share']:.3f} of the step); cross-attention's "
        f"largest device operations (ms a step) {top}")
    name = f"whisper decode step after {plen}-token prompts"
    with torch.no_grad():
        nxt = first[:, None]
        rec["sublayers"] = sublayer_check(name, cfg, params, nxt, snap, plen,
                                          None, enc_out=enc_out)
        with BlindNewest():
            try:
                sublayer_check(f"{name}, control: a kernel blind to the "
                               "newest eighth of the keys", cfg, params,
                               nxt, snap, plen,
                               None, enc_out=enc_out)
            except AssertionError as e:
                log(f"  the gate rejects the control: {e}")
            else:
                raise AssertionError("the bf16 sublayer gate let a kernel "
                                     "blind to the newest eighth of the "
                                     "keys through")
        # the real vocabulary only: the padded entries hold -1e9
        v = cfg.vocab_size
        outs = [T.decode_step(c, params, {"tokens": nxt, **extra},
                              clone_tree(snap), plen)[0][:, -1, :v]
                for c in (cfg, cfg.with_(impl="ref"))]
        rec["logits"] = compare_logits(f"{name} (reported, not gated)",
                                       outs[0], outs[1], None, None)
    rec["tokens"] = torch.stack(out, 1)
    return rec


def whisper_float32(card: str) -> dict:
    """Phase 10 at float32 (TF32 off): each batch's greedy tokens through
    the kernels (decode attention on "simt" at float32) equal the plain
    path's; a prefill into a fresh cache and the first WHISPER_HELD
    decode steps after it give ``forward``'s logits on the same sequence
    (with the frame embeddings) within WHISPER_FWD_TOL; a zeroed encoder
    output moves the prefill's logits by more than WHISPER_LIVE."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("whisper-base").with_(dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    rec = {}
    for plen in WHISPER_LENS:
        toks, emb = whisper_inputs(cfg, plen, torch.float32, seed=plen)
        got, paths = {}, {}
        with torch.no_grad():
            enc_out = T.run_encoder(cfg, params, emb)
            for impl in ("auto", "ref"):
                eng = ServingEngine(cfg, params, impl=impl,
                                    max_len=plen + WHISPER_STEPS + 1)
                K.reset_launch_counts()
                with AttnPaths() as ap:
                    first, cache, clen = eng.prefill(
                        {"tokens": toks, "enc_out": enc_out})
                    tk, _, _ = eng.decode(first, cache, clen, WHISPER_STEPS,
                                          extra={"enc_out": enc_out})
                got[impl] = torch.cat([first[:, None], tk], 1)
                paths[impl] = ap.counts
        want = cfg.num_layers * WHISPER_STEPS
        if paths != {"auto": {"simt": want}, "ref": {}}:
            raise AssertionError(f"whisper float32 decode attention by "
                                 f"path {paths}")
        if not torch.equal(got["auto"], got["ref"]):
            bad = (got["auto"] != got["ref"]).any(1).nonzero().flatten()
            raise AssertionError(f"whisper float32 {plen}-token prompts: "
                                 f"tokens differ in rows {bad.tolist()}")
        seq = torch.cat([toks, got["ref"][:, :WHISPER_HELD]], 1)
        errs = []
        with torch.no_grad():
            fwd, _ = T.forward(cfg, params, {"tokens": seq,
                                             "enc_embeds": emb})
            cache = T.init_cache(cfg, params, WHISPER_BATCH,
                                 plen + WHISPER_HELD)
            lg, cache, _ = T.decode_step(
                cfg, params, {"tokens": toks, "enc_out": enc_out}, cache, 0)
            errs.append(float((lg - fwd[:, :plen]).abs().max()))
            for i in range(WHISPER_HELD):
                p = plen + i
                lgi, cache, _ = T.decode_step(
                    cfg, params, {"tokens": seq[:, p:p + 1],
                                  "enc_out": enc_out}, cache, p)
                errs.append(float((lgi[:, 0] - fwd[:, p]).abs().max()))
            blind, _, _ = T.decode_step(
                cfg, params, {"tokens": toks,
                              "enc_out": torch.zeros_like(enc_out)},
                T.init_cache(cfg, params, WHISPER_BATCH, plen), 0)
            live = float((blind - lg).abs().max())
        if max(errs) > WHISPER_FWD_TOL:
            raise AssertionError(f"whisper float32 {plen}-token prompts: "
                                 f"decode vs forward max |diff| {errs} "
                                 f"beyond {WHISPER_FWD_TOL}")
        if live <= WHISPER_LIVE:
            raise AssertionError(f"whisper float32: a zeroed enc_out moved "
                                 f"the logits by {live:.3e} only")
        rec[plen] = {"forward_errs": errs, "zeroed_enc_out_moves": live}
        log(f"  float32, {plen}-token prompts: {WHISPER_BATCH} x "
            f"{WHISPER_STEPS + 1} greedy tokens through the kernels "
            f"({want} decode-attention launches on 'simt') == plain; "
            f"prefill into a fresh cache vs forward max |diff| "
            f"{errs[0]:.3e}, the next {WHISPER_HELD} decode steps "
            f"{max(errs[1:]):.3e} (limit {WHISPER_FWD_TOL}); a zeroed "
            f"enc_out moves the prefill logits by {live:.3e} (limit "
            f"> {WHISPER_LIVE})")
    del params
    torch.cuda.empty_cache()
    return rec


def whisper_phase(card: str) -> dict:
    """Phase 10: whisper-base at its published widths (6 encoder and 6
    decoder layers, no depth cut) from a seed at bf16: the refusals of
    continuous batching and paged KV, then each batch of
    ``whisper_batch``; then ``whisper_float32``. Returns the phase's
    record."""
    from repro_torch.configs import ServingSpec, get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("whisper-base")
    log(f"  whisper-base: {cfg.encdec.num_encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers (all), d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} kv, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, {cfg.act}, {cfg.norm}, "
        f"rope {cfg.rope}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.encdec.encoder_seq_len} frames, "
        f"{cfg.dtype}")
    params = init_params(cfg, seed=0, device="cuda")
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"  params {n_par / 1e6:.2f} M (the reference's layout: the head "
        f"is not tied to the embedding), {n_par * 2 / 1e6:.1f} MB")
    engine = ServingEngine(cfg, params, max_len=64)
    try:
        engine.start()
        raise AssertionError("start() opened a session for an enc-dec model")
    except NotImplementedError as e:
        log(f"  start() refused: {e}")
    try:
        ServingEngine(cfg, params, max_len=64,
                      serving=ServingSpec(kv="paged"))
        raise AssertionError("paged KV accepted an enc-dec model")
    except ValueError as e:
        log(f"  paged KV refused: {e}")
    torch.cuda.reset_peak_memory_stats()
    rec = {"params": n_par}
    for plen in WHISPER_LENS:
        rec[plen] = whisper_batch(cfg, params, plen, card)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  max_memory_allocated {rec['peak_gb']:.3f} GB")
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()
    rec["float32"] = whisper_float32(card)
    return rec


# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 11

# the worlds of phase 11: local ranks on cuda:0 (NCCL refuses two ranks on
# one device; gloo carries the barriers, the card's tensors move through
# the ranks' shared staging buffers), each holding the replicated non-expert layers
# and its own slice of the expert slot banks. mixtral-8x7b at its
# published widths, 1 layer of 32 (2 in W3): each rank holds the layer's
# experts, their padded source bank and its slot banks, and four ranks
# share the one card. 8 requests at t=0, 128-token prompts, 32 new
# tokens, greedy. The session controller is MoElessController(
# num_devices=2, slots_per_device=8): 16 slots, 4 a rank at ep=4. With
# 8 slots a logical device = E no allocation can fail, which 2 slots on
# each of 8 devices cannot promise (the runtime runs out of slots within
# this burst: the modeled clock spans far less than the 60 s keep-alive).
MR_PROMPT, MR_GEN, MR_REQS, MR_SLOTS = 128, 32, 8, 8
MR_DEVICES, MR_SLOTS_PER_DEVICE = 2, 8
MR_GATE_ROWS, MR_GATE_LEN = 8, 16      # the layer gates' fixed input
MR_WORLDS = {
    # name: (data, ep, tp), dtype, layers, slot dtype, double buffer,
    # impl, decode steps (None: every request to its budget)
    "W1": dict(degrees=(1, 4, 1), dtype="bfloat16", layers=1,
               slot_dtype="fp32", double_buffer=True, impl="auto",
               gen=MR_GEN, control=True, transport=True),
    # float32: four ranks of experts + padded bank + one 4-slot bank is
    # ~16.6 GB a rank; a second bank would not leave the card room
    "W2": dict(degrees=(1, 4, 1), dtype="float32", layers=1,
               slot_dtype="fp32", double_buffer=False, impl="cuda",
               gen=MR_GEN, control=True),
    "W3": dict(degrees=(1, 2, 2), dtype="bfloat16", layers=2,
               slot_dtype="int8", double_buffer=True, impl="auto",
               gen=8, control=False),
}


def mr_config(w: dict):
    from repro_torch.configs import get_config
    full = get_config("mixtral-8x7b")
    return full.with_(num_layers=w["layers"], dtype=w["dtype"],
                      impl=w["impl"], moe=dataclasses.replace(
                          full.moe, slot_dtype=w["slot_dtype"]))


def mr_reckoning_gb(cfg, w: dict) -> float:
    """Device bytes a rank should hold: the layers' own experts, their
    padded source bank (E + 1 experts, this rank's tp slice), its slot
    banks (one or two), attention, embeddings and head."""
    d, f, e = cfg.d_model, cfg.moe.d_ff, cfg.moe.num_experts
    data, ep, tp = w["degrees"]
    el = 4 if cfg.dtype == "float32" else 2
    expert = 3 * d * f * el
    slot = 3 * d * f + 2 * d * 4 + f * 4 if w["slot_dtype"] == "int8" \
        else expert
    per_rank_slots = MR_DEVICES * MR_SLOTS_PER_DEVICE // ep
    banks = 2 if w["double_buffer"] else 1
    hd = cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * el
    layer = e * expert + (e + 1) * slot / tp \
        + banks * per_rank_slots * slot / tp + attn
    return (cfg.num_layers * layer + 2 * cfg.vocab_size * d * el) / 1e9


def mr_tables(cfg, ep: int):
    """A replicated plan over the 16 slots (the layer gates' routing):
    loads drawn from a seed, scaled to 16 replicas and placed on 8
    logical devices, projected onto `ep` ranks."""
    from repro_torch.core.placer import place_layer
    from repro_torch.core.scaler import scale_layer
    from repro_torch.distributed import ep as EP
    e = cfg.moe.num_experts
    loads = np.random.default_rng(11).integers(1, 100, e).astype(float)
    plan = place_layer(loads, scale_layer(loads, max_total_replicas=16), 8)
    return EP.plan_to_tables(plan, ep=ep, slots_per_device=16 // ep,
                             num_devices=8)


def mr_layer(cfg, params, mesh):
    """Layer 0's MoE through the EP slot plane on one fixed input (8 rows
    x 16 tokens, seeded on the card): (output on the host, loads,
    dropped). `mesh` None is the one-rank plane."""
    from repro_torch.distributed import ep as EP
    from repro_torch.kernels import quant as QT
    ep = 1 if mesh is None else mesh.shape["ep"]
    moe = params["layers"][0]["moe"]
    w = {k: v[0] for k, v in moe["experts"].items()}
    if cfg.moe.slot_dtype == "int8":
        w = QT.quantize_expert_bank(w)
    tables = mr_tables(cfg, ep)
    slot_w = EP.materialise_slots(w, tables["slot_expert"], mesh=mesh)
    del w
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((MR_GATE_ROWS, MR_GATE_LEN, cfg.d_model),
                    generator=gen, device="cuda").to(getattr(torch,
                                                             cfg.dtype))
    y, m = EP.moe_ep_layer(
        x, moe["router"]["w_gate"][0], slot_w, tables,
        num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        slots_per_device=16 // ep, capacity_factor=cfg.moe.capacity_factor,
        impl=cfg.impl, mesh=mesh)
    torch.cuda.synchronize()
    return (y.float().cpu(), m["expert_load"].cpu().tolist(),
            float(m["dropped"]))


class FfnTimer:
    """Within the block, CUDA events around every expert FFN call of the
    EP slot plane (``ops.expert_ffn_impl`` and its int8 form): device
    ms a call, read after the block."""

    def __enter__(self):
        from repro_torch.kernels import ops as KOPS
        self.ops, self.events, self.on = KOPS, [], False
        self._fns = (KOPS.expert_ffn_impl, KOPS.expert_ffn_quant_impl)

        def wrap(inner):
            def run(*a, **kw):
                if not self.on:
                    return inner(*a, **kw)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = inner(*a, **kw)
                e.record()
                self.events.append((s, e))
                return out
            return run

        KOPS.expert_ffn_impl, KOPS.expert_ffn_quant_impl = map(wrap,
                                                              self._fns)
        return self

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def __exit__(self, *exc):
        self.ops.expert_ffn_impl, self.ops.expert_ffn_quant_impl = self._fns


def mr_serve(cfg, params, mesh, w: dict, gen: int):
    """The burst through ``ServingEngine(mesh=...)`` with the expert
    runtime on: tokens, each iteration's expert loads and drops, the
    runtime's meters, the modeled latencies, this rank's kernel launches,
    its bytes written, its decode step wall, its expert FFN device ms and
    each collective's host ms a decode step a layer."""
    from repro_torch.serving.engine import MoElessController, ServingEngine

    class Recording(MoElessController):
        """Keeps every iteration's loads and drops as the engine hands
        them over."""

        def step(self, t, gate_inputs, actual_loads, token_mask=None,
                 **kw):
            d = kw.get("dropped")
            self.seen.append((actual_loads.cpu().tolist(),
                              None if d is None else d.cpu().tolist()))
            return super().step(t, gate_inputs, actual_loads, token_mask,
                                **kw)

    reqs = make_requests(cfg, (MR_PROMPT,), (gen,), MR_REQS, seed=5)
    ctrl = Recording(cfg, num_devices=MR_DEVICES,
                     slots_per_device=MR_SLOTS_PER_DEVICE)
    ctrl.seen = []
    eng = ServingEngine(cfg, params, max_len=MR_PROMPT + MR_GEN + 1,
                        expert_runtime="on", mesh=mesh,
                        runtime_double_buffer=w["double_buffer"])
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.start(num_slots=MR_SLOTS, control=ctrl, requests=reqs)
    eng.step()                       # the 8 prefills and one decode step
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if mesh is not None:
        mesh.host_ms.clear()
    steps = []
    with FfnTimer() as ffn:
        ffn.on = True
        while eng.has_work:
            _, ms = wall_ms(eng.step)
            steps.append(ms)
        ffn_ms = ffn.ms()
    res = eng.result()
    st = dataclasses.asdict(res.runtime.finalize(res.clock_s))
    n_layers = cfg.num_layers
    return {
        "tokens": [list(map(int, r.tokens)) for r in reqs],
        "loads": [s[0] for s in ctrl.seen],
        "dropped": [s[1] for s in ctrl.seen],
        "stats": st, "clock": res.clock_s, "iterations": res.iterations,
        "records": sorted(map(dataclasses.astuple, res.records)),
        "launches": K.launch_counts(),
        "local_bytes": res.runtime.local_bytes,
        "first_step_s": first_s,
        "decode_ms": float(np.median(steps)) if steps else 0.0,
        "decode_steps": len(steps),
        "ffn_ms": float(np.median(ffn_ms)) if ffn_ms else 0.0,
        "collective_ms": {k: v / max(1, len(steps)) / n_layers for k, v in
                          (mesh.host_ms.items() if mesh else ())},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def mr_transport(cfg, mesh, n: int = 10) -> dict:
    """Host ms of one scatter all-to-all at a 128-token prefill's send
    buffer (ep x slots_per_rank*cap rows x D), through the card's shared
    staging buffers against the same buffer through gloo in host memory, in
    turns (native, staged, staged, native), `n` calls each."""
    ep = mesh.shape["ep"]
    cap = math.ceil(cfg.moe.capacity_factor * cfg.moe.top_k * MR_PROMPT
                    / cfg.moe.num_experts)
    spr = MR_DEVICES * MR_SLOTS_PER_DEVICE // ep
    x = torch.randn((ep, spr * cap, cfg.d_model), device="cuda").to(
        getattr(torch, cfg.dtype))

    def native():
        return mesh.all_to_all(x, "ep")

    def staged():
        return mesh.all_to_all(x.cpu(), "ep").to(x.device)

    if not torch.equal(native(), staged()):
        raise AssertionError("gloo's all-to-all differs from the shared "
                             "buffers'")
    times = {"native": [], "staged": []}
    for name in ("native", "staged", "staged", "native"):
        fn = native if name == "native" else staged
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / n)
    return {"mb": x.numel() * x.element_size() / 1e6,
            **{k: float(np.mean(v)) for k, v in times.items()}}


@dataclasses.dataclass
class BlindGather(ServingMesh):
    """The control of phase 11's gates: rank 1 takes part in every
    collective but keeps its own input in place of the gather
    all-to-all's output (every second floating all-to-all of a layer),
    so its tokens are combined from the wrong ranks' expert outputs."""
    n: int = 0

    @classmethod
    def of(cls, mesh: ServingMesh) -> "BlindGather":
        return cls(**{f.name: getattr(mesh, f.name)
                      for f in dataclasses.fields(mesh)})

    def all_to_all(self, x, group: str):
        out = super().all_to_all(x, group)
        if not x.is_floating_point():
            return out
        self.n += 1
        return x if self.n % 2 == 0 and self.rank == 1 else out


def mr_world(rank: int, name: str) -> dict:
    """One rank of world `name` (``MR_WORLDS``), its process group up:
    the layer gate (and its control), then the burst (and the control's
    burst). Everything returned lives on the host."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = MR_WORLDS[name]
    data, ep, tp = w["degrees"]
    mesh = make_serving_mesh(ep=ep, tp=tp, data=data, device="cuda:0",
                             transport="shared")
    cfg = mr_config(w)
    params = init_params(cfg, seed=0, device="cuda")
    out = {"rank": rank, "coords": list(mesh.coords),
           "layer": mr_layer(cfg, params, mesh)}
    if w["control"]:
        out["control_layer"] = mr_layer(cfg, params, BlindGather.of(mesh))
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = mr_serve(cfg, params, mesh, w, w["gen"])
    if w.get("transport"):
        out["transport"] = mr_transport(cfg, mesh)
    if w["control"] and cfg.dtype == "float32":
        gc.collect()
        torch.cuda.empty_cache()
        out["control_serve"] = mr_serve(cfg, params, BlindGather.of(mesh),
                                        w, w["gen"] // 4)
    return out


def mr_single(name: str) -> dict:
    """The one-rank (1, 1, 1) counterparts of world `name`, in this
    process: the layer gate's output and the burst."""
    from repro_torch.models.model import init_params
    w = MR_WORLDS[name]
    cfg = mr_config(w)
    params = init_params(cfg, seed=0, device="cuda")
    out = {"layer": mr_layer(cfg, params, None)}
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = mr_serve(cfg, params, None, w, w["gen"])
    if w["control"] and cfg.dtype == "float32":
        out["short_serve"] = mr_serve(cfg, params, None, w, w["gen"] // 4)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stats_core(st: dict) -> dict:
    """The runtime's meters but ``rank_bytes`` (keyed by the mesh's
    ranks)."""
    return {k: v for k, v in st.items() if k != "rank_bytes"}


def ep_phase(card: str) -> dict:
    """Phase 11: multi-rank EP on the card (``MR_WORLDS``). Returns each
    world's per-rank launch counts."""
    from repro_torch.launch.mesh import spawn_local
    t11 = time.perf_counter()
    out = {}
    for name, w in MR_WORLDS.items():
        data, ep, tp = w["degrees"]
        cfg = mr_config(w)
        # bf16 worlds (int8 banks too) at the bf16 tolerance
        tol = TOL[getattr(torch, cfg.dtype)]
        log(f"  {name}: (data, ep, tp) = {w['degrees']}, {cfg.dtype}, "
            f"slot banks {w['slot_dtype']}, {cfg.num_layers} of 32 layers, "
            f"{'double' if w['double_buffer'] else 'single'}-buffered, "
            f"impl {w['impl']}; {MR_REQS} requests x {MR_PROMPT}-token "
            f"prompts, {w['gen']} new tokens")
        t0 = time.perf_counter()
        one = mr_single(name)
        t1 = time.perf_counter()
        n = data * ep * tp
        ranks = spawn_local(mr_world, n, backend="gloo", args=(name,),
                            wall_s=600.0, start_method=START_METHOD)
        t2 = time.perf_counter()
        log(f"    (1,1,1) in this process {t1 - t0:.1f} s; {n} ranks "
            f"{ON_CARD} {t2 - t1:.1f} s")
        # the layer gate: every rank returns the whole batch, all equal
        y1, l1, d1 = one["layer"]
        for r in ranks:
            if not torch.equal(r["layer"][0], ranks[0]["layer"][0]):
                raise AssertionError(f"{name}: rank {r['rank']}'s layer "
                                     "output differs from rank 0's")
        err = check(f"{name} layer, {n} ranks vs 1", ranks[0]["layer"][0],
                    y1, getattr(torch, cfg.dtype))
        same = ranks[0]["layer"][1] == l1 and ranks[0]["layer"][2] == d1
        log(f"    layer gate: max |{n} ranks - 1 rank| = {err:.3e} "
            f"(atol=rtol={tol}); loads and drops "
            f"{'equal' if same else 'DIFFER'}: {ranks[0]['layer'][1]} "
            f"dropped {ranks[0]['layer'][2]}")
        if w["control"]:
            yc = ranks[0]["control_layer"][0]
            cerr = float((yc - y1).abs().max())
            if torch.allclose(yc, y1, atol=tol, rtol=tol):
                raise AssertionError(f"{name}: the blind-gather control "
                                     f"passed the layer gate ({cerr:.3e})")
            log(f"    control (rank 1 keeps its gather input): max err "
                f"{cerr:.3e}, fails the gate as it must")
        s1 = one["serve"]
        per_rank = []
        for r in ranks:
            s = r["serve"]
            e_idx = r["coords"][1]
            share = s["stats"]["rank_bytes"][f"rank{e_idx}"]
            if s["local_bytes"] * tp != share and w["slot_dtype"] == "fp32":
                raise AssertionError(
                    f"{name} rank {r['rank']}: wrote {s['local_bytes']} "
                    f"bytes x tp {tp} != its rank_bytes share {share}")
            for k_name in ("fused_gate_up", "gmm") if w["slot_dtype"] == \
                    "fp32" else ("fused_gate_up_quant", "gmm_quant"):
                if s["launches"][k_name] <= 0:
                    raise AssertionError(f"{name} rank {r['rank']}: "
                                         f"{k_name} never launched")
            if s["launches"]["decode_attention"] <= 0:
                raise AssertionError(f"{name} rank {r['rank']}: "
                                     "decode_attention never launched")
            for k in ("tokens", "loads", "dropped", "stats", "records",
                      "clock"):
                if s[k] != ranks[0]["serve"][k]:
                    raise AssertionError(f"{name}: rank {r['rank']}'s {k} "
                                         "differ from rank 0's")
            per_rank.append(s)
        s0 = ranks[0]["serve"]
        agree = {
            "tokens": s0["tokens"] == s1["tokens"],
            "loads": s0["loads"] == s1["loads"],
            "dropped": s0["dropped"] == s1["dropped"],
            "counters": _stats_core(s0["stats"]) == _stats_core(s1["stats"]),
            "rank_bytes_sum": math.isclose(
                sum(s0["stats"]["rank_bytes"].values()),
                s1["stats"]["rank_bytes"]["rank0"]),
            "modeled_latencies": s0["records"] == s1["records"],
        }
        same_tok = sum(a == b for a, b in zip(s0["tokens"], s1["tokens"]))
        log(f"    against (1,1,1): {agree}; {same_tok} of {MR_REQS} "
            "requests' tokens equal")
        if cfg.dtype == "float32":
            bad = [k for k, v in agree.items() if not v]
            if bad:
                raise AssertionError(f"{name}: float32 {bad} differ from "
                                     "the (1,1,1) session")
            c = ranks[0]["control_serve"]
            short = one["short_serve"]
            if c["tokens"] == short["tokens"] and c["loads"] == \
                    short["loads"]:
                raise AssertionError(f"{name}: the blind-gather control "
                                     "served the same tokens and loads")
            diff = sum(a != b for a, b in zip(c["tokens"], short["tokens"]))
            log(f"    control: {diff} of {MR_REQS} requests' tokens differ "
                "from (1,1,1)'s")
        log(f"    runtime: transfers {s0['stats']['transfers']}, "
            f"bytes {s0['stats']['bytes_moved']:.0f}, rank_bytes "
            f"{s0['stats']['rank_bytes']}; each rank wrote "
            f"{[s['local_bytes'] for s in per_rank]} (x tp {tp})")
        for r, s in zip(ranks, per_rank):
            log(f"    rank {r['rank']} {r['coords']}: launches "
                f"{ {k: v for k, v in s['launches'].items() if v} }; peak "
                f"{s['peak_gb']:.2f} GB (reckoned "
                f"{mr_reckoning_gb(cfg, w):.2f}); decode step "
                f"{s['decode_ms']:.2f} ms wall over {s['decode_steps']}; "
                f"expert FFN {s['ffn_ms']:.4f} ms device a step; "
                f"collectives host ms a step a layer "
                f"{ {k: round(v, 3) for k, v in s['collective_ms'].items()} }")
        if w.get("transport"):
            tr = [r["transport"] for r in ranks]
            log(f"    one scatter all-to-all of {tr[0]['mb']:.2f} MB a rank, "
                f"host ms, in turns: the card's shared staging buffers "
                f"{[round(t['native'], 3) for t in tr]}, gloo through "
                f"host memory {[round(t['staged'], 3) for t in tr]}")
        log(f"    (1,1,1): decode step {s1['decode_ms']:.2f} ms wall, expert "
            f"FFN {s1['ffn_ms']:.4f} ms device, peak {s1['peak_gb']:.2f} GB; "
            f"on {card}")
        out[name] = {"launches": [s["launches"] for s in per_rank],
                     "seconds": t2 - t0}
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
    return out


# ------------------------------------------------------------ phase 12

# phase 12 (b): mixtral-8x7b at its published widths, phase 9's one of
# 32 layers and TokenStream batches of 8 x 256, bf16, impl "ref",
# trained by ZeRO-2 over two data ranks sharing cuda:0, two
# microbatches, two steps, against the one-process step at dispatch
# groups 2, held to phase 9's MB_LOSS_TOL and GRAD_REL_TOL at its
# drop-free capacity factor (E / top_k), as phase 9's microbatch rule
# is: a rank's products run on half the rows, so bf16 rounds some
# router scores otherwise, and a route that flips in and out of a
# capacity moves the loss by ~1e-4 (1.2e-4 at step 2 at the default
# 1.25 on an H100, PERF.md)
Z2_RANKS, Z2_MB, Z2_STEPS = 2, 2, 2
# phase 12 (c): a Mamba mixer at jamba-v0.1-52b's published widths over
# MAMBA_SEQ tokens, forward and backward, each lever against the default
# path; float32 held to MAMBA_TOL (atol = rtol; the levers only reorder
# float32 sums), bf16 reported
MAMBA_SEQ, MAMBA_TOL = 512, 1e-4


def dryrun_sweep(card: str) -> dict:
    """Phase 12 (a): ``launch.dryrun.run_one`` for every arch x input
    shape on the 16x16 logical mesh, on the meta device, the meta runs
    spread over the host's cores (``launch.dryrun.sweep``): every
    combination builds, nothing is allocated on the card (this
    process's allocation unchanged, no worker initialised CUDA), flops
    and peak bytes a rank are positive, and a train step counts at
    least 6 x active parameters x tokens operations over the mesh, the
    parameters an untied embedding table holds left out (a lookup
    reads them and does no operation)."""
    from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
    from repro_torch.launch import dryrun as D
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    jobs = min(8, os.cpu_count() or 1)
    results, failures = D.sweep(
        [(a, s) for a in list_archs() for s in INPUT_SHAPES], jobs=jobs,
        save=False, verbose=False, start_method=START_METHOD)
    if failures:
        raise AssertionError(f"{len(failures)} dry-run combinations "
                             f"failed: {[f[:2] for f in failures]}")
    rows = {}
    for r in results:
        arch, shape_name = r["arch"], r["shape"]
        shape = INPUT_SHAPES[shape_name]
        if r["count_touched_cuda"]:
            raise AssertionError(f"{arch} x {shape_name}: a meta run's "
                                 "process initialised CUDA")
        ratio = None
        if shape.kind == "train":
            # 6 N T over the parameters a product reads: an untied
            # embedding table is only looked up (no operation), which at
            # xlstm-125m's size is 31% of the parameters
            cfg = get_config(arch)
            lookup = 0 if cfg.tie_embeddings else cfg.padded_vocab * \
                cfg.d_model
            tokens = shape.global_batch * shape.seq_len
            floor = 6 * (r["active_params"] - lookup) * tokens
            ratio = r["flops_global"] / floor
            raw = r["flops_global"] / (6 * r["active_params"] * tokens)
            if ratio < 1:
                raise AssertionError(f"{arch} x {shape_name}: "
                                     f"{r['flops_global']:.4e} operations "
                                     f"< 6 N T = {floor:.4e}")
        if not (r["flops"] > 0 and r["peak_bytes_per_device"] > 0):
            raise AssertionError(f"{arch} x {shape_name}: {r}")
        rows[f"{arch} {shape_name}"] = r
        log(f"  {arch:<26} {shape_name:<11} flops/rank "
            f"{r['flops']:.4e}" + (f" ({ratio:.3f} x 6NT without the "
                                   f"lookup table, {raw:.3f} with it)"
                                   if ratio else "") +
            f", peak/rank {r['peak_bytes_per_device'] / 1e9:.3f} GB, "
            f"bytes/rank {r['bytes_accessed']:.4e}, build "
            f"{r['build_s']:.2f} s ({r['count_corners']} meta runs)")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    free1 = torch.cuda.mem_get_info()[0]
    if after != before:
        raise AssertionError(f"the dry-run sweep allocated "
                             f"{after - before} bytes on the card")
    sweep_s = time.perf_counter() - t0
    log(f"  {len(rows)} combinations built and counted in {sweep_s:.1f} s "
        f"on the meta device ({jobs} processes, "
        f"{sum(r['build_s'] for r in results):.1f} s of meta runs); "
        f"memory_allocated {before} -> {after} bytes, the card's free "
        f"bytes {free0} -> {free1}; no process but this one initialised "
        "CUDA")
    return {"seconds": sweep_s, "rows": rows}


def zero2_reckoning(cfg) -> dict:
    """Device bytes of a ZeRO-2 rank at dp = Z2_RANKS, from the parameter
    count n and the largest leaf L, as ``train_reckoning``: bf16 weights
    (2n, replicated), float32 accumulator, first and second moments
    sharded (4n/dp each); the update adds the clipped float32 shards
    (4n/dp), the new moments (8n/dp), the new weight shards (2n/dp) and
    about four float32 temporaries of the largest shard (16L/dp); the
    resident state between steps is the weights and the moments."""
    n, dp = cfg.num_params(), Z2_RANKS
    big = (cfg.num_layers // cfg.moe.every_n_layers) * cfg.moe.num_experts \
        * cfg.d_model * cfg.moe.d_ff
    return {"resident_gb": (2 * n + 8 * n / dp) / 1e9,
            "step_gb": (2 * n + 26 * n / dp + 16 * big / dp) / 1e9}


def _ulp_bf16(t):
    """One bf16 ulp at each element of `t` (2^(e - 8) for |t| in
    [2^(e-1), 2^e))."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _z2_batches(cfg):
    from repro_torch.training.data import DataConfig, TokenStream
    stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0))
    return [{k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
            for i in range(Z2_STEPS)]


def _z2_setup():
    from repro_torch.configs import get_config
    from repro_torch.training import optimizer as O
    cfg = get_config("mixtral-8x7b").with_(num_layers=TRAIN_LAYERS,
                                           impl="ref")
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    opt = O.adamw(TRAIN_LR, weight_decay=0.01)
    return cfg, opt, _z2_batches(cfg)


def _host(tree):
    from repro_torch.training.optimizer import _map
    return _map(lambda t: t.detach().to("cpu"), tree)


def z2_oracle(groups: int = Z2_RANKS, steps: int = Z2_STEPS) -> dict:
    """The one-process step at dispatch groups `groups` in this process:
    step 1's float32 gradients, each of `steps` steps' loss and metrics,
    all in host memory."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg, opt, batches = _z2_setup()
    batches = batches[:steps]
    T.set_moe_dispatch_groups(groups)
    try:
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        step = M.make_train_step(cfg, opt, microbatches=Z2_MB)
        dev = [{k: v.cuda() for k, v in b.items()} for b in batches]
        _, g = step.grads(params, dev[0])
        out = {"grads": _host(g), "steps": []}
        del g
        state = opt.init(params)
        for i, b in enumerate(dev):
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            out["steps"].append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                                 "loss": float(m["loss"]),
                                 "aux_loss": float(m["aux_loss"]),
                                 "expert_load": m["expert_load"].tolist(),
                                 "dropped": m["dropped"].tolist()})
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["n_f32_bytes"] = sum(4 * t.numel() for t in _leaves(params))
        del params, state, step
    finally:
        T.set_moe_dispatch_groups(1)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def z2_loss_at(params_host, i: int, groups: int = Z2_RANKS) -> float:
    """The one-process step's loss (dispatch groups `groups`) at
    `params_host` on batch `i`."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import _map
    cfg, opt, batches = _z2_setup()
    T.set_moe_dispatch_groups(groups)
    try:
        params = _map(lambda t: t.cuda(), params_host)
        step = M.make_train_step(cfg, opt, microbatches=Z2_MB)
        m, g = step.grads(params, {k: v.cuda()
                                   for k, v in batches[i].items()})
        loss = float(m["loss"])
        del g, params, step
    finally:
        T.set_moe_dispatch_groups(1)
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _ranks_agree(params) -> bool:
    """Every leaf of rank 0's `params` equals this rank's, one leaf at a
    time through a broadcast over the world."""
    import torch.distributed as dist
    same = True
    for t in _leaves(params):
        ref = t.clone()
        dist.broadcast(ref, src=0)
        same &= bool(torch.equal(ref, t))
        del ref
    flag = torch.tensor([int(same)], device=params["embed"].device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def z2_rank(rank: int, tmp: str) -> dict:
    """One ZeRO-2 rank of phase 12 (b), its process group up: step 1 as
    its two halves (the accumulator kept), step 2 whole; the bytes it
    holds against ``launch.dryrun.build_step``'s shardings on the same
    mesh. Its step-1 accumulator shards (and rank 0's step-1 weights) go
    to files in `tmp` (a pipe would take minutes for their 3.4 GB);
    everything returned lives on the host."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg, opt, batches = _z2_setup()
    mesh = make_process_mesh(Z2_RANKS, 1, device="cuda:0",
                             transport="shared")
    T.set_moe_dispatch_groups(Z2_RANKS)
    params = init_params(cfg, seed=0, device="cuda")
    gs = SH.params_shardings(params, mesh, fsdp=True)
    state = opt.init(SH.shard_tree(params, gs))
    step = M.make_train_step(cfg, opt, microbatches=Z2_MB, grad_shardings=gs)
    # the dry-run's reckoning of the same step on the same mesh
    _, args, shardings = D.build_step(
        cfg, InputShape("zero2", TRAIN_SEQ, TRAIN_BATCH, "train"),
        {"fsdp_params": False, "microbatches": Z2_MB}, mesh=mesh)
    sh = shardings(mesh)
    reckoned = {k: SH.shard_nbytes(a, s)
                for k, a, s in zip(("params", "opt", "batch"), args, sh)}
    out = {"rank": rank, "steps": [], "reckoned": reckoned}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        mesh.host_ms.clear()
        t0 = time.perf_counter()
        if i == 0:
            m, acc = step.grads(params, b)
            params, state = step.apply(params, acc, state)
        else:
            params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if i == 0:
            out["acc"] = os.path.join(tmp, f"acc{rank}.pt")
            torch.save(_host(acc), out["acc"])
            out["acc_bytes"] = _nbytes(acc)
            del acc
            if rank == 0:
                out["params1"] = os.path.join(tmp, "params1.pt")
                torch.save(_host(params), out["params1"])
        out["steps"].append({
            "wall_ms": wall, "loss": float(m["loss"]),
            "aux_loss": float(m["aux_loss"]),
            "expert_load": m["expert_load"].tolist(),
            "dropped": m["dropped"].tolist(),
            "collective_ms": dict(mesh.host_ms),
            "ranks_agree": _ranks_agree(params)})
    if rank == 0:    # the ZeRO-2 oracle of phase 15 (b) on this mesh
        out["params_final"] = os.path.join(tmp, "params_final.pt")
        torch.save(_host(params), out["params_final"])
    out["resident"] = {"params": _nbytes(params), "opt": _nbytes(state),
                       "batch": step.stats["batch_bytes"]}
    out["mu_bytes"] = _nbytes(state["mu"])
    out["nu_bytes"] = _nbytes(state["nu"])
    out["stats"] = dict(step.stats)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["data_dims"] = [SH.data_dim(s) for s in _leaves(gs)]
    out["seconds"] = time.perf_counter() - t_start
    return out


def zero2_phase(card: str) -> dict:
    """Phase 12 (b): the oracle in this process, then two ZeRO-2 ranks
    (``launch.mesh.spawn_local`` on cuda:0); gated as the module
    docstring says."""
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.models.model import init_params
    from repro_torch.training import optimizer as O
    cfg, opt, _ = _z2_setup()
    rec = zero2_reckoning(cfg)
    log(f"  mixtral-8x7b, {cfg.num_layers} of 32 layers, {cfg.dtype}, impl "
        f"ref, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {Z2_MB} "
        f"microbatches, {Z2_STEPS} steps, lr {TRAIN_LR}; ZeRO-2 over "
        f"{Z2_RANKS} data ranks: {rec['resident_gb']:.2f} GB resident and "
        f"~{rec['step_gb']:.1f} GB at the update a rank by the reckoning")
    # cuBLAS keeps a workspace a thread (autograd's backward runs on one
    # of its own) in the caching allocator: drop them on both readings
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    one = z2_oracle()
    t1 = time.perf_counter()
    torch._C._cuda_clearCublasWorkspaces()
    if torch.cuda.memory_allocated() != held:
        raise AssertionError(f"the oracle left "
                             f"{torch.cuda.memory_allocated() - held} bytes "
                             "on the card before the ranks start")
    log(f"  this process holds {held / 1e6:.1f} MB on the card while the "
        "ranks run")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_local(z2_rank, Z2_RANKS, backend="gloo", args=(tmp,),
                            wall_s=600.0, start_method=START_METHOD)
        for r in ranks:
            r["acc"] = torch.load(r["acc"], map_location="cpu")
            if "params1" in r:
                r["params1"] = torch.load(r["params1"], map_location="cpu")
        final = torch.load(ranks[0].pop("params_final"), map_location="cpu")
    t2 = time.perf_counter()
    log(f"  the one-process oracle {t1 - t0:.1f} s (peak "
        f"{one['peak_gb']:.2f} GB, step walls "
        f"{[round(s['wall_ms'], 1) for s in one['steps']]} ms); "
        f"{Z2_RANKS} ranks {ON_CARD} {t2 - t1:.1f} s")
    # each step's loss against the one-process step's from the same
    # weights: step 1 the oracle's; step 2 the one-process loss at the
    # ranks' own step-1 weights, which sit within a bf16 ulp of the
    # oracle's (its own step 2 is reported beside it)
    at_p1 = z2_loss_at(ranks[0]["params1"], 1)
    for r in ranks:
        for i, got in enumerate(r["steps"]):
            want = one["steps"][0]["loss"] if i == 0 else at_p1
            if abs(got["loss"] - want) > MB_LOSS_TOL:
                raise AssertionError(f"rank {r['rank']} step {i + 1}: loss "
                                     f"{got['loss']} against {want}")
            if not got["ranks_agree"]:
                raise AssertionError(f"step {i + 1}: the ranks' parameters "
                                     "differ")
        if r["acc_bytes"] * Z2_RANKS != one["n_f32_bytes"] or \
                r["mu_bytes"] * Z2_RANKS != one["n_f32_bytes"] or \
                r["nu_bytes"] * Z2_RANKS != one["n_f32_bytes"]:
            raise AssertionError(f"rank {r['rank']}: accumulator / moments "
                                 f"{r['acc_bytes']} / {r['mu_bytes']} / "
                                 f"{r['nu_bytes']} bytes, one process "
                                 f"{one['n_f32_bytes']}")
        if r["resident"] != r["reckoned"]:
            raise AssertionError(f"rank {r['rank']}: resident "
                                 f"{r['resident']} != the dry-run's "
                                 f"{r['reckoned']}")
    for i, s in enumerate(ranks[0]["steps"]):
        w = one["steps"][i]
        want = w["loss"] if i == 0 else at_p1
        log(f"  step {i + 1}: loss {s['loss']:.6f} against {want:.6f} "
            f"(|diff| {abs(s['loss'] - want):.3e}, held to "
            f"{MB_LOSS_TOL:.0e})"
            + ("" if i == 0 else f"; the oracle's own step 2 "
               f"{w['loss']:.6f} (|diff| {abs(s['loss'] - w['loss']):.3e})")
            + f"; expert loads {s['expert_load']} "
            f"{'equal' if s['expert_load'] == w['expert_load'] else 'vs ' + str(w['expert_load'])}"
            f", dropped {s['dropped']} vs {w['dropped']}; both ranks' "
            "parameters equal")
    # the gathered accumulator against the oracle's gradients
    from repro_torch.training.checkpoint import leaf_paths
    dims = ranks[0]["data_dims"]
    rel = {}
    gathered = []
    for (k, want), j, a0, a1 in zip(leaf_paths(one["grads"]), dims,
                                    _leaves(ranks[0]["acc"]),
                                    _leaves(ranks[1]["acc"])):
        g = a0 if j is None else torch.cat([a0, a1], dim=j)
        gathered.append(g)
        rel[k] = float(torch.linalg.vector_norm(g - want)
                       / torch.linalg.vector_norm(want))
    worst = max(rel, key=rel.get)
    log(f"  the gathered step-1 accumulator against the oracle's float32 "
        f"gradients: at most {rel[worst]:.3e} of the norm ({worst}; held "
        f"to {GRAD_REL_TOL:.0e})")
    if rel[worst] > GRAD_REL_TOL:
        raise AssertionError(f"gradients: {rel}")
    del one["grads"]
    # the sharded AdamW against the unsharded update of the same grads
    p0 = init_params(cfg, seed=0, device="cuda")
    it = iter(gathered)
    g = O._map(lambda _: next(it).cuda(), p0)
    del gathered
    p1, _ = opt.update(p0, g, opt.init(p0))
    del g, p0
    ulps = []
    for got, want in zip(_leaves(ranks[0]["params1"]), _leaves(p1)):
        got = got.cuda()
        ulps.append(float(((got.float() - want.float()).abs()
                           / _ulp_bf16(want)).max()))
    del p1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the sharded AdamW against the unsharded update of the gathered "
        f"gradients: at most {max(ulps):.3f} bf16 ulp (held to 1)")
    if max(ulps) > 1:
        raise AssertionError(f"sharded update off by {ulps} bf16 ulps")
    for r in ranks:
        log(f"  rank {r['rank']}: resident {r['resident']} bytes == the "
            f"dry-run's reckoning on the (2, 1) mesh; accumulator "
            f"{r['acc_bytes']}, mu {r['mu_bytes']}, nu {r['nu_bytes']} "
            f"bytes (half of {one['n_f32_bytes']}); peak "
            f"{r['peak_gb']:.2f} GB (reckoned {rec['step_gb']:.1f}); step "
            f"walls {[round(s['wall_ms'], 1) for s in r['steps']]} ms; "
            f"collectives host ms a step "
            f"{[{k: round(v, 2) for k, v in s['collective_ms'].items()} for s in r['steps']]}; "
            f"data dims moved to the front: "
            f"{r['stats']['transpose_bytes'] / 1e9:.3f} GB copied over the "
            f"steps; parameters all-gathered: "
            f"{r['stats']['gathered_bytes'] / 1e9:.3f} GB over the steps; "
            f"{r['seconds']:.1f} s from its start to its return; on {card}")
    return {"oracle": {k: v for k, v in one.items()},
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("acc", "params1")} for r in ranks],
            "grad_rel": rel, "ulps": max(ulps), "seconds": t2 - t0,
            "params_final": final}


def mamba_levers(card: str) -> dict:
    """Phase 12 (c): ``ssm.mamba_seq`` at jamba-v0.1-52b's mixer widths,
    forward and backward, each lever against the default path: float32
    outputs (y, final state) and gradients (x and every parameter) within
    MAMBA_TOL; bf16 reported; the device ms of each, in turns."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    cfg = get_config("jamba-v0.1-52b")
    saved = dict(S.MAMBA_OPTS)
    levers = [None, "fused_y", "chunk_remat", "inline_ab"]
    out = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(12)
            p = S.init_mamba(gen, cfg.d_model, cfg.ssm, dtype, "cuda")
            x = torch.randn((1, MAMBA_SEQ, cfg.d_model), generator=gen,
                            device="cuda", dtype=dtype)
            w = torch.randn((1, MAMBA_SEQ, cfg.d_model), generator=gen,
                            device="cuda", dtype=torch.float32)

            def run(lever):
                S.MAMBA_OPTS.update(dict(saved, **{k: False for k in saved}))
                if lever:
                    S.MAMBA_OPTS[lever] = True
                live = {k: v.detach().requires_grad_() for k, v in p.items()}
                xl = x.detach().requires_grad_()
                y, st = S.mamba_seq(live, xl, cfg.ssm)
                (torch.sum(y.float() * w) + torch.sum(st["ssm"])).backward()
                return [y.detach(), st["ssm"].detach(), xl.grad] + \
                    [live[k].grad for k in sorted(live)]

            base = run(None)
            name = "float32" if dtype == torch.float32 else "bf16"
            for lever in levers[1:]:
                got = run(lever)
                errs = [float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, base)]
                ok = all(torch.allclose(a.float(), b.float(), atol=MAMBA_TOL,
                                        rtol=MAMBA_TOL)
                         for a, b in zip(got, base))
                out[f"{name} {lever}"] = max(errs)
                if dtype == torch.float32 and not ok:
                    raise AssertionError(f"mamba lever {lever}: float32 "
                                         f"outputs/gradients off the default "
                                         f"path by {errs}")
            del base, got
            times = {str(lv): time_ms(functools.partial(run, lv), iters=3,
                                      warmup=1, reps=3) for lv in levers}
            out[f"{name} ms"] = times
            log(f"  mamba_seq {name}, B 1, S {MAMBA_SEQ}, d_model "
                f"{cfg.d_model}, d_inner {cfg.ssm.expand * cfg.d_model}, "
                f"d_state {cfg.ssm.d_state}: max |lever - default| over "
                f"outputs and gradients "
                f"{ {lv: out[f'{name} {lv}'] for lv in levers[1:]} }"
                + (f" (held to atol=rtol={MAMBA_TOL})"
                   if dtype == torch.float32 else " (reported)")
                + f"; forward+backward device ms on {card}: "
                f"{ {k: round(v, 3) for k, v in times.items()} }")
    finally:
        S.MAMBA_OPTS.update(saved)
    return out


def sharding_phase(card: str) -> dict:
    """Phase 12: the dry-run sweep, ZeRO-2 training on two ranks, the
    Mamba levers."""
    t12 = time.perf_counter()
    log("  (a) the dry-run sweep: 12 archs x 4 input shapes on the 16x16 "
        "logical mesh, meta device")
    sweep = dryrun_sweep(card)
    gc.collect()
    torch.cuda.empty_cache()
    log("  (b) ZeRO-2: make_train_step(grad_shardings=) over a (2, 1) "
        "process mesh")
    z2 = zero2_phase(card)
    log("  (c) the Mamba levers at jamba-v0.1-52b's widths")
    levers = mamba_levers(card)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
    return {"sweep_s": sweep["seconds"], "zero2": z2, "levers": levers}


# ------------------------------------------------------------ phase 13

# phase 13 (a): tensor-parallel training, make_train_step(grad_shardings=)
# over (data, model) process meshes with model 2: phase 12's mixtral-8x7b
# at its published widths (1 of 32 layers, bf16, impl "ref", TokenStream
# batches of 8 x 256 in 2 microbatches, the drop-free capacity factor 4),
# each mesh (its steps in TP_TRAIN) on ranks sharing cuda:0,
# against the one-process step at dispatch groups = data, held to phase
# 9's MB_LOSS_TOL and GRAD_REL_TOL as phase 12 is
TP_TRAIN = {(1, 2): 2, (2, 2): 1}
# phase 13 (b): the tensor-parallel prefill through the kernels on (1, 2),
# mixtral-8x7b at its published widths, TP_PREFILL_B prompts at the
# TP_PREFILL_S bucket, impl "auto": float32 at TP_F32_LAYERS layers held
# to the one-process prefill on the kernel path (logits within
# TOL[float32], greedy tokens and loads exact); bf16 at
# TP_BF16_LAYERS layers (8 until phase 15 needed the script's time)
# gated per MoE sublayer at TOL[bf16] from the
# one-process path's own input, with a control (rank 1 adding zeros in
# place of its partial sum) that must leave more than TP_CONTROL_SHARE of
# a sublayer's elements out of that tolerance
TP_PREFILL_B, TP_PREFILL_S = 8, 512
TP_F32_LAYERS, TP_BF16_LAYERS = 2, 2
TP_CONTROL_SHARE = 0.5


def tp_reckoning(cfg, shape) -> dict:
    """Device bytes of a rank of the tensor-parallel ZeRO-2 step on a
    (data, model) = `shape` mesh, in the form of ``zero2_reckoning``:
    bf16 weights 2n/m (the rank's model shard), float32 accumulator,
    first and second moments 4n/(d m) each; the update adds the clipped
    float32 shards (4n/(d m)), the new moments (8n/(d m)), the new weight
    shards (2n/(d m)) and about four float32 temporaries of the largest
    shard (16L/(d m)); the resident state between steps is the weights
    and the moments."""
    n, (d, m) = cfg.num_params(), shape
    big = (cfg.num_layers // cfg.moe.every_n_layers) * cfg.moe.num_experts \
        * cfg.d_model * cfg.moe.d_ff
    return {"resident_gb": (2 * n / m + 8 * n / (d * m)) / 1e9,
            "step_gb": (2 * n / m + 26 * n / (d * m) + 16 * big / (d * m))
            / 1e9}


def _logical(shape):
    from collections import OrderedDict
    from repro_torch.launch.mesh import LogicalMesh
    return LogicalMesh(OrderedDict(zip(("data", "model"), shape)),
                       ("data", "model"))


def _group_agree(mesh, tensors, group: str) -> bool:
    """Whether every member of `group` holds the same `tensors`, one at
    a time through an all-gather over it; the answer is the world's."""
    import torch.distributed as dist
    same = True
    if mesh.group_size(group) > 1:
        for t in tensors:
            parts = mesh.all_gather(t, group)
            same &= all(torch.equal(parts[0], q) for q in parts[1:])
            del parts
    flag = torch.tensor([int(same)], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class RolledExperts:
    """The control of phase 17's MoE gate: within the block, the expert
    outputs are gathered over the model group and then rolled by one
    rank's block of experts, so each expert's rows land on another
    expert's place before the combine."""

    def __enter__(self):
        from repro_torch.distributed import tensor_parallel as TP
        self._tp, self._fn = TP, TP.gather_experts
        inner = self._fn

        def run(y, mesh):
            return torch.roll(inner(y, mesh), y.shape[0], dims=0)

        TP.gather_experts = run
        return self

    def __exit__(self, *exc):
        self._tp.gather_experts = self._fn


class SkipPartial:
    """The control of phase 13's prefill gate: within the block, the
    model group's sums take part as before, but rank 1 adds zeros in
    place of its partial sum (its F-rows' share of every row-parallel
    product is lost)."""

    def __enter__(self):
        from repro_torch.distributed import tensor_parallel as TP
        self._tp, self._fn = TP, TP.reduce_from_model
        inner = self._fn

        def run(x, mesh):
            mine = mesh is None or mesh.index("model") == 0
            return inner(x if mine else torch.zeros_like(x), mesh)

        TP.reduce_from_model = run
        return self

    def __exit__(self, *exc):
        self._tp.reduce_from_model = self._fn


def _mixtral(dtype: str, layers: int):
    """mixtral-8x7b at its published widths, `layers` deep, impl "auto"
    (phases 13 and 14)."""
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").with_(num_layers=layers, dtype=dtype,
                                            impl="auto")


def _tp_prefill_config(dtype: str):
    return _mixtral(dtype, TP_F32_LAYERS if dtype == "float32"
                    else TP_BF16_LAYERS)


def _rank_shards(mesh, cfg, fsdp: bool = False, ep: bool = False):
    """(this rank's contiguous shards of `cfg`'s parameters, their
    shardings): ``params_shardings(fsdp=, ep_experts=ep)``, the
    parameters built whole on the card one rank at a time (two whole
    copies beside the shards may not fit) and cut."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import init_params
    for r in range(mesh.size):
        if mesh.rank == r:
            full = init_params(cfg, seed=0, device="cuda")
            ps = SH.params_shardings(full, mesh, fsdp=fsdp, ep_experts=ep)
            shards = SH.shard_tree(full, ps, copy=True)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return shards, ps


def moe_sublayer_gates(mesh, cfg, shards, ios, data_mesh=None,
                       positions=None, shardings=None) -> list:
    """Each MoE sublayer of a tensor-parallel rank run from the
    one-process path's input: `ios` holds, for each MoE layer, the
    (input, output) pairs of that path's calls on the host (the rows
    this rank runs), and `positions` each MoE layer's (pattern position,
    period) (default: position 0, period = the layer). The rank's
    sublayer (its F-slices of the expert bank or its whole experts,
    ``dispatch_moe(model_mesh=)``: the layout its shards have, gathered at use as the step gathers them, over data
    first where `shardings` split them so) runs at the dispatch groups
    and with the `data_mesh` the step gives it, once as it is and once
    under its control: ``SkipPartial`` for F-slices, ``RolledExperts``
    for whole experts. A record a call: the layer, whether it equals the
    one-process output bit for bit ("same"), max |err|, whether it is
    within TOL[bf16] elementwise and finite, |err| / |output| in norm
    ("rel"), and the control's max |err|, share of elements out of that
    tolerance and norm ("control_rel")."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    tp = T._tp_layout(cfg, shards, mesh, shardings=shardings)
    tol, gate = TOL[torch.bfloat16], []
    for layer, calls in enumerate(ios):
        j, i = (0, layer) if positions is None else positions[layer]
        p, ffn_mesh = tp.sublayer(j, T._period(tp.params["layers"][j], i),
                                  i)
        if ffn_mesh is None:
            raise AssertionError("the expert bank is neither a column/row "
                                 "pair nor split by expert on "
                                 f"{dict(mesh.shape)}")
        by_expert = p["moe"]["experts"]["w_down"].shape[0] \
            != cfg.moe.num_experts
        control = RolledExperts if by_expert else SkipPartial
        for h, want in calls:
            h, want = h.cuda(), want.cuda().float()

            def moe():
                return MOE.dispatch_moe(
                    p["moe"], h, top_k=cfg.moe.top_k,
                    num_experts=cfg.moe.num_experts,
                    capacity_factor=cfg.moe.capacity_factor, act=cfg.act,
                    groups=T._moe_groups(h, data_mesh), impl=cfg.impl,
                    data_mesh=data_mesh, model_mesh=ffn_mesh)[0].float()

            with torch.no_grad():
                got = moe()
                with control():
                    bad = moe()
            limit = tol + tol * want.abs()
            norm = want.norm()
            gate.append({
                "layer": layer, "same": bool(torch.equal(got, want)),
                "max_abs_err": float((got - want).abs().max()),
                "ok": bool(torch.allclose(got, want, atol=tol, rtol=tol)),
                "finite": bool(torch.isfinite(got).all()),
                "rel": float((got - want).norm() / norm),
                "control_max_abs_err": float((bad - want).abs().max()),
                "control_share": float(((bad - want).abs() > limit)
                                       .float().mean()),
                "control_rel": float((bad - want).norm() / norm)})
            del h, want, got, bad
        del p
    return gate


def against_one_process(oracle, rank, meshes, gate, wall_s: float) -> dict:
    """The frame of phases 13 and 14: in a temporary directory,
    `oracle(tmp, held)` in this process, which must leave the card as it
    found it (holding `held` bytes); then, for each (shape, args) of
    `meshes`, the ranks of ``rank(r, shape, tmp, *args)`` spawned on
    cuda:0, and ``gate(shape, ranks, one)`` on what they
    return while the directory stands (`one`: what `oracle` returned).
    Returns {shape: what `gate` returned}."""
    from repro_torch.launch.mesh import spawn_local
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        one = oracle(tmp, held)
        torch._C._cuda_clearCublasWorkspaces()
        if torch.cuda.memory_allocated() != held:
            raise AssertionError(f"the oracles left "
                                 f"{torch.cuda.memory_allocated() - held} "
                                 "bytes on the card before the ranks start")
        for shape, args in meshes:
            t1 = time.perf_counter()
            ranks = spawn_local(rank, shape[0] * shape[1], backend="gloo",
                                args=(shape, tmp, *args), wall_s=wall_s,
                                start_method=START_METHOD)
            log(f"  {len(ranks)} ranks on {shape} {ON_CARD} "
                f"{time.perf_counter() - t1:.1f} s")
            out[shape] = gate(shape, ranks, one)
    return out


def _tp_expert_rows(cfg, dp: int = 1) -> int:
    """C of the expert kernels in phase 13's prefill cell on a rank of a
    mesh of `dp` data ranks (phases 13 and 17): its dispatch groups
    (``transformer._moe_groups``: at most 2048 tokens a group of the
    batch, an equal run of them a data rank) times a group's
    capacity."""
    t = TP_PREFILL_B * TP_PREFILL_S
    g = max(dp, t // 2048)
    return g // dp * math.ceil(cfg.moe.capacity_factor * cfg.moe.top_k
                               * (t // g) / cfg.moe.num_experts)


def _tp_prefill_batch(cfg):
    gen = torch.Generator().manual_seed(13)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (TP_PREFILL_B, TP_PREFILL_S),
                                    generator=gen, dtype=torch.int32)}


def tp_train_rank(mesh, shape, tmp: str) -> dict:
    """Phase 13 (a) on this rank: TP_TRAIN[shape] steps, step 1 as its two
    halves; its step-1 accumulator and weight shards to files in `tmp`;
    the bytes it holds against ``launch.dryrun.build_step``'s shardings
    on the same mesh; data replicas' parameters and the model ranks'
    replicated leaves compared across ranks."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg, opt, batches = _z2_setup()
    T.set_moe_dispatch_groups(shape[0])
    try:
        full = init_params(cfg, seed=0, device="cuda")
        gs = SH.params_shardings(full, mesh, fsdp=True)
        state = opt.init(SH.shard_tree(full, gs))
        step = M.make_train_step(cfg, opt, microbatches=Z2_MB,
                                 grad_shardings=gs)
        params = SH.shard_tree(full, step.param_shardings, copy=True)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        # the dry-run's reckoning of the same step on the same mesh
        _, args, shardings = D.build_step(
            cfg, InputShape("tp", TRAIN_SEQ, TRAIN_BATCH, "train"),
            {"fsdp_params": False, "microbatches": Z2_MB}, mesh=mesh)
        reckoned = {k: SH.shard_nbytes(a, s) for k, a, s in
                    zip(("params", "opt", "batch"), args, shardings(mesh))}
        whole = [SH.model_dim(s) is None
                 for s in _leaves(step.param_shardings)]
        out = {"steps": [], "reckoned": reckoned}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches[:TP_TRAIN[shape]]):
            mesh.host_ms.clear()
            mesh.nbytes.clear()
            t0 = time.perf_counter()
            if i == 0:
                m, acc = step.grads(params, b)
                params, state = step.apply(params, acc, state)
            else:
                params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if i == 0:
                out["acc"] = os.path.join(tmp, f"acc{mesh.rank}.pt")
                torch.save(_host(acc), out["acc"])
                out["acc_bytes"] = _nbytes(acc)
                del acc
                out["params1"] = os.path.join(tmp, f"p1_{mesh.rank}.pt")
                torch.save(_host(params), out["params1"])
            out["steps"].append({
                "wall_ms": wall, "loss": float(m["loss"]),
                "aux_loss": float(m["aux_loss"]),
                "expert_load": m["expert_load"].tolist(),
                "dropped": m["dropped"].tolist(),
                "collective_ms": dict(mesh.host_ms),
                "collective_bytes": dict(mesh.nbytes),
                "data_agree": _group_agree(mesh, _leaves(params), "data"),
                "model_agree": _group_agree(
                    mesh, [t for t, w in zip(_leaves(params), whole) if w],
                    "model")})
        out["resident"] = {"params": _nbytes(params), "opt": _nbytes(state),
                           "batch": step.stats["batch_bytes"]}
        out["stats"] = dict(step.stats)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["whole_leaves"] = sum(whole)
    finally:
        T.set_moe_dispatch_groups(1)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_prefill_rank(mesh, tmp: str) -> dict:
    """Phase 13 (b) on this rank of the (1, 2) mesh: each dtype's
    parameters built whole on the card one rank at a time (two whole
    bf16 copies beside the shards do not fit), cut to this rank's
    contiguous shards; a warm call, then the counted and timed prefill
    (``make_prefill_step(param_shardings=)``, impl "auto"); the kernels'
    path at its shapes; at bf16 each MoE sublayer from the one-process
    path's input (in `tmp`), gated and with the control."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _tp_prefill_config(dtype)
        shards, ps = _rank_shards(mesh, cfg)
        torch.cuda.reset_peak_memory_stats()
        step = M.make_prefill_step(cfg, param_shardings=ps)
        batch = _tp_prefill_batch(cfg)
        with torch.no_grad():
            step(shards, batch)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            mesh.host_ms.clear()
            mesh.nbytes.clear()
            t0 = time.perf_counter()
            logits, m = step(shards, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = dict(K.launch_counts())
        experts = T._period(shards["layers"][0], 0)["moe"]["experts"]
        e, d = cfg.moe.num_experts, cfg.d_model
        f, c = experts["w_down"].shape[1], _tp_expert_rows(cfg)
        dt = getattr(torch, dtype)
        paths = {
            "fused_gate_up": MG.kernel_path(torch.empty(
                (e, c, d), dtype=dt, device="cuda"), experts["w_gate"],
                True)[0],
            "gmm": MG.kernel_path(torch.empty(
                (e, c, f), dtype=dt, device="cuda"), experts["w_down"],
                False)[0]}
        rec = {"wall_ms": wall, "launches": launches, "paths": paths,
               "shapes": {"fused_gate_up": (e, c, d, f),
                          "gmm": (e, c, f, d)},
               "collective_ms": dict(mesh.host_ms),
               "collective_bytes": dict(mesh.nbytes),
               "logits": logits.float().cpu(),
               "expert_load": m["expert_load"].tolist(),
               "dropped": m["dropped"].tolist(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if dtype == "bfloat16":
            rec["sublayers"] = moe_sublayer_gates(
                mesh, cfg, shards,
                [[io] for io in torch.load(os.path.join(tmp, "moe_io.pt"))])
        out[dtype] = rec
        del shards, step, logits, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, shape: tuple, tmp: str, prefill: bool) -> dict:
    """One rank of phase 13 on a (data, model) = `shape` mesh, its
    process group up: (a) training, then with `prefill` (b). Everything
    returned lives on the host."""
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_process_mesh(*shape, device="cuda:0",
                             transport="shared")
    out = {"rank": rank, "coords": mesh.coords,
           "train": tp_train_rank(mesh, shape, tmp)}
    if prefill:
        out["prefill"] = tp_prefill_rank(mesh, tmp)
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_prefill_oracle(tmp: str) -> dict:
    """The one-process prefill on the kernel path in this process, each
    dtype's: last-position logits, loads, drops and wall on the host; at
    bf16 each MoE sublayer's input and output (the main path's own,
    recorded around ``moe.dispatch_moe``) to `tmp`."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import init_params
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _tp_prefill_config(dtype)
        params = init_params(cfg, seed=0, device="cuda")
        step = M.make_prefill_step(cfg)
        batch = {k: v.cuda() for k, v in _tp_prefill_batch(cfg).items()}
        seen, inner = [], MOE.dispatch_moe

        def spy(p, x, **kw):
            y, mm = inner(p, x, **kw)
            seen.append((x.detach().cpu(), y.detach().cpu()))
            return y, mm

        with torch.no_grad():
            step(params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, m = step(params, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if dtype == "bfloat16":
                MOE.dispatch_moe = spy
                try:
                    step(params, batch)
                finally:
                    MOE.dispatch_moe = inner
        out[dtype] = {"logits": logits.float().cpu(), "wall_ms": wall,
                      "expert_load": m["expert_load"].tolist(),
                      "dropped": m["dropped"].tolist()}
        if dtype == "bfloat16":
            torch.save(seen, os.path.join(tmp, "moe_io.pt"))
        del params, step, logits, m, seen
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_train_gates(shape, ranks, one, card, fails: list) -> dict:
    """Phase 13 (a)'s gates on the ranks of one mesh (their step-1 files
    read into host memory): losses, the assembled accumulator, the
    sharded update, agreement across ranks, resident bytes; printed
    beside the reckoning. A failed gate's message goes to `fails`."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.checkpoint import leaf_paths
    cfg, opt, _ = _z2_setup()
    rec = tp_reckoning(cfg, shape)
    d = shape[0]
    mesh = _logical(shape)
    aparams = abstract_params(cfg)
    gspecs = _leaves(SH.params_shardings(aparams, mesh, fsdp=True))
    pspecs = _leaves(SH.params_shardings(aparams, mesh, fsdp=False))
    gathered = [SH.assemble(parts, s) for s, parts in
                zip(gspecs, zip(*[_leaves(r["train"]["acc"])
                                  for r in ranks]))]
    p1 = [SH.assemble(parts, s) for s, parts in
          zip(pspecs, zip(*[_leaves(r["train"]["params1"])
                            for r in ranks]))]
    for r in ranks:
        del r["train"]["acc"], r["train"]["params1"]
    it = iter(p1)
    at_p1 = z2_loss_at(O._map(lambda _: next(it), aparams), 1, d) \
        if TP_TRAIN[shape] > 1 else None
    for r in ranks:
        t = r["train"]
        for i, got in enumerate(t["steps"]):
            want = one["steps"][0]["loss"] if i == 0 else at_p1
            if abs(got["loss"] - want) > MB_LOSS_TOL:
                fails.append(f"{shape} rank {r['rank']} step {i + 1}: loss "
                             f"{got['loss']} against {want}")
            if not (got["data_agree"] and got["model_agree"]):
                fails.append(f"{shape} step {i + 1}: data replicas' "
                             "parameters or the model ranks' whole leaves "
                             "differ")
        if t["resident"] != t["reckoned"]:
            fails.append(f"{shape} rank {r['rank']}: resident "
                         f"{t['resident']} != the dry-run's {t['reckoned']}")
    for i, s in enumerate(ranks[0]["train"]["steps"]):
        w = one["steps"][i]
        want = w["loss"] if i == 0 else at_p1
        log(f"  {shape} step {i + 1}: loss {s['loss']:.6f} against "
            f"{want:.6f} (|diff| {abs(s['loss'] - want):.3e}, held to "
            f"{MB_LOSS_TOL:.0e})"
            + ("" if i == 0 else f"; the oracle's own step 2 "
               f"{w['loss']:.6f} (|diff| {abs(s['loss'] - w['loss']):.3e})")
            + f"; expert loads {s['expert_load']} "
            f"{'equal' if s['expert_load'] == w['expert_load'] else 'vs ' + str(w['expert_load'])}"
            f", dropped {s['dropped']} vs {w['dropped']}; data replicas "
            "equal, model ranks' whole leaves equal")
    rel = {}
    for (k, want), g in zip(leaf_paths(one["grads"]), gathered):
        rel[k] = float(torch.linalg.vector_norm(g - want)
                       / torch.linalg.vector_norm(want))
    worst = max(rel, key=rel.get)
    log(f"  {shape}: the step-1 accumulator assembled from "
        f"{len(ranks)} ranks' shards against the oracle's float32 "
        f"gradients: at most {rel[worst]:.3e} of the norm ({worst}; held "
        f"to {GRAD_REL_TOL:.0e})")
    if rel[worst] > GRAD_REL_TOL:
        fails.append(f"{shape} gradients: {rel}")
    del one["grads"]
    p0 = init_params(cfg, seed=0, device="cuda")
    it = iter(gathered)
    g = O._map(lambda _: next(it).cuda(), p0)
    # after one step, phase 17's oracle of its gradients on this mesh
    acc = gathered if TP_TRAIN[shape] == 1 else None
    del gathered
    want, _ = opt.update(p0, g, opt.init(p0))
    del g, p0
    ulps = [float(((a.cuda().float() - b.float()).abs()
                   / _ulp_bf16(b)).max()) for a, b in zip(p1, _leaves(want))]
    # after one step, the ZeRO-2 oracle of phase 15 (b) on this mesh
    final = p1 if TP_TRAIN[shape] == 1 else None
    del want, p1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {shape}: the sharded AdamW against the unsharded update of the "
        f"assembled gradients: at most {max(ulps):.3f} bf16 ulp (held to "
        "1)")
    if max(ulps) > 1:
        fails.append(f"{shape}: sharded update off by {ulps} ulps")
    for r in ranks:
        t = r["train"]
        gat = [s["collective_bytes"].get("all_gather/model", 0)
               for s in t["steps"]]
        log(f"  {shape} rank {r['rank']} {tuple(r['coords'])}: resident "
            f"{t['resident']} bytes == the dry-run's reckoning; peak "
            f"{t['peak_gb']:.2f} GB (reckoned {rec['resident_gb']:.2f} "
            f"resident, ~{rec['step_gb']:.1f} at the update); step walls "
            f"{[round(s['wall_ms'], 1) for s in t['steps']]} ms; "
            f"collectives host ms a step "
            f"{[{k: round(v, 2) for k, v in s['collective_ms'].items()} for s in t['steps']]}; "
            f"gathered over the model group a step (weights at use, the "
            f"batch) {[round(b / 1e9, 4) for b in gat]} GB; "
            f"{t['whole_leaves']} leaves whole on every model rank; "
            f"{r['seconds']:.1f} s from its start to its return; on {card}")
    return {"rec": rec, "grad_rel": rel[worst], "ulps": max(ulps),
            "losses": [[s["loss"] for s in r["train"]["steps"]]
                       for r in ranks],
            "walls": [[s["wall_ms"] for s in r["train"]["steps"]]
                      for r in ranks],
            "peaks": [r["train"]["peak_gb"] for r in ranks],
            "resident": [r["train"]["resident"] for r in ranks],
            "params_final": final, "acc_final": acc}


def tp_prefill_gates(ranks, one, card, fails: list) -> dict:
    """Phase 13 (b)'s gates: the float32 logits, greedy tokens and loads
    against the one-process prefill; every bf16 MoE sublayer within its
    tolerance and the control far outside it; the kernels launched once
    a layer a rank on their path at the F-shard shapes. A failed gate's
    message goes to `fails`."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _tp_prefill_config(dtype)
        want = one[dtype]
        for r in ranks:
            got = r["prefill"][dtype]
            name = f"(1, 2) prefill {dtype} rank {r['rank']}"
            for k_name in ("fused_gate_up", "gmm"):
                n = got["launches"][k_name]
                path = got["paths"][k_name]
                if n != cfg.num_layers:
                    fails.append(f"{name}: {k_name} launched {n} times, not "
                                 f"once a layer ({cfg.num_layers})")
                if dtype == "bfloat16" and path != "wgmma":
                    fails.append(f"{name}: {k_name} took {path}")
            err = float((got["logits"] - want["logits"]).abs().max())
            same_tok = torch.equal(got["logits"].argmax(-1),
                                   want["logits"].argmax(-1))
            same_load = got["expert_load"] == want["expert_load"] and \
                got["dropped"] == want["dropped"]
            if dtype == "float32":
                tol = TOL[torch.float32]
                if not torch.allclose(got["logits"], want["logits"],
                                      atol=tol, rtol=tol):
                    fails.append(f"{name}: logits {err:.3e} off, beyond "
                                 f"atol=rtol={tol}")
                if not (same_tok and same_load):
                    fails.append(f"{name}: greedy tokens equal {same_tok}, "
                                 f"loads and drops equal {same_load}")
            else:
                for layer, s in enumerate(got["sublayers"]):
                    if not (s["ok"] and s["finite"]):
                        fails.append(
                            f"{name} layer {layer} MoE: max |TP - one "
                            f"process| {s['max_abs_err']:.3e} beyond "
                            f"atol=rtol={TOL[torch.bfloat16]}")
                    if s["control_share"] <= TP_CONTROL_SHARE:
                        fails.append(
                            f"{name} layer {layer}: the control (rank 1's "
                            f"partial sum skipped) left only "
                            f"{s['control_share']:.3f} of the elements out "
                            "of tolerance")
                sub = got["sublayers"]
                log(f"  {name}: every MoE sublayer from the one-process "
                    f"input within atol=rtol={TOL[torch.bfloat16]} (max "
                    f"|err| {max(s['max_abs_err'] for s in sub):.3e}); the "
                    f"control (rank 1 adds zeros for its partial sum) "
                    f"leaves {min(s['control_share'] for s in sub):.3f}-"
                    f"{max(s['control_share'] for s in sub):.3f} of each "
                    f"sublayer's elements out of it (held above "
                    f"{TP_CONTROL_SHARE}), max |err| "
                    f"{max(s['control_max_abs_err'] for s in sub):.3e}")
            log(f"  {name}: {cfg.num_layers} layers, logits max |TP - one "
                f"process| {err:.3e}"
                + (f" (held to atol=rtol={TOL[torch.float32]})"
                   if dtype == "float32" else " (reported, not gated)")
                + f"; greedy tokens {'equal' if same_tok else 'DIFFER'}; "
                f"loads and drops {'equal' if same_load else 'DIFFER'}; "
                f"launches {got['launches']['fused_gate_up']} fused_gate_up "
                f"at {got['shapes']['fused_gate_up']} and "
                f"{got['launches']['gmm']} gmm at {got['shapes']['gmm']} "
                f"(E, C, D, F), paths {got['paths']}; prefill wall "
                f"{got['wall_ms']:.2f} ms (one process "
                f"{want['wall_ms']:.2f}); model group host ms "
                f"{ {k: round(v, 2) for k, v in got['collective_ms'].items()} }"
                f", bytes {got['collective_bytes']}; peak "
                f"{got['peak_gb']:.2f} GB; on {card}")
        out[dtype] = {
            "wall_ms": [r["prefill"][dtype]["wall_ms"] for r in ranks],
            "one_process_wall_ms": want["wall_ms"],
            "launches": [{k: r["prefill"][dtype]["launches"][k]
                          for k in ("fused_gate_up", "gmm")}
                         for r in ranks]}
    return out


def tp_kernel_shapes(gen) -> dict:
    """``fused_gate_up`` and ``gmm`` at the shapes the (1, 2) prefill
    gives them (F 7168 of 14336) and at the one-process prefill's, each
    against its plain version and timed beside its bound."""
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b")
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    c = _tp_expert_rows(cfg)
    out = {}
    for name, fused in (("fused_gate_up", True), ("gmm", False)):
        out[name] = {}
        for label, width in (("tp F/2", f // 2), ("1 proc", f)):
            shape = (e, c, d, width) if fused else (e, c, width, d)
            out[name][label] = dict(
                shape=list(shape[:4]), **gmm_shape_timed(
                    gen, name, fused, label, shape + ([c] * e,)))
    return out


def tp_phase(card: str) -> dict:
    """Phase 13: the kernels at the F-shard shapes; the one-process
    oracles in this process (which then holds nothing on the card); the
    (1, 2) ranks (training, then the prefill) and the (2, 2) ranks
    (training); gated as the module docstring says."""
    t13 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(14)
    shapes = tp_kernel_shapes(gen)
    cfg, _, _ = _z2_setup()
    for shape in TP_TRAIN:
        rec = tp_reckoning(cfg, shape)
        log(f"  mixtral-8x7b, {cfg.num_layers} of 32 layers, bf16, impl "
            f"ref, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {Z2_MB} "
            f"microbatches, {TP_TRAIN[shape]} step(s) on (data, model) = "
            f"{shape}: {rec['resident_gb']:.2f} GB resident and "
            f"~{rec['step_gb']:.1f} GB at the update a rank by the "
            "reckoning")
    res, fails = {"kernels": shapes}, []

    def oracle(tmp, held):
        t0 = time.perf_counter()
        oracles = {d: z2_oracle(d, max(s for (dd, _), s in TP_TRAIN.items()
                                       if dd == d))
                   for d in sorted({dd for dd, _ in TP_TRAIN})}
        prefill = tp_prefill_oracle(tmp)
        log(f"  the one-process oracles {time.perf_counter() - t0:.1f} s "
            f"(training at dispatch groups {sorted(oracles)}, peaks "
            f"{[round(o['peak_gb'], 2) for o in oracles.values()]} GB; the "
            f"prefill at float32 ({TP_F32_LAYERS} layers) and bf16 "
            f"({TP_BF16_LAYERS}), B {TP_PREFILL_B} x {TP_PREFILL_S}); this "
            f"process holds {held / 1e6:.1f} MB on the card while the "
            "ranks run")
        return oracles, prefill

    def gate(shape, got, one):
        for r in got:
            for k in ("acc", "params1"):
                r["train"][k] = torch.load(r["train"][k],
                                           map_location="cpu")
        res[str(shape)] = tp_train_gates(shape, got, one[0][shape[0]], card,
                                         fails)
        return got, one[1]

    ranks = against_one_process(
        oracle, tp_rank, [(shape, (shape == (1, 2),)) for shape in TP_TRAIN],
        gate, 600.0)
    res["prefill"] = tp_prefill_gates(*ranks[(1, 2)], card, fails)
    res["seconds"] = time.perf_counter() - t13
    log(f"  phase 13 took {res['seconds']:.1f} s")
    if fails:
        raise AssertionError("phase 13: " + "; ".join(fails))
    return res


# ------------------------------------------------------------ phase 14

# phase 14: the sharded decode step, make_serve_step(param_shardings=,
# cache_shardings=) over (data, model) process meshes, ranks on cuda:0.
# (a) ``decode_attention`` with its softmax statistics at
# mixtral-8x7b's sequence shard at model 2 (DEC_B rows, H 32, KV 8, hd
# 128, S DEC_SLOTS / 2) against its plain version, and two such shards
# merged against one whole call; ``fused_gate_up`` and ``gmm`` at the
# decode step's F-shard shapes. (b) mixtral-8x7b at its published
# widths: DEC_B prompts prefilled at a uniform DEC_PREFILL tokens into a
# DEC_SLOTS-slot cache, then DEC_STEPS decode steps fed the one-process
# oracle's greedy tokens (both sides see the same inputs), impl "auto":
# on (1, 2) float32 at DEC_F32_LAYERS layers and bf16 at
# DEC_BF16_LAYERS; on (2, 2) bf16 at DEC_22_LAYERS under each cache
# layout of DEC_LAYOUTS. Step DEC_CROSS writes the first token into the
# second half of the slots (rank 1's under a sequence split), which
# until then is wholly hidden. The depths were 8 (bf16, (1, 2)) and 2
# ((2, 2)) until phase 15 needed the script's time: over gloo a layer
# costs ~8 s of phase 14 on (1, 2) and ~30 s on (2, 2) (PERF.md).
DEC_B, DEC_SLOTS, DEC_PREFILL, DEC_STEPS = 8, 4096, 2040, 16
DEC_CROSS = DEC_SLOTS // 2 - DEC_PREFILL + 1
DEC_F32_LAYERS, DEC_BF16_LAYERS, DEC_22_LAYERS = 2, 2, 1
DEC_LAYOUTS = {"default": {}, "seq_over_dp": {"seq_over_dp": True},
               "cache_heads_model": {"heads_model": True}}
# Gates, fixed before the run. float32: every step's logits within
# TOL[float32] of the one-process oracle; the assembled cache's first
# layer's K/V within DEC_KV_TOL (they depend on the embedding alone,
# through the same products in both: only a misplaced write moves them)
# and every later layer's within DEC_KV_DEEP_TOL: they carry the earlier
# layers' float32 sums taken in the ranks' order (the expert partials in
# two halves; on the H100 layer 1's read 1.621e-05, PERF.md), which
# ``ExpertHalves`` takes in one process as a witness. bf16, each
# attention sublayer of every decode step, the rank's output against one
# process's on the whole cache from the same input and cache:
# elementwise at TOL[bf16] (phase 10's) and in norm, |got - want| /
# |want| <= DEC_REL. At these widths with random weights a
# decode row averages ~2000 near-uniform lanes, so outputs are ~0.03 and
# phase 10's absolute 2e-2 cannot see a halved output; the norm can. The
# control (``PlainMean``: the ranks' outputs averaged without their
# statistics) must move the norm past DEC_CONTROL x DEC_REL on every
# step before DEC_CROSS. Each MoE sublayer of every bf16 decode step from
# the one-process path's input against its output (phase 13's
# ``moe_sublayer_gates`` at the decode shapes), at the same TOL[bf16] and
# DEC_REL; its control (``SkipPartial``) must leave more than
# TP_CONTROL_SHARE of the elements out of tolerance and move the norm
# past DEC_CONTROL x DEC_REL.
DEC_KV_TOL, DEC_KV_DEEP_TOL, DEC_REL, DEC_CONTROL = 1e-5, 5e-5, 1e-2, 10.0
# (a): the kernel's m and l, both dtypes, within DEC_STATS_TOL of the
# plain version's from the q * scale the kernel takes (rounded to q's
# dtype, as the TPU kernel rounds it); its float32 output elementwise
# within TOL of the plain version's and, row by row, within DEC_REL in
# norm of that version from the kernel's q * scale (the mma path rounds
# the probabilities to bf16 before P.V)
DEC_STATS_TOL = 1e-5
# (a)'s rows: kv_len 0, 1, 17, 1000, 2047, 2048; a row hidden by
# position; a partial row. The merge: rows across the halves' border.
STATS_LENS = [0, 1, 17, 1000, 2047, 2048, 1500, 1200]
STATS_QPOS = [0, 0, 16, 999, 2046, 2047, -1, 1199]
MERGE_LENS = [1, 17, 2047, 2048, 2049, 3000, 4096, 100]


def stats_kernel_check(gen, geometry=(DEC_B, 32, 8, 128, DEC_SLOTS // 2),
                       lens=STATS_LENS, qpos=STATS_QPOS,
                       merge_lens=MERGE_LENS, timed=torch.bfloat16,
                       where: str = "the (1, 2) shard") -> dict:
    """Phase 14 (a): ``decode_attention(return_stats=True)`` at the (1,
    2) sequence shard (`geometry`: B, H, KV, hd, S; `lens` and `qpos`
    each row's kv_len and query position, `merge_lens` the merged rows'
    kv_len), bf16 ("mma") and float32 ("simt"), with and
    without a window of 256, against its plain version: the float32
    output at TOL, and each row's within DEC_REL in norm, m and l within
    DEC_STATS_TOL of the plain version from the kernel's q * scale; m =
    NEG_INF and l = S exactly on the rows with no visible lane (kv_len
    0 or a negative query position among them); two shards merged by
    ``merge_softmax`` against one whole S call at TOL. Timed at `timed`:
    the launch with and without statistics (eager and in a CUDA graph,
    in turns), the plain version, SDPA, and the merge's device time."""
    from repro_torch.distributed import tensor_parallel as TP
    b, h, kvh, hd, s = geometry
    must_hide = [i for i, (n, p) in enumerate(zip(lens, qpos))
                 if n == 0 or p < 0]
    out_rec = {}
    for dtype, want_path in ((torch.bfloat16, "mma"),
                             (torch.float32, "simt")):
        q, k, v, pos, kv_len, q_pos = _attn_inputs(
            gen, b, h, kvh, hd, s, dtype, lens, qpos, False)
        path, info = DA.kernel_path(q, k, v)
        if path != want_path:
            raise AssertionError(f"decode_attention at the shard took "
                                 f"{path!r}, not {want_path!r}")
        # the q the kernel takes: q * scale rounded to q's dtype (in
        # float32 the product itself), scaled back for the plain version
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32,
                             device="cuda")
        q_k = (q.float() * scale).to(dtype).float() * math.sqrt(hd)
        errs, rows_rel, stats_err = {}, {}, {}
        for window in (0, 256):
            got = DA.decode_attention(q, k, v, pos, kv_len, q_pos,
                                      window=window, return_stats=True)
            want = DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                           window=window, return_stats=True)
            same = DA.decode_attention_ref(q_k, k, v, pos, kv_len, q_pos,
                                           window=window, return_stats=True)
            torch.cuda.synchronize()
            name = f"decode_attention stats [S {s}, {dtype}, window " \
                f"{window}]"
            if got[0].dtype != torch.float32:
                raise AssertionError(f"{name}: output {got[0].dtype}")
            errs[window] = check(name, got[0], want[0], dtype)
            rows_rel[window] = float(((got[0] - same[0]).norm(dim=-1)
                                      / same[0].norm(dim=-1)).max())
            if not rows_rel[window] <= DEC_REL:
                raise AssertionError(
                    f"{name}: a row's output {rows_rel[window]:.3e} off in "
                    f"norm, beyond {DEC_REL}")
            stats_err[window] = 0.0
            for label, g, w in (("m", got[1], same[1]),
                                ("l", got[2], same[2])):
                stats_err[window] = max(stats_err[window], float(
                    ((g - w).abs() / (DEC_STATS_TOL
                                      + DEC_STATS_TOL * w.abs())).max()))
                if not torch.allclose(g, w, atol=DEC_STATS_TOL,
                                      rtol=DEC_STATS_TOL):
                    raise AssertionError(
                        f"{name}: {label} {float((g - w).abs().max()):.3e} "
                        f"off, beyond atol=rtol={DEC_STATS_TOL}")
            hidden = want[1] == DA.NEG_INF
            if not (torch.equal(got[1][hidden], want[1][hidden])
                    and bool((got[2][hidden] == s).all())
                    and all(bool(hidden[i].all()) for i in must_hide)):
                raise AssertionError(f"{name}: rows with no visible lane "
                                     "must give m = NEG_INF, l = S")
            log(f"  {name}: {path}, cluster {info['nsplit']}, out "
                f"max_abs_err={errs[window]:.3e}, each row within "
                f"{rows_rel[window]:.2e} in norm (held to {DEC_REL}); m/l "
                f"at {stats_err[window]:.3f} of atol=rtol={DEC_STATS_TOL}; "
                f"{int(hidden[:, 0].sum())} rows with no visible lane exact")
        q2, k2, v2, pos2, kl2, qp2 = _attn_inputs(
            gen, b, h, kvh, hd, 2 * s, dtype, merge_lens,
            [x - 1 for x in merge_lens], False)
        whole = DA.decode_attention(q2, k2, v2, pos2, kl2, qp2)
        halves = [DA.decode_attention(
            q2, *(t[:, i * s:(i + 1) * s].contiguous()
                  for t in (k2, v2, pos2)),
            torch.clamp(kl2 - i * s, 0, s).to(torch.int32), qp2,
            return_stats=True) for i in range(2)]
        out, m, l = (torch.stack(t) for t in zip(*halves))

        def merge():
            return TP.merge_softmax(out, m, l, TP.StackedShards(2),
                                    "model", dtype=dtype)

        merged = merge()[0]
        torch.cuda.synchronize()
        merge_err = check(f"two S {s} shards merged vs one S {2 * s} call "
                          f"[{dtype}]", merged, whole, dtype)
        log(f"  two S {s} shards (kv_len {merge_lens}) merged by "
            f"merge_softmax against one S {2 * s} kernel call, {dtype}: "
            f"max_abs_err={merge_err:.3e} (atol=rtol={TOL[dtype]})")
        if dtype != timed:
            continue

        def run():
            return DA.decode_attention(q, k, v, pos, kv_len, q_pos)

        def run_stats():
            return DA.decode_attention(q, k, v, pos, kv_len, q_pos,
                                       return_stats=True)

        def plain():
            return DA.decode_attention_ref(q, k, v, pos, kv_len, q_pos,
                                           return_stats=True)
        g = h // kvh
        kr = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vr = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vis = (torch.arange(s, device="cuda")[None] < kv_len[:, None]) \
            & (pos <= q_pos[:, None])
        amask = torch.where(vis, 0.0, DA.NEG_INF).to(dtype)[:, None, None, :]
        q4 = q[:, :, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kr, vr, attn_mask=amask)
        ms, ms_stats = _alternate(run, run_stats)
        dev, dev_stats = _alternate(run, run_stats, graph_ms)
        plain_ms, lib_ms = time_ms(plain), time_ms(library)
        lib_dev = graph_ms(library)
        merge_dev = graph_ms(merge)
        # what the call must move: q, each visible lane's K and V and
        # position, V over every lane of a row with none, the float32
        # output and its (m, l)
        n_vis = vis.sum(-1)
        dead = int((n_vis == 0).sum())
        isz = q.element_size()
        nbytes = (b * h * hd + 2 * int(n_vis.sum()) * kvh * hd
                  + dead * s * kvh * hd) * isz + 4 * int(n_vis.sum()) \
            + 4 * (b * h * hd + 2 * b * h) + 4 * 3 * b
        flops = 4.0 * int(n_vis.sum()) * h * hd
        b_ms, b_by = bound(nbytes, flops, dtype)
        log(f"  decode_attention at {where} B={b} H={h} KV={kvh} "
            f"hd={hd} S={s} {dtype} ({path}, cluster {info['nsplit']}): "
            f"ms={ms:.4f} with statistics {ms_stats:.4f}; device_ms="
            f"{dev:.4f} with statistics {dev_stats:.4f} (in turns); "
            f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.2f} MB); "
            f"plain_ms={plain_ms:.4f}; library_ms={lib_ms:.4f} "
            f"library_device_ms={lib_dev:.4f} (SDPA); the merge of two "
            f"shards' partials {merge_dev:.4f} device ms")
        out_rec = dict(shape=f"B{b} H{h} KV{kvh} hd{hd} S{s}, stats",
                       path=path, cluster=info["nsplit"],
                       max_abs_err=max(errs.values()),
                       row_rel=max(rows_rel.values()),
                       stats_share_of_tol=max(stats_err.values()),
                       merge_max_abs_err=merge_err, ms=ms_stats,
                       ms_without_stats=ms, device_ms=dev_stats,
                       device_ms_without_stats=dev, bound_ms=b_ms,
                       bound_by=b_by, plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=lib_dev, merge_device_ms=merge_dev)
    return out_rec


def _dec_expert_rows(cfg, b: int, shape, layout: str) -> int:
    """C of the expert kernels in a sharded decode step of `b` rows: the
    rank's rows (b / data where the layout splits them over data, else
    all b at data dispatch groups, ``transformer._moe_groups``), its
    groups times a group's capacity."""
    dp = shape[0]
    split = dp > 1 and layout != "seq_over_dp"
    t, g = (b // dp, 1) if split else (b, dp)
    return g * math.ceil(cfg.moe.capacity_factor * cfg.moe.top_k * (t // g)
                         / cfg.moe.num_experts)


def dec_kernel_shapes(gen, rows: list, cfg=None) -> dict:
    """``fused_gate_up`` and ``gmm`` at the shapes the bf16 sharded
    decode steps of `cfg` (mixtral-8x7b by default) give them at model
    2: F/2 (7168 of 14336) and each C of `rows`, every row live, and at
    the first C a ragged fill with an expert of none; each against its
    plain version and timed beside its bound."""
    cfg = cfg or _mixtral("bfloat16", 1)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff // 2
    out = {}
    for name, fused in (("fused_gate_up", True), ("gmm", False)):
        out[name] = {}
        for c in rows:
            fills = [("full", [c] * e)]
            if c == rows[0]:
                fills.append(("ragged", [i % (c + 1) for i in range(e)]))
            for fill, gs in fills:
                label = f"dec C{c} {fill}"
                shape = (e, c, d, f) if fused else (e, c, f, d)
                out[name][label] = dict(
                    shape=list(shape), group_sizes=gs, **gmm_shape_timed(
                        gen, name, fused, label, shape + (gs,)))
    return out


class PlainMean:
    """The control of phase 14's bf16 gate: within the block, the ranks'
    partial attention results are averaged without their softmax
    statistics (a merge that skips the rescale)."""

    def __enter__(self):
        from repro_torch.distributed import tensor_parallel as TP
        self._tp, self._fn = TP, TP.merge_softmax

        def run(out, m, l, mesh, axes, dtype=None):
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            out, n = out.float(), 1
            for a in axes:
                out, n = mesh.all_reduce(out, a), n * mesh.group_size(a)
            return (out / n).to(dtype or torch.float32)

        TP.merge_softmax = run
        return self

    def __exit__(self, *exc):
        self._tp.merge_softmax = self._fn


class ExpertHalves:
    """A witness, not a gate: within the block one process runs the
    expert FFN as the two F-halves of its bank, their down products
    summed in float32 and rounded once: the sum the (1, 2) ranks take
    (``moe.experts_ffn(mesh=)``), in their order."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._moe, self._ffn = MOE, MOE.experts_ffn
        ffn = self._ffn

        def experts(p, x, act, *, group_sizes=None, impl="ref", mesh=None):
            if mesh is not None or "w_up_scale" in p:
                return ffn(p, x, act, group_sizes=group_sizes, impl=impl,
                           mesh=mesh)
            f = p["w_down"].shape[1] // 2
            parts = [ffn({"w_gate": p["w_gate"][..., i * f:(i + 1) * f]
                          .contiguous(),
                          "w_up": p["w_up"][..., i * f:(i + 1) * f]
                          .contiguous(),
                          "w_down": p["w_down"][:, i * f:(i + 1) * f]
                          .contiguous()},
                         x, act, group_sizes=group_sizes, impl=impl)
                     for i in range(2)]
            return (parts[0].float() + parts[1].float()).to(x.dtype)

        MOE.experts_ffn = experts
        return self

    def __exit__(self, *exc):
        self._moe.experts_ffn = self._ffn


class MoeCalls:
    """Within the block, each ``moe.dispatch_moe`` call's parameters,
    input, output and keywords are kept on the card (the input and output
    are fresh tensors no later op writes: no copy). ``save`` writes, for
    each layer, its calls' input and output on the host and, where `dp`
    > 1, the output of each of the dp row blocks run alone at groups / dp:
    what a rank holding those rows computes, at the same shapes and so
    the same routing (``dec_moe_gates``)."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._moe, self._fn, self.calls = MOE, MOE.dispatch_moe, []
        inner = self._fn

        def spy(p, x, **kw):
            y, m = inner(p, x, **kw)
            self.calls.append((p, x.detach(), y.detach(), kw))
            return y, m

        MOE.dispatch_moe = spy
        return self

    def __exit__(self, *exc):
        self._moe.dispatch_moe = self._fn

    def save(self, path: str, layers: int, dp: int) -> None:
        out = [[] for _ in range(layers)]
        with torch.no_grad():
            for i, (p, x, y, kw) in enumerate(self.calls):
                n = x.shape[0] // dp
                blocks = [] if dp == 1 else [
                    self._fn(p, x[j * n:(j + 1) * n],
                             **{**kw, "groups": kw["groups"] // dp})[0].cpu()
                    for j in range(dp)]
                out[i % layers].append({"x": x.cpu(), "y": y.cpu(),
                                        "blocks": blocks})
        torch.save(out, path)
        self.calls = []


def dec_prompts(cfg, b: int):
    gen = torch.Generator().manual_seed(14)
    return torch.randint(0, cfg.vocab_size, (b, DEC_PREFILL), generator=gen,
                         dtype=torch.int32)


def _dec_record(logits, m) -> dict:
    """A step's last-position logits (float32, on the host), expert
    loads and drops."""
    return {"logits": logits[:, -1].float().cpu(),
            **{k: m[k].tolist() if k in m else []
               for k in ("expert_load", "dropped")}}


def dec_oracle(dtype: str, layers: int, groups: int, b: int, tmp: str, *,
               impl: str = "auto", teacher=None, order=None,
               keep_cache: bool = False) -> dict:
    """The same steps in one process (``transformer.decode_step``, what
    the one-process serve step runs) at dispatch groups `groups`, on the
    kernels or at `impl`: each step's record and the decode walls; with
    `keep_cache` the final cache on the host. A witness is fed
    `teacher`'s tokens and may run within `order` (``ExpertHalves``);
    else the oracle feeds its own greedy tokens and writes them to `tmp`
    for the ranks, and at bf16 its MoE sublayers' decode calls
    (``MoeCalls``). Frees the card."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg = _mixtral(dtype, layers).with_(impl=impl)
    params = init_params(cfg, seed=0, device="cuda")
    cache = T.init_cache(cfg, params, b, DEC_SLOTS)
    calls = MoeCalls() if teacher is None and dtype == "bfloat16" else None
    T.set_moe_dispatch_groups(groups)
    recs, walls, tokens = [], [], []
    try:
        with torch.no_grad(), order or contextlib.nullcontext():
            lg, cache, m = T.decode_step(
                cfg, params, {"tokens": dec_prompts(cfg, b).cuda()}, cache,
                0)
            recs.append(_dec_record(lg, m))
            tokens.append(lg[:, -1].float().argmax(-1).to(torch.int32))
            del lg
            cl = torch.full((b,), DEC_PREFILL, dtype=torch.int32,
                            device="cuda")
            with calls or contextlib.nullcontext():
                for i in range(DEC_STEPS):
                    fed = tokens[-1] if teacher is None else \
                        teacher[:, i].cuda()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache, m = T.decode_step(
                        cfg, params, {"tokens": fed[:, None]}, cache, cl + i)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    recs.append(_dec_record(lg, m))
                    tokens.append(lg[:, -1].float().argmax(-1)
                                  .to(torch.int32))
            if calls is not None:
                calls.save(os.path.join(tmp, f"moe-{layers}-{groups}.pt"),
                           layers, groups)
    finally:
        T.set_moe_dispatch_groups(1)
    out = {"steps": recs, "walls": walls}
    if teacher is None:
        out["teacher"] = torch.stack(tokens[:DEC_STEPS], 1).cpu()
        torch.save(out["teacher"], os.path.join(
            tmp, f"teacher-{dtype}-{layers}-{groups}.pt"))
    if keep_cache:
        out["cache"] = [{k: t.cpu() for k, t in c["attn"].items()}
                        for c in cache]
    del params, cache, calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dec_drift(got: dict, want: dict) -> dict:
    """How far one run's steps lie from another's: the logits' max
    |diff|, the greedy tokens that agree (of rows x steps), whether
    every step's loads and drops are equal."""
    pairs = list(zip(got["steps"], want["steps"]))
    return {"logits": max(float((a["logits"] - w["logits"]).abs().max())
                          for a, w in pairs),
            "agree": sum(int((a["logits"].argmax(-1)
                              == w["logits"].argmax(-1)).sum())
                         for a, w in pairs),
            "of": sum(a["logits"].shape[0] for a, _ in pairs),
            "loads": all(a["expert_load"] == w["expert_load"]
                         and a["dropped"] == w["dropped"] for a, w in pairs)}


def _kv_drift(got: list, want: list) -> dict:
    """{(layer, "k" or "v"): max |diff|} of two attention caches."""
    return {(i, k): float((g - w).abs().max())
            for gl, wl in zip(got, want) for k in ("k", "v")
            for i, (g, w) in enumerate(zip(gl[k], wl[k]))}


def dec_reckoning(cfg, shape, layout: dict, b: int) -> dict:
    """Bytes of a rank of the sharded decode at its peak, by this
    script's reckoning: its parameter and cache shards (the dry-run's),
    plus the prefill's largest transients: its plain attention over the
    rank's rows and slots (float32 q, and k and v widened to H heads;
    three (rows, H, DEC_PREFILL, 1024) float32 score-sized temporaries),
    the dispatch of its tokens (the (g, t, k, E, C) one-hots and the
    float32 (E, g C, D) partial, twice) and its logits (the rank's
    vocabulary columns, gathered, and over data)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    dp, mp = shape
    mesh = _logical(shape)
    variant = {"fsdp_params": False,
               "seq_over_dp": layout.get("seq_over_dp", False),
               "cache_heads_model": layout.get("heads_model", False)}
    _, args, shardings = D.build_step(
        cfg, InputShape("decode", DEC_SLOTS, b, "decode"), variant,
        mesh=mesh)
    dps, _, dcs, _ = shardings(mesh)
    params_b, cache_b = SH.shard_nbytes(args[0], dps), \
        SH.shard_nbytes(args[2], dcs)
    seq_dp = layout.get("seq_over_dp") and dp > 1
    rows = b if seq_dp else b // dp
    slots = DEC_SLOTS if layout.get("heads_model") else DEC_SLOTS // (
        dp if seq_dp else mp)
    h, hd, d = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    isz = 4 if cfg.dtype == "float32" else 2
    attn = 4 * (rows * DEC_PREFILL * h * hd + 2 * rows * slots * h * hd) \
        + 3 * 4 * rows * h * DEC_PREFILL * 1024
    t = rows * DEC_PREFILL
    g = max(1, t // 2048)
    while t % g:
        g -= 1
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = math.ceil(cfg.moe.capacity_factor * k * (t // g) / e)
    moe = 2 * t * k * e * cap * isz + e * g * cap * d * (isz + 8)
    v = cfg.vocab_size
    logits = rows * DEC_PREFILL * v * isz * (1 / mp + 1) \
        + (b * DEC_PREFILL * v * isz if rows < b else 0)
    att_w = 2 * d * (h + 2 * cfg.num_kv_heads) * hd * isz
    return {"params": params_b, "cache": cache_b,
            "peak_gb": (params_b + cache_b + att_w + max(attn, moe)
                        + logits) / 1e9}


def _dec_whole(c, shard):
    """One period's attention cache slice of this rank gathered whole
    but for its rows (every split of ``shard`` undone)."""
    from repro_torch.distributed import tensor_parallel as TP
    out = {}
    for name, dims in (("k", shard.gather_kv), ("v", shard.gather_kv),
                       ("pos", shard.gather_pos)):
        t = c[name]
        for dim, axes, _, _ in dims:
            t = TP.gather_over(t, shard.mesh, dim, axes)
        if shard.seq:
            t = TP.gather_over(t, shard.mesh, 1, shard.seq)
        out[name] = t.contiguous()
    return out


def dec_gated_pass(mesh, cfg, params, cache, cs, step, teacher,
                   cl) -> list:
    """Phase 14's bf16 gate on this rank: the decode steps again from the
    post-prefill `cache`, each attention sublayer of every step run three
    times from the same input: the rank's sharded call (whose cache goes
    on), one process's on the whole cache (gathered once, then written
    by these calls, so it stays the assembled cache) and the
    ``PlainMean`` control on a copy of the rank's cache (where the
    layout merges). Returns (step, layer, rel, ok, control rel, control
    share) records; nothing here is counted or timed."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    shards, _ = T._cache_shards(cache, cs, mesh)
    n = cfg.num_layers
    wholes = [_dec_whole(T._period(cache[0], i)["attn"], shards[0])
              for i in range(n)]
    inner, calls, gates = L.attention_block, [0], []
    tol = TOL[torch.bfloat16]

    def spy(p, cfg_, h, positions, **kw):
        layer, at = calls[0] % n, calls[0] // n + 1
        calls[0] += 1
        ctrl = {k: t.clone() for k, t in kw["cache"].items()}
        got, c = inner(p, cfg_, h, positions, **kw)
        want, _ = inner(p, cfg_, h, positions,
                        **{**kw, "cache": wholes[layer], "shard": None})
        g, w = got.float(), want.float()
        rec = {"step": at, "layer": layer,
               "rel": float((g - w).norm() / w.norm()),
               "ok": bool(((g - w).abs() <= tol + tol * w.abs()).all()
                          and torch.isfinite(g).all())}
        if kw["shard"].seq:
            with PlainMean():
                bad, _ = inner(p, cfg_, h, positions,
                               **{**kw, "cache": ctrl})
            bd = bad.float()
            rec["control_rel"] = float((bd - w).norm() / w.norm())
            rec["control_share"] = float(
                ((bd - w).abs() > tol + tol * w.abs()).float().mean())
        gates.append(rec)
        return got, c

    L.attention_block = spy
    try:
        for i in range(DEC_STEPS):
            _, cache = step(params, {"tokens": teacher[:, i:i + 1]}, cache,
                            cl + i)
    finally:
        L.attention_block = inner
    return gates


def dec_moe_gates(mesh, cfg, params, cache, cs, tmp: str, path=None,
                  positions=None, shardings=None) -> list:
    """Phase 14's bf16 MoE gate on this rank: each MoE sublayer of every
    decode step run from the one-process oracle's input (``MoeCalls``,
    saved at `path`: the rank's rows of it, where the cache's rows split
    over data) at the step's dispatch groups and data mesh, against that
    oracle's output for the same rows (``moe_sublayer_gates``, with its
    control; `positions` and `shardings`, the parameters' layout, as
    there). Nothing here is counted or timed."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    _, moe_mesh = T._cache_shards(cache, cs, mesh)
    rows = SH.shard_ranges(next(_leaves(cs)), next(_leaves(cache)).shape)[1]
    dp = mesh.shape["data"]
    io = torch.load(path or os.path.join(
        tmp, f"moe-{cfg.num_layers}-{dp}.pt"))
    if rows is None:
        ios = [[(c["x"], c["y"]) for c in calls] for calls in io]
    else:
        lo, hi = rows[1], rows[2]
        ios = [[(c["x"][lo:hi], c["blocks"][lo // (hi - lo)])
                for c in calls] for calls in io]
    T.set_moe_dispatch_groups(dp)
    try:
        return moe_sublayer_gates(mesh, cfg, params, ios, moe_mesh,
                                  positions, shardings)
    finally:
        T.set_moe_dispatch_groups(1)


class KernelShapes:
    """Within the block, each launch of ``decode_attention``, ``fused_
    gate_up`` and ``gmm`` is recorded with its operands' shapes and
    dtype (and whether it returns statistics); the launches themselves
    are the wrappers' own."""

    def __enter__(self):
        self.seen = {}
        self._fns = {(DA, "decode_attention"): DA.decode_attention,
                     (MG, "fused_gate_up"): MG.fused_gate_up,
                     (MG, "gmm"): MG.gmm}

        def wrap(name, fn):
            def run(x, w, *args, **kw):
                key = (name, tuple(x.shape), tuple(w.shape), str(x.dtype),
                       bool(kw.get("return_stats")))
                self.seen[key] = self.seen.get(key, 0) + 1
                return fn(x, w, *args, **kw)
            return run

        for (mod, name), fn in self._fns.items():
            setattr(mod, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self._fns.items():
            setattr(mod, name, fn)


def dec_run(mesh, cfg, params, ps, layout: dict, b: int, tmp: str,
            tag: str, fsdp: bool = False, ep: bool = False) -> dict:
    """One sharded decode run on this rank: the cache laid out by
    `layout`, the prefill and DEC_STEPS counted, timed decode steps
    through ``make_serve_step``, the resident bytes against the
    dry-run's (its ``fsdp_params`` and ``ep_experts`` variant: `fsdp`,
    `ep`), the peak over the decode steps, and (bf16) the gated passes:
    the MoE sublayers, and but for `ep` (phase 17, whose attention is
    phase 14's) the attention sublayers; float32 keeps its final cache
    shards in `tmp`."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    whole = T.init_cache(cfg, params, b, DEC_SLOTS)
    cs = SH.cache_shardings(whole, mesh, **layout)
    held = SH.shard_tree(whole, cs, copy=True)
    del whole
    torch.cuda.empty_cache()
    variant = {"fsdp_params": fsdp, "ep_experts": ep,
               "seq_over_dp": layout.get("seq_over_dp", False),
               "cache_heads_model": layout.get("heads_model", False)}
    _, args, shardings = D.build_step(
        cfg, InputShape("decode", DEC_SLOTS, b, "decode"), variant,
        mesh=mesh)
    dps, _, dcs, _ = shardings(mesh)
    rec = {"resident": {"params": _nbytes(params), "cache": _nbytes(held)},
           "reckoned": {"params": SH.shard_nbytes(args[0], dps),
                        "cache": SH.shard_nbytes(args[2], dcs)},
           "specs": [{k: tuple(s.spec) for k, s in c["attn"].items()}
                     for c in cs]}
    step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
    teacher = torch.load(os.path.join(
        tmp, f"teacher-{cfg.dtype}-{cfg.num_layers}-"
        f"{mesh.shape['data']}.pt")).cuda()
    cl = torch.full((b,), DEC_PREFILL, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        mesh.host_ms.clear()
        mesh.nbytes.clear()
        t0 = time.perf_counter()
        lg, held = step(params, {"tokens": dec_prompts(cfg, b)}, held, 0)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_collective_ms"] = dict(mesh.host_ms)
        steps = [_dec_record(lg, step.metrics)]
        del lg
        snap = clone_tree(held) if cfg.dtype == "bfloat16" and not ep \
            else None
        prefill_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec["held_before_steps"] = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        mesh.host_ms.clear()
        mesh.nbytes.clear()
        walls = []
        with KernelShapes() as shapes:
            for i in range(DEC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, held = step(params, {"tokens": teacher[:, i:i + 1]},
                                held, cl + i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                steps.append(_dec_record(lg, step.metrics))
        rec.update(steps=steps, walls=walls,
                   launches=dict(K.launch_counts()),
                   shapes=dict(shapes.seen),
                   collective_ms=dict(mesh.host_ms),
                   collective_bytes=dict(mesh.nbytes),
                   steps_peak=torch.cuda.max_memory_allocated())
        rec["peak_gb"] = max(prefill_peak, rec["steps_peak"]) / 1e9
        if snap is not None:
            rec["gates"] = dec_gated_pass(mesh, cfg, params, snap, cs, step,
                                          teacher, cl)
            del snap
        if cfg.dtype == "bfloat16":
            rec["moe_gates"] = dec_moe_gates(mesh, cfg, params, held, cs,
                                             tmp, shardings=ps)
    if cfg.dtype == "float32":
        rec["cache_file"] = os.path.join(tmp, f"{tag}-cache{mesh.rank}.pt")
        torch.save([{k: t.cpu() for k, t in c["attn"].items()}
                    for c in held], rec["cache_file"])
    del held, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dec_rank(rank: int, shape: tuple, tmp: str, jobs: list,
             state_jobs: list = (), ep_b: int = 0) -> dict:
    """One rank of phases 14, 16 and 17 on a (data, model) = `shape`
    mesh: for each job (dtype, layers, {name: layout}, batch), this
    rank's parameter shards (``_rank_shards``), then ``dec_run`` under
    each layout in turn; then phase 16's ``state_run`` of each of
    `state_jobs` (arch, dtype, layout, fsdp); then, with `ep_b` (the
    decode cell's rows), phase 17 (``ep_rank``). Everything returned
    lives on the host."""
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_process_mesh(*shape, device="cuda:0",
                             transport="shared")
    out = {"rank": rank, "coords": mesh.coords, "runs": {}}
    for dtype, layers, layouts, b in jobs:
        cfg = _mixtral(dtype, layers)
        params, ps = _rank_shards(mesh, cfg)
        for name, layout in layouts.items():
            out["runs"][dtype, name] = dec_run(
                mesh, cfg, params, ps, layout, b, tmp,
                f"{shape[0]}x{shape[1]}-{dtype}-{name}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["state_runs"] = {(arch, dtype, layout): state_run(
        mesh, arch, dtype, layout, fsdp, tmp)
        for arch, dtype, layout, fsdp in state_jobs}
    if ep_b:
        out["ep"] = ep_rank(mesh, shape, tmp, ep_b)
    return out


def _dec_launch_gate(name, cfg, run, want: dict, shard_s: int,
                     stats: bool, rows: int, fails: list) -> str:
    """The kernels of one run's decode steps: each launched `want[name]`
    times (once a sublayer a step), decode attention at `shard_s` slots
    (with statistics where `stats`: the slots are a sequence shard), the
    expert kernels at F/model and C `rows` (``dec_kernel_shapes`` holds
    them there), on "mma"/"wgmma" at bf16 and "simt" at float32; a failed
    gate's message goes to `fails`."""
    bf16 = cfg.dtype == "bfloat16"
    for k_name, n in want.items():
        if run["launches"][k_name] != n:
            fails.append(f"{name}: {k_name} launched "
                         f"{run['launches'][k_name]} times, not once a "
                         f"sublayer a step ({n})")
    paths = []
    for (k_name, xs, ws, dt, got_stats), n in run["shapes"].items():
        dtype = getattr(torch, dt.split(".")[-1])
        x = torch.empty(xs, dtype=dtype, device="cuda")
        w = torch.empty(ws, dtype=dtype, device="cuda")
        if k_name == "decode_attention":
            path = DA.kernel_path(x, w, w)[0]
            ok = ws[1] == shard_s and got_stats == stats \
                and path == ("mma" if bf16 else "simt")
        else:
            path = MG.kernel_path(x, w, k_name == "fused_gate_up")[0]
            ok = cfg.moe.d_ff // 2 in (ws[1], ws[2]) and xs[1] == rows \
                and path == ("wgmma" if bf16 else "simt")
        if not ok:
            fails.append(f"{name}: {k_name} at {xs} x {ws} "
                         f"(statistics {got_stats}) took {path}")
        paths.append(f"{n} {k_name} {xs}x{ws} {path}"
                     + (" stats" if got_stats else ""))
        del x, w
    return "; ".join(paths) or "no kernel on its path"


def _dec_bf16_gate(name, run, merges: bool, fails: list) -> str:
    """Phase 14's bf16 gate on one run's gated pass (``dec_gated_pass``);
    a failed gate's message goes to `fails`."""
    g = run["gates"]
    if len(g) != DEC_STEPS * len({r["layer"] for r in g}):
        fails.append(f"{name}: {len(g)} gated sublayers")
    for r in g:
        if not (r["ok"] and r["rel"] <= DEC_REL):
            fails.append(f"{name} step {r['step']} layer {r['layer']}: rel "
                         f"{r['rel']:.3e} (held to {DEC_REL}), elementwise "
                         f"within {TOL[torch.bfloat16]}: {r['ok']}")
        if merges and r["step"] < DEC_CROSS and \
                r["control_rel"] <= DEC_CONTROL * DEC_REL:
            fails.append(f"{name} step {r['step']} layer {r['layer']}: the "
                         f"control moved only {r['control_rel']:.3e}")
    text = (f"attention sublayers against one process on the whole cache: "
            f"rel {min(r['rel'] for r in g):.2e}-"
            f"{max(r['rel'] for r in g):.2e} (held to {DEC_REL}), all "
            f"within atol=rtol={TOL[torch.bfloat16]}: "
            f"{all(r['ok'] for r in g)}")
    if merges:
        early = [r for r in g if r["step"] < DEC_CROSS]
        late = [r for r in g if r["step"] >= DEC_CROSS]
        text += (f"; the control (plain mean) before step {DEC_CROSS}: "
                 f"rel {min(r['control_rel'] for r in early):.3f}-"
                 f"{max(r['control_rel'] for r in early):.3f}, "
                 f"{min(r['control_share'] for r in early):.3f}-"
                 f"{max(r['control_share'] for r in early):.3f} of the "
                 f"elements out of tolerance; from step {DEC_CROSS}: rel "
                 f"{min(r['control_rel'] for r in late):.3f}-"
                 f"{max(r['control_rel'] for r in late):.3f}")
    else:
        text += "; no sequence split, no merge: the control does not apply"
    return text


def _dec_report(name, cfg, run, one, rec, card) -> str:
    coll = {k: round(v / DEC_STEPS, 2) for k, v in
            run["collective_ms"].items()}
    gathered = {k: round(v / DEC_STEPS / 1e6, 2) for k, v in
                run["collective_bytes"].items() if "all_gather" in k}
    return (f"  {name}: decode step wall median "
            f"{float(np.median(run['walls'])):.1f} ms (one process "
            f"{float(np.median(one['walls'])):.1f}); prefill "
            f"{run['prefill_ms']:.0f} ms; host ms a step by collective "
            f"{coll}; MB gathered a step {gathered}; resident "
            f"{run['resident']} bytes "
            f"{'==' if run['resident'] == run['reckoned'] else '!='} the "
            f"dry-run's; peak "
            f"{run['peak_gb']:.2f} GB (reckoned {rec['peak_gb']:.2f}); on "
            f"{card}")


def _dec_moe_gate(name, cfg, run, fails: list, want=None) -> str:
    """Phase 14's bf16 MoE gate on one run's records (``dec_moe_gates``;
    `want` of them, default one a layer a step); a failed gate's message
    goes to `fails`."""
    g = run["moe_gates"]
    if len(g) != (DEC_STEPS * cfg.num_layers if want is None else want):
        fails.append(f"{name}: {len(g)} gated MoE sublayers")
    tol = TOL[torch.bfloat16]
    for r in g:
        if not (r["ok"] and r["finite"] and r["rel"] <= DEC_REL):
            fails.append(f"{name} MoE layer {r['layer']}: rel "
                         f"{r['rel']:.3e} (held to {DEC_REL}), max |err| "
                         f"{r['max_abs_err']:.3e}, elementwise within "
                         f"{tol}: {r['ok']}")
        if r["control_share"] <= TP_CONTROL_SHARE or \
                r["control_rel"] <= DEC_CONTROL * DEC_REL:
            fails.append(f"{name} MoE layer {r['layer']}: the control left "
                         f"{r['control_share']:.3f} of the elements out of "
                         f"tolerance, rel {r['control_rel']:.3e}")
    return (f"MoE sublayers from the one-process input: rel "
            f"{min(r['rel'] for r in g):.2e}-{max(r['rel'] for r in g):.2e}"
            f" (held to {DEC_REL}), max |err| "
            f"{max(r['max_abs_err'] for r in g):.3e}, all within "
            f"atol=rtol={tol}: {all(r['ok'] for r in g)}; the control "
            f"(rank 1's partial skipped): "
            f"{min(r['control_share'] for r in g):.3f}-"
            f"{max(r['control_share'] for r in g):.3f} of the elements out "
            f"of tolerance (held above {TP_CONTROL_SHARE}), rel "
            f"{min(r['control_rel'] for r in g):.3f}-"
            f"{max(r['control_rel'] for r in g):.3f} (held above "
            f"{DEC_CONTROL * DEC_REL:.1f})")


def _dec_kv_gate(shape, ranks, key, one, fails: list) -> dict:
    """The float32 cache assembled from the ranks' shards after the last
    step against the oracle's (positions exact, K/V at DEC_KV_TOL in the
    first layer and DEC_KV_DEEP_TOL after), beside the ``ExpertHalves``
    witness's drift from the oracle and the ranks' from the witness; a
    failed gate's message goes to `fails`."""
    from repro_torch.distributed import sharding as SH
    mesh = _logical(shape)
    parts = [torch.load(r["runs"][key]["cache_file"]) for r in ranks]
    specs = ranks[0]["runs"][key]["specs"]
    got = []
    for j in range(len(one["cache"])):
        got.append({k: SH.assemble([p[j][k] for p in parts], SH.NamedSharding(
            mesh, SH.P(*specs[j][k]))) for k in ("k", "v", "pos")})
        if not torch.equal(got[j]["pos"], one["cache"][j]["pos"]):
            fails.append(f"{shape} float32: the assembled cache's "
                         "positions differ")
    errs = _kv_drift(got, one["cache"])
    for g, w in zip(got, one["cache"]):
        for k in ("k", "v"):
            # one period a layer: index 0 is the first layer
            for i, (a, b) in enumerate(zip(g[k], w[k])):
                tol = DEC_KV_TOL if i == 0 else DEC_KV_DEEP_TOL
                if not torch.allclose(a, b, atol=tol, rtol=tol):
                    fails.append(f"{shape} float32: the assembled cache's "
                                 f"layer {i} {k} {errs[i, k]:.3e} off, "
                                 f"beyond atol=rtol={tol}")
    wit = _kv_drift(one["witness_cache"], one["cache"])
    to_wit = _kv_drift(got, one["witness_cache"])

    def fmt(d):
        return {f"{i} {k}": f"{e:.3e}" for (i, k), e in d.items()}
    log(f"  {shape} float32: the cache assembled from the ranks' shards "
        f"after the last step: positions equal; K/V max |err| by layer "
        f"{fmt(errs)} (layer 0 held to {DEC_KV_TOL}, the rest to "
        f"{DEC_KV_DEEP_TOL}); the witness, one process with the expert "
        f"partials summed in two halves (ExpertHalves), against the "
        f"oracle {fmt(wit)}; the ranks' cache against the witness "
        f"{fmt(to_wit)}")
    return {"kv_err": fmt(errs), "witness": fmt(wit),
            "ranks_to_witness": fmt(to_wit)}


def dec_gates(shape, ranks, oracle, b, card, fails: list) -> dict:
    """Phase 14 (b)'s gates on one mesh's ranks (module docstring); a
    failed gate's message goes to `fails`. Returns the record."""
    out = {}
    for key in ranks[0]["runs"]:
        dtype, layout = key
        cfg = _mixtral(dtype, DEC_F32_LAYERS if dtype == "float32"
                       else DEC_BF16_LAYERS if shape == (1, 2)
                       else DEC_22_LAYERS)
        one = oracle[dtype]
        rec = dec_reckoning(cfg, shape, DEC_LAYOUTS[layout], b)
        # a sequence split merges; cache_heads_model splits none
        merges = layout != "cache_heads_model"
        for r in ranks:
            run = r["runs"][key]
            name = f"{shape} {dtype} {layout} rank {r['rank']}"
            if merges != any(c.endswith("/softmax")
                             for c in run["collective_ms"]):
                fails.append(f"{name}: the merge ran {not merges}, where "
                             f"the layout asks {merges}")
            if run["resident"] != run["reckoned"]:
                fails.append(f"{name}: resident {run['resident']} != the "
                             f"dry-run's {run['reckoned']}")
            shard_s = DEC_SLOTS // shape[1] if layout == "default" else \
                DEC_SLOTS // shape[0] if shape[0] > 1 and \
                layout == "seq_over_dp" else DEC_SLOTS
            paths = _dec_launch_gate(
                name, cfg, run, dict.fromkeys(
                    ("decode_attention", "fused_gate_up", "gmm"),
                    DEC_STEPS * cfg.num_layers), shard_s,
                shard_s < DEC_SLOTS, _dec_expert_rows(cfg, b, shape, layout),
                fails)
            drift = _dec_drift(run, one)
            for i, (got, want) in enumerate(zip(run["steps"],
                                                one["steps"])):
                if dtype == "float32" and not torch.allclose(
                        got["logits"], want["logits"],
                        atol=TOL[torch.float32], rtol=TOL[torch.float32]):
                    err = float((got["logits"] - want["logits"]).abs()
                                .max())
                    fails.append(f"{name} step {i}: logits {err:.3e} off")
            same_tok = drift["agree"] == drift["of"]
            if dtype == "float32" and not (same_tok and drift["loads"]):
                fails.append(f"{name}: greedy tokens equal {same_tok}, "
                             f"loads and drops equal {drift['loads']}")
            text = (f"  {name}: prefill + {DEC_STEPS} steps, logits max "
                    f"|ranks - one process| {drift['logits']:.3e} "
                    + (f"(held to {TOL[torch.float32]})"
                       if dtype == "float32" else
                       f"(reported; one process at impl ref: "
                       f"{one['witness']['logits']:.3e})")
                    + f"; greedy tokens {'equal' if same_tok else 'DIFFER'}"
                    f" ({drift['agree']} of {drift['of']} rows and steps "
                    f"agree); loads and drops "
                    f"{'equal' if drift['loads'] else 'DIFFER'}; launches "
                    f"{ {k: run['launches'][k] for k in ('decode_attention', 'fused_gate_up', 'gmm')} }"
                    f" ({paths})")
            if dtype == "bfloat16":
                text += "; " + _dec_bf16_gate(name, run, merges, fails) \
                    + "; " + _dec_moe_gate(name, cfg, run, fails)
            log(text)
            log(_dec_report(name, cfg, run, one, rec, card))
        out[f"{dtype} {layout}"] = {
            "walls_ms": [float(np.median(r["runs"][key]["walls"]))
                         for r in ranks],
            "one_process_ms": float(np.median(one["walls"])),
            "logits_drift": drift["logits"],
            "launches": [{k: r["runs"][key]["launches"][k]
                          for k in ("decode_attention", "fused_gate_up",
                                    "gmm")} for r in ranks],
            "peak_gb": [r["runs"][key]["peak_gb"] for r in ranks],
            "reckoned_peak_gb": rec["peak_gb"]}
        if dtype == "float32":
            out[f"{dtype} {layout}"]["cache"] = _dec_kv_gate(
                shape, ranks, key, one, fails)
        else:
            out[f"{dtype} {layout}"]["moe_rel"] = max(
                g["rel"] for r in ranks for g in r["runs"][key]["moe_gates"])
    return out


def _dec_oracles(shape, b: int, tmp: str) -> dict:
    """The one-process oracles of one mesh's runs, each dtype's, and
    their witnesses: at float32 the same steps in ``ExpertHalves`` (its
    cache kept), at bf16 at impl "ref" (``_dec_drift`` from the
    oracle)."""
    dp = shape[0]
    out = {}
    for dtype in (("float32", "bfloat16") if shape == (1, 2)
                  else ("bfloat16",)):
        layers = DEC_F32_LAYERS if dtype == "float32" else \
            DEC_BF16_LAYERS if shape == (1, 2) else DEC_22_LAYERS
        one = dec_oracle(dtype, layers, dp, b, tmp,
                         keep_cache=dtype == "float32")
        if dtype == "float32":
            one["witness_cache"] = dec_oracle(
                dtype, layers, dp, b, tmp, teacher=one["teacher"],
                order=ExpertHalves(), keep_cache=True)["cache"]
        else:
            ref = dec_oracle(dtype, layers, dp, b, tmp, impl="ref",
                             teacher=one["teacher"])
            one["witness"] = _dec_drift(ref, one)
            w = one["witness"]
            log(f"  the witness on {shape}: one process at impl ref "
                f"against one process on the kernels, bf16, {layers} "
                f"layers, fed the same tokens: logits max |diff| "
                f"{w['logits']:.3e}; greedy tokens agree in {w['agree']} of "
                f"{w['of']} rows and steps; loads and drops "
                f"{'equal' if w['loads'] else 'DIFFER'}")
        out[dtype] = one
    return out


def dec_phase(card: str, zero2=None) -> dict:
    """Phases 14, 16 and 17 on one spawn of ranks a mesh. Phase 14: (a)
    the statistics kernel at the shard and the expert kernels at the
    decode F-shard shapes; the one-process oracles and their witnesses
    in this process, which then holds nothing on the card; (b) the (1,
    2) ranks (float32, then bf16, at 2 layers) and the (2, 2) ranks
    (bf16 at 1 layer under each layout); gated as the module docstring
    says. Phase 16 (``ST_RUNS``): its kernels at their new geometries,
    its oracles after phase 14's, its runs on the same ranks after phase
    14's, gated as its constants' comment says; its record is the
    returned record's "state". Phase 17 (``EP_SERVE``): its kernels, its
    prefill oracles after phase 16's, its runs on the same ranks last,
    gated as its constants' comment says, training against `zero2`
    (phase 13's (2, 2) ZeRO-2 record); its record is the returned
    record's "ep"."""
    t14 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    res, fails, fails16, fails17 = {"kernel": stats_kernel_check(gen)}, \
        [], [], []
    # cut the (2, 2) batch, never widths or depth, where four ranks at the
    # reckoned peak would not fit beside this process
    b22 = DEC_B
    cfg22 = _mixtral("bfloat16", DEC_22_LAYERS)
    while b22 > 2 and 4 * max(dec_reckoning(cfg22, (2, 2), lay, b22)
                              ["peak_gb"] for lay in DEC_LAYOUTS.values()) \
            > 0.85 * torch.cuda.get_device_properties(0).total_memory / 1e9:
        b22 //= 2
    rows = [_dec_expert_rows(cfg22, DEC_B, (1, 2), "default")] + sorted(
        {_dec_expert_rows(cfg22, b22, (2, 2), lay) for lay in DEC_LAYOUTS})
    res["expert_shapes"] = dec_kernel_shapes(gen, rows)
    for shape, dtype, layers, b in (((1, 2), "float32", DEC_F32_LAYERS, DEC_B),
                                    ((1, 2), "bfloat16", DEC_BF16_LAYERS,
                                     DEC_B),
                                    ((2, 2), "bfloat16", DEC_22_LAYERS, b22)):
        rec = dec_reckoning(_mixtral(dtype, layers), shape, {}, b)
        log(f"  mixtral-8x7b, {layers} of 32 layers, {dtype}, B {b}, a "
            f"{DEC_SLOTS}-slot cache on (data, model) = {shape}: "
            f"{rec['params'] / 1e9:.2f} GB of parameters and "
            f"{rec['cache'] / 1e9:.3f} GB of cache a rank (the dry-run's), "
            f"~{rec['peak_gb']:.1f} GB at the prefill by the reckoning"
            + (f" (batch cut from {DEC_B})" if b != DEC_B else ""))
    jobs = {(1, 2): [("float32", DEC_F32_LAYERS, {"default": {}}, DEC_B),
                     ("bfloat16", DEC_BF16_LAYERS, {"default": {}}, DEC_B)],
            (2, 2): [("bfloat16", DEC_22_LAYERS, DEC_LAYOUTS, b22)]}
    t16 = time.perf_counter()
    log("[16] the sharded decode step of recurrent and encoder-decoder "
        "caches (phase 14's ranks serve it, after phase 14's runs): (a) "
        "its kernels at their new geometries")
    state = {"kernels": state_kernel_shapes(gen)}
    spent16 = time.perf_counter() - t16
    t17 = time.perf_counter()
    log("[17] the expert-parallel layout (ep_experts; phase 14's ranks "
        "serve it, after phase 16's runs): (a) fused_gate_up and gmm at "
        "E/2 experts with F whole")
    ep = {"kernels": ep_kernel_shapes(gen, b22)}
    for shape, (layers, fsdp) in EP_SERVE.items():
        cfg = _mixtral("bfloat16", layers)
        log(f"  mixtral-8x7b, {layers} of 32 layers, bf16, on (data, "
            f"model) = {shape}, {'ZeRO-3' if fsdp else 'fsdp=False'}, "
            f"each rank {cfg.moe.num_experts // shape[1]} whole experts: "
            f"the {TP_PREFILL_B} x {TP_PREFILL_S} prefill and the decode "
            f"cell" + (", then phase 15's training step" if shape == (2, 2)
                       else "") + f"; one period's expert banks "
            f"{ep_bank_bytes(cfg) / 1e9:.3f} GB by the reckoning")
    spent17 = [time.perf_counter() - t17]
    groups16 = {}
    for shape, runs in ST_RUNS.items():
        for arch, dtype, _, _ in runs:
            cfg = state_config(arch, dtype)
            g = shape[0] if cfg.is_moe else 1
            if groups16.setdefault((arch, dtype), g) != g:
                raise AssertionError(f"phase 16: {arch} {dtype} runs at two "
                                     "dispatch-group counts; one oracle "
                                     "serves it")
    for shape, runs in ST_RUNS.items():
        for arch, dtype, layout, fsdp in runs:
            cfg = state_config(arch, dtype)
            log(f"  {arch}, {cfg.num_layers} layers, {dtype}, B {ST_B}, a "
                f"{ST_SLOTS}-slot cache, a {ST_PREFILL}-token prefill and "
                f"{ST_STEPS} steps on (data, model) = {shape} under "
                f"{layout}" + (", ZeRO-3 parameters" if fsdp else ""))

    def oracle(tmp, held):
        t0 = time.perf_counter()
        one = {shape: _dec_oracles(shape, job[0][3], tmp)
               for shape, job in jobs.items()}
        log(f"  the one-process oracles and their witnesses "
            f"{time.perf_counter() - t0:.1f} s (decode step walls: float32 "
            f"{DEC_F32_LAYERS} layers "
            f"{float(np.median(one[(1, 2)]['float32']['walls'])):.1f} "
            f"ms, bf16 {DEC_BF16_LAYERS} layers "
            f"{float(np.median(one[(1, 2)]['bfloat16']['walls'])):.1f}"
            f", bf16 {DEC_22_LAYERS} layers at dispatch groups 2 "
            f"{float(np.median(one[(2, 2)]['bfloat16']['walls'])):.1f}"
            ")")
        t0 = time.perf_counter()
        one["state"] = {key: state_oracle(*key, g, tmp)
                        for key, g in groups16.items()}
        spent[1] = time.perf_counter() - t0
        log(f"  [16] the one-process oracles {spent[1]:.1f} s (decode step "
            "walls: " + ", ".join(
                f"{a} {d} {float(np.median(o['walls'])):.1f} ms"
                for (a, d), o in one["state"].items())
            + f"); this process holds {held / 1e6:.1f} MB on the card "
            "while the ranks run")
        t0 = time.perf_counter()
        one["ep"] = ep_prefill_oracle(tmp)
        spent17[0] += time.perf_counter() - t0
        log(f"  [17] the one-process prefill oracles "
            f"{time.perf_counter() - t0:.1f} s (walls: " + ", ".join(
                f"{shape} {o['wall_ms']:.1f} ms"
                for shape, o in one["ep"].items()) + ")")
        return one

    def gate(shape, ranks, one):
        out = dec_gates(shape, ranks, one[shape], jobs[shape][0][3], card,
                        fails)
        t0 = time.perf_counter()
        state[str(shape)] = state_gates(shape, ranks, one["state"], card,
                                        fails16)
        # the ranks run phase 16 after phase 14, one rank at a time in
        # step: the slowest rank's runs are the phase's share of the spawn
        spent[0] += max(sum(v["seconds"] for v in r["state_runs"].values())
                        for r in ranks) + time.perf_counter() - t0
        t0 = time.perf_counter()
        ep[str(shape)] = ep_gates(
            shape, ranks, one["ep"][shape], one[shape]["bfloat16"],
            jobs[shape][0][3], card, fails17,
            zero2 if shape == (2, 2) else None)
        spent17[0] += max(r["ep"]["seconds"] for r in ranks) \
            + time.perf_counter() - t0
        return out

    spent = [spent16, 0.0]
    got = against_one_process(
        oracle, dec_rank, [(shape, (job, ST_RUNS[shape],
                                    job[0][3] if shape in EP_SERVE else 0))
                           for shape, job in jobs.items()], gate, 900.0)
    res.update({str(shape): r for shape, r in got.items()})
    state["seconds"] = spent[0] + spent[1]
    ep["seconds"] = spent17[0]
    res["seconds"] = time.perf_counter() - t14 - state["seconds"] \
        - ep["seconds"]
    res["state"], res["ep"] = state, ep
    log(f"  phase 14 took {res['seconds']:.1f} s, phase 16 "
        f"{state['seconds']:.1f} s and phase 17 {ep['seconds']:.1f} s "
        "(each its kernels, oracles, its runs on the slowest rank and its "
        "gates; one spawn of ranks a mesh served all three)")
    if fails or fails16 or fails17:
        raise AssertionError("; ".join(
            [f"phase 14: {f}" for f in fails]
            + [f"phase 16: {f}" for f in fails16]
            + [f"phase 17: {f}" for f in fails17]))
    return res


# ------------------------------------------------------------ phase 16

# phase 16: the sharded decode step of recurrent and encoder-decoder
# caches, make_serve_step(param_shardings=, cache_shardings=) for
# jamba-v0.1-52b (Mamba state, an attention cache, experts), xlstm-125m
# (mLSTM and sLSTM state) and whisper-base (a self-attention cache,
# cross-attention over the encoder output) at their published widths,
# on phase 14's ranks (one spawn of ranks a mesh serves both phases, so
# the script pays for two spawns, not four). ST_B prompts prefilled at
# ST_PREFILL tokens into an ST_SLOTS-slot cache, then ST_STEPS decode
# steps fed the one-process oracle's greedy tokens, impl "auto"; step
# ST_CROSS writes the first token into the second half of the slots
# (rank 1's under a sequence split over model). whisper-base's prefill
# takes its frame embeddings (the rank runs the encoder on its rows, its
# weights gathered at use), its steps the oracle's encoder output, and
# one length for the batch; the others per-row lengths. ST_RUNS: (arch,
# dtype, cache layout of DEC_LAYOUTS, fsdp) by mesh. jamba-v0.1-52b runs
# one 8-layer period of 32 (ST_JAMBA_LAYERS: 13.3 B parameters, 26.6 GB
# in bf16, a rank's shard ~13.3 GB), bf16 only: at float32 the period
# is 53 GB, and one rank's whole copy beside the other's shard does not
# fit the card. Gates, set before the run: float32, every step's logits
# within TOL[float32] of one process, greedy tokens equal, every cache
# leaf assembled from the ranks' shards within ST_STATE_TOL (positions
# exactly); bf16, each attention sublayer as phase 14 gates it (its
# PlainMean control before ST_CROSS), each recurrent mixer of every step
# against one process's on the whole state from the same input and
# state, its output and its new state within DEC_REL in norm (the output
# also within TOL[bf16] elementwise), the control (the rank writing back
# the other rank's slice of the first split leaf) moving the new state
# past DEC_CONTROL x DEC_REL; every MoE sublayer as phase 14's (its
# SkipPartial control); the kernels launched once a sublayer a step at
# the shard's S (statistics where the sequence splits) and F/2 and the
# run's C; each rank's parameter and cache bytes the dry-run's.
ST_B, ST_SLOTS, ST_PREFILL, ST_STEPS = 8, 256, 126, 4
ST_CROSS = ST_SLOTS // 2 - ST_PREFILL + 1
ST_JAMBA_LAYERS = 8
ST_STATE_TOL = 1e-4
ST_RUNS = {(1, 2): [("xlstm-125m", "float32", "default", False),
                    ("whisper-base", "float32", "cache_heads_model", False),
                    ("jamba-v0.1-52b", "bfloat16", "default", False)],
           (2, 2): [("xlstm-125m", "bfloat16", "seq_over_dp", False),
                    ("whisper-base", "float32", "default", True)]}
# (a)'s decode attention rows at each new shard: kv_len and query
# position a row (rows with none visible, lanes across the shard's end),
# and the merged rows' kv_len over two shards
ST_ATTN = {
    "jamba-v0.1-52b": dict(
        lens=[0, 1, 17, 64, 127, 128, 100, 90],
        qpos=[0, 0, 16, 63, 126, 127, -1, 89],
        merge_lens=[1, 17, 127, 128, 129, 200, 256, 100]),
    "whisper-base": dict(lens=[0, 17, 128, 100], qpos=[0, 16, 127, -1],
                         merge_lens=[1, 128, 129, 256])}


def state_config(arch: str, dtype: str):
    """`arch` at its published widths, impl "auto"; jamba-v0.1-52b one
    period deep."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(dtype=dtype, impl="auto")
    return cfg.with_(num_layers=ST_JAMBA_LAYERS) \
        if arch == "jamba-v0.1-52b" else cfg


def state_inputs(cfg):
    """Seeded prompts (ST_B, ST_PREFILL) on the host and, for an
    encoder-decoder, frame embeddings (ST_B, T, D) of unit scale in the
    model's dtype (else None)."""
    gen = torch.Generator().manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (ST_B, ST_PREFILL),
                         generator=gen, dtype=torch.int32)
    if cfg.encdec is None:
        return toks, None
    emb = torch.randn((ST_B, cfg.encdec.encoder_seq_len, cfg.d_model),
                      generator=gen)
    return toks, emb.to(getattr(torch, cfg.dtype))


def _st_len(cfg, at: int):
    """A step's cache length: one int for an encoder-decoder, per-row
    lengths otherwise."""
    return at if cfg.encdec is not None else \
        torch.full((ST_B,), at, dtype=torch.int32, device="cuda")


def _st_count(cfg, what) -> int:
    """How many sublayers of `cfg`'s stack `what(sub)` holds for."""
    from repro_torch.models import transformer as T
    pattern = T.layer_pattern(cfg)
    return cfg.num_layers // len(pattern) * sum(map(what, pattern))


def _moe_positions(cfg) -> list:
    """(pattern position, period) of each MoE sublayer, in the order a
    step runs them."""
    from repro_torch.models import transformer as T
    pattern = T.layer_pattern(cfg)
    return [(j, i) for i in range(cfg.num_layers // len(pattern))
            for j, sub in enumerate(pattern) if sub.ffn == "moe"]


def _cache_leaves(cache) -> dict:
    """{"position/mixer/key": leaf} of a cache tree (or of its
    shardings)."""
    from repro_torch.models import transformer as T
    return {"/".join(map(str, (j, mixer) + path)): t
            for j, c in enumerate(cache) for mixer, sub in c.items()
            for path, t in T._leaf_paths(sub)}


def _whole_cache(cfg):
    """The empty whole decode cache of `cfg` (ST_B rows, ST_SLOTS slots)
    on the card, built from the parameters' shapes: a rank holds only
    its shards, and ``init_cache`` reads the state's widths off the
    parameters (stand-ins of one element, strides 0)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.model import abstract_params
    like = SH.tree_map(lambda t: torch.empty_strided(
        tuple(t.shape), (0,) * t.dim(), dtype=t.dtype, device="cuda"),
        abstract_params(cfg))
    return T.init_cache(cfg, like, ST_B, ST_SLOTS)


def state_oracle(arch: str, dtype: str, groups: int, tmp: str) -> dict:
    """Phase 16's one-process run of `arch` at `dtype` on the kernels
    (``transformer.decode_step``, what the one-process serve step runs)
    at dispatch groups `groups`: the prefill and ST_STEPS greedy steps,
    each step's record, the walls; its greedy tokens (and whisper's
    encoder output) go to `tmp` for the ranks, at bf16 its MoE
    sublayers' decode calls (``MoeCalls``), at float32 its final cache
    on the host. Frees the card."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg = state_config(arch, dtype)
    params = init_params(cfg, seed=0, device="cuda")
    cache = T.init_cache(cfg, params, ST_B, ST_SLOTS)
    toks, emb = state_inputs(cfg)
    batch, extra = {"tokens": toks.cuda()}, {}
    if emb is not None:
        batch["enc_embeds"] = emb.cuda()
        with torch.no_grad():
            extra["enc_out"] = T.run_encoder(cfg, params,
                                             batch["enc_embeds"])
        torch.save(extra["enc_out"].cpu(),
                   os.path.join(tmp, f"enc-{arch}-{dtype}.pt"))
    calls = MoeCalls() if cfg.is_moe and dtype == "bfloat16" else None
    T.set_moe_dispatch_groups(groups)
    recs, walls, tokens = [], [], []
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache, m = T.decode_step(cfg, params, batch, cache, 0)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            recs.append(_dec_record(lg, m))
            tokens.append(lg[:, -1].float().argmax(-1).to(torch.int32))
            del lg
            with calls or contextlib.nullcontext():
                for i in range(ST_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache, m = T.decode_step(
                        cfg, params, {"tokens": tokens[-1][:, None],
                                      **extra}, cache,
                        _st_len(cfg, ST_PREFILL + i))
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    recs.append(_dec_record(lg, m))
                    tokens.append(lg[:, -1].float().argmax(-1)
                                  .to(torch.int32))
            if calls is not None:
                calls.save(os.path.join(tmp, f"moe-{arch}-{groups}.pt"),
                           _st_count(cfg, lambda s: s.ffn == "moe"), groups)
    finally:
        T.set_moe_dispatch_groups(1)
    torch.save(torch.stack(tokens[:ST_STEPS], 1).cpu(),
               os.path.join(tmp, f"teacher-{arch}-{dtype}.pt"))
    out = {"steps": recs, "walls": walls, "prefill_ms": prefill_ms}
    if dtype == "float32":
        out["cache"] = {k: t.cpu() for k, t in _cache_leaves(cache).items()}
    del params, cache, calls, extra, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _swapped(shard: tuple) -> tuple:
    """The control of phase 16's mixer gate: a mixer's records
    (``layers.StateShard``, one a leaf) with the first split leaf's
    first split moved one slice over (mod the whole dim): the rank
    writes back the other rank's slice of it, its gathers untouched."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    out = list(shard)
    for n, r in enumerate(out):
        if r.splits:
            (dim, axes, lo, hi), *rest = r.splits
            w = hi - lo
            lo = (lo + w) % (w * SH._axis_size(r.mesh, axes))
            out[n] = L.StateShard(r.mesh, ((dim, axes, lo, lo + w), *rest))
            return tuple(out)
    raise AssertionError("no split state leaf to swap")


def state_gated_pass(mesh, cfg, params, cache, cs, step, teacher,
                     extra) -> list:
    """Phase 16's bf16 gate on this rank: the decode steps again from the
    post-prefill `cache`. Each attention sublayer of every step runs as
    phase 14's gate runs it (the rank's call, one process's on the whole
    cache gathered once, the ``PlainMean`` control where the layout
    merges); each recurrent mixer from the same input three times: the
    rank's call (whose state goes on), one process's on the whole state
    gathered just before it, and the rank's call on a copy of its shards
    with the first split leaf's slice swapped on write-back
    (``_swapped``). Returns records (kind, step, rel of the output,
    elementwise ok, rel of the new state, the control's); nothing here
    is counted or timed."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    shards, _ = T._cache_shards(cache, cs, mesh)
    pattern = T.layer_pattern(cfg)
    wholes = {}
    for j, sub in enumerate(pattern):
        if sub.mixer == "attn":
            for i in range(cfg.num_layers // len(pattern)):
                c = T._period(cache[j], i)["attn"]
                wholes[c["k"].data_ptr()] = _dec_whole(c, shards[j])
    inner_attn, inner_mix = L.attention_block, T._apply_mixer
    gates, at, tol = [], [0], TOL[torch.bfloat16]

    def record(kind, got, want):
        g, w = got.float(), want.float()
        return {"kind": kind, "step": at[0], "rel": _rel(g, w),
                "ok": bool(((g - w).abs() <= tol + tol * w.abs()).all()
                           and torch.isfinite(g).all())}

    def attn(p, cfg_, h, positions, **kw):
        ctrl = {k: t.clone() for k, t in kw["cache"].items()}
        got, c = inner_attn(p, cfg_, h, positions, **kw)
        want, _ = inner_attn(p, cfg_, h, positions, **{
            **kw, "cache": wholes[kw["cache"]["k"].data_ptr()],
            "shard": None})
        rec = record("attn", got, want)
        if kw["shard"].seq:
            with PlainMean():
                bad, _ = inner_attn(p, cfg_, h, positions,
                                    **{**kw, "cache": ctrl})
            rec["control_rel"] = _rel(bad, want)
        gates.append(rec)
        return got, c

    def mixer(cfg_, sub, p, h, cache_, shard=None):
        state = cache_[sub.mixer]
        held = T._state_leaves(state)
        splits = [r.splits for r in shard]

        def whole(ts):
            return [L._gather_at_use(t, mesh, sp) for t, sp in
                    zip(ts, splits)]
        before = [t.clone() for t in whole(held)]
        ctrl = [t.clone() for t in held]
        got = inner_mix(cfg_, sub, p, h, cache_, shard)
        mine = whole(held)
        want = inner_mix(cfg_, sub, p, h,
                         {sub.mixer: T._as_state(state, before)}, None)
        inner_mix(cfg_, sub, p, h, {sub.mixer: T._as_state(state, ctrl)},
                  _swapped(shard))
        rec = record(sub.mixer, got, want)
        rec["state_rel"] = max(_rel(a, b) for a, b in zip(mine, before))
        rec["control_rel"] = max(_rel(a, b) for a, b in
                                 zip(whole(ctrl), before))
        gates.append(rec)
        return got

    L.attention_block, T._apply_mixer = attn, mixer
    try:
        for i in range(ST_STEPS):
            at[0] = i + 1
            _, cache = step(params, {"tokens": teacher[:, i:i + 1],
                                     **extra}, cache,
                            _st_len(cfg, ST_PREFILL + i))
    finally:
        L.attention_block, T._apply_mixer = inner_attn, inner_mix
    return gates


def state_run(mesh, arch: str, dtype: str, layout: str, fsdp: bool,
              tmp: str) -> dict:
    """One phase-16 run on this rank: `arch`'s parameter shards
    (``params_shardings(fsdp=)``), its cache laid out by `layout`, the
    prefill and ST_STEPS timed and counted decode steps through
    ``make_serve_step``, the resident bytes against the dry-run's; at
    bf16 the gated passes, at float32 its final cache shards in `tmp`."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    t_start = time.perf_counter()
    cfg = state_config(arch, dtype)
    params, ps = _rank_shards(mesh, cfg, fsdp)
    whole = _whole_cache(cfg)
    cs = SH.cache_shardings(whole, mesh, **DEC_LAYOUTS[layout])
    held = SH.shard_tree(whole, cs, copy=True)
    del whole
    torch.cuda.empty_cache()
    variant = {"fsdp_params": fsdp, "seq_over_dp": layout == "seq_over_dp",
               "cache_heads_model": layout == "cache_heads_model"}
    _, args, shardings = D.build_step(
        cfg, InputShape("decode", ST_SLOTS, ST_B, "decode"), variant,
        mesh=mesh)
    dps, _, dcs, _ = shardings(mesh)
    rec = {"resident": {"params": _nbytes(params), "cache": _nbytes(held)},
           "reckoned": {"params": SH.shard_nbytes(args[0], dps),
                        "cache": SH.shard_nbytes(args[2], dcs)},
           "specs": {k: tuple(sh.spec) for k, sh in
                     _cache_leaves(cs).items()}}
    step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
    teacher = torch.load(os.path.join(
        tmp, f"teacher-{arch}-{dtype}.pt")).cuda()
    toks, emb = state_inputs(cfg)
    batch, extra = {"tokens": toks}, {}
    if emb is not None:
        batch["enc_embeds"] = emb
        extra["enc_out"] = torch.load(os.path.join(
            tmp, f"enc-{arch}-{dtype}.pt")).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        mesh.host_ms.clear()
        mesh.nbytes.clear()
        t0 = time.perf_counter()
        lg, held = step(params, batch, held, 0)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_collective_bytes"] = dict(mesh.nbytes)
        steps = [_dec_record(lg, step.metrics)]
        del lg
        snap = clone_tree(held) if dtype == "bfloat16" else None
        K.reset_launch_counts()
        mesh.host_ms.clear()
        mesh.nbytes.clear()
        walls = []
        with KernelShapes() as shapes:
            for i in range(ST_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, held = step(params, {"tokens": teacher[:, i:i + 1],
                                         **extra}, held,
                                _st_len(cfg, ST_PREFILL + i))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                steps.append(_dec_record(lg, step.metrics))
        rec.update(steps=steps, walls=walls,
                   launches=dict(K.launch_counts()),
                   shapes=dict(shapes.seen),
                   collective_ms=dict(mesh.host_ms),
                   collective_bytes=dict(mesh.nbytes),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if snap is not None:
            rec["gates"] = state_gated_pass(mesh, cfg, params, snap, cs,
                                            step, teacher, extra)
            del snap
            if cfg.is_moe:
                rec["moe_gates"] = dec_moe_gates(
                    mesh, cfg, params, held, cs, tmp,
                    path=os.path.join(tmp, f"moe-{arch}-"
                                      f"{mesh.shape['data']}.pt"),
                    positions=_moe_positions(cfg))
    if dtype == "float32":
        rec["cache_file"] = os.path.join(
            tmp, f"state-{arch}-{layout}-{mesh.rank}.pt")
        torch.save({k: t.cpu() for k, t in _cache_leaves(held).items()},
                   rec["cache_file"])
    del held, step, params, extra, teacher
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def state_kernel_shapes(gen) -> dict:
    """Phase 16 (a): ``decode_attention(return_stats=True)`` at
    jamba-v0.1-52b's (1, 2) sequence shard (bf16, "mma") and at
    whisper-base's (2, 2) one (float32 timed, "simt"; its rows a data
    rank's); ``decode_attention`` at whisper-base's (1, 2)
    ``cache_heads_model`` step (the whole gathered cache, float32,
    "simt"); ``fused_gate_up`` and ``gmm`` at jamba-v0.1-52b's F-shard at
    model 2 (E 16, D 4096, F 7168, its (1, 2) decode C); each against
    its plain version and timed beside its bound."""
    jamba = state_config("jamba-v0.1-52b", "bfloat16")
    whisper = state_config("whisper-base", "float32")
    out = {"decode_attention": {
        "jamba-v0.1-52b": stats_kernel_check(
            gen, (ST_B, jamba.num_heads, jamba.num_kv_heads,
                  jamba.resolved_head_dim, ST_SLOTS // 2),
            **ST_ATTN["jamba-v0.1-52b"], where="jamba's (1, 2) shard"),
        "whisper-base": stats_kernel_check(
            gen, (ST_B // 2, whisper.num_heads, whisper.num_kv_heads,
                  whisper.resolved_head_dim, ST_SLOTS // 2),
            **ST_ATTN["whisper-base"], timed=torch.float32,
            where="whisper's (2, 2) shard"),
        "whisper-base heads_model": decode_attention_timed(
            gen, (ST_B, whisper.num_heads, whisper.num_kv_heads,
                  whisper.resolved_head_dim, ST_SLOTS,
                  [ST_PREFILL + ST_STEPS] * ST_B),
            "whisper (1, 2) cache_heads_model", "simt",
            dtype=torch.float32)}}
    rows = _dec_expert_rows(jamba, ST_B, (1, 2), "default")
    out.update(dec_kernel_shapes(gen, [rows], jamba))
    return out


def _state_bf16_gate(name, run, merges: bool, fails: list) -> str:
    """Phase 16's bf16 attention and mixer gates on one run's gated pass
    (``state_gated_pass``); a failed gate's message goes to `fails`."""
    texts = []
    for kind in sorted({r["kind"] for r in run["gates"]}):
        g = [r for r in run["gates"] if r["kind"] == kind]
        for r in g:
            if not (r["ok"] and r["rel"] <= DEC_REL
                    and r.get("state_rel", 0.0) <= DEC_REL):
                fails.append(f"{name} {kind} step {r['step']}: rel "
                             f"{r['rel']:.3e}, state rel "
                             f"{r.get('state_rel', 0.0):.3e} (held to "
                             f"{DEC_REL}), elementwise: {r['ok']}")
            control = kind != "attn" or (merges and r["step"] < ST_CROSS)
            if control and r["control_rel"] <= DEC_CONTROL * DEC_REL:
                fails.append(f"{name} {kind} step {r['step']}: the control "
                             f"moved only {r['control_rel']:.3e}")
        text = (f"{len(g)} {kind} sublayers against one process: rel "
                f"{max(r['rel'] for r in g):.2e} at most")
        if kind == "attn":
            ctl = [r["control_rel"] for r in g if r["step"] < ST_CROSS
                   and "control_rel" in r]
            text += (f"; the plain-mean control before step {ST_CROSS}: "
                     f"rel {min(ctl):.3f}-{max(ctl):.3f}" if ctl else
                     "; no merge, the control does not apply")
        else:
            text += (f", new state rel "
                     f"{max(r['state_rel'] for r in g):.2e} at most (held "
                     f"to {DEC_REL}); the swapped-slice control: state rel "
                     f"{min(r['control_rel'] for r in g):.3f}-"
                     f"{max(r['control_rel'] for r in g):.3f} (held above "
                     f"{DEC_CONTROL * DEC_REL:.1f})")
        texts.append(text)
    return "; ".join(texts)


def state_gates(shape, ranks, oracles, card, fails: list) -> dict:
    """Phase 16's gates on one mesh's ranks (the constants' comment); a
    failed gate's message goes to `fails`. Returns the record."""
    from repro_torch.distributed import sharding as SH
    dp, mp = shape
    out = {}
    for arch, dtype, layout, fsdp in ST_RUNS[shape]:
        key = (arch, dtype, layout)
        cfg = state_config(arch, dtype)
        one = oracles[arch, dtype]
        has_attn = _st_count(cfg, lambda s: s.mixer == "attn") > 0
        merges = has_attn and layout != "cache_heads_model"
        shard_s = ST_SLOTS // mp if layout == "default" else \
            ST_SLOTS // dp if layout == "seq_over_dp" and dp > 1 \
            else ST_SLOTS
        rows = _dec_expert_rows(cfg, ST_B, shape, layout) if cfg.is_moe \
            else 0
        tag = f"{shape} {arch} {dtype} {layout}" + \
            (" ZeRO-3" if fsdp else "")
        launches = {"decode_attention": ST_STEPS * _st_count(
            cfg, lambda s: s.mixer == "attn")}
        launches["fused_gate_up"] = launches["gmm"] = ST_STEPS * _st_count(
            cfg, lambda s: s.ffn == "moe")
        for r in ranks:
            run = r["state_runs"][key]
            name = f"{tag} rank {r['rank']}"
            if merges != any(c.endswith("/softmax")
                             for c in run["collective_ms"]):
                fails.append(f"{name}: the merge ran {not merges}, where "
                             f"the layout asks {merges}")
            if run["resident"] != run["reckoned"]:
                fails.append(f"{name}: resident {run['resident']} != the "
                             f"dry-run's {run['reckoned']}")
            paths = _dec_launch_gate(name, cfg, run, launches, shard_s,
                                     merges, rows, fails)
            drift = _dec_drift(run, one)
            if dtype == "float32":
                for i, (got, want) in enumerate(zip(run["steps"],
                                                    one["steps"])):
                    if not torch.allclose(got["logits"], want["logits"],
                                          atol=TOL[torch.float32],
                                          rtol=TOL[torch.float32]):
                        fails.append(f"{name} step {i}: logits "
                                     f"{float((got['logits'] - want['logits']).abs().max()):.3e} off")
                if drift["agree"] != drift["of"] or not drift["loads"]:
                    fails.append(f"{name}: greedy tokens agree in "
                                 f"{drift['agree']} of {drift['of']}, "
                                 f"loads and drops equal {drift['loads']}")
            text = (f"  {name}: prefill + {ST_STEPS} steps, logits max "
                    f"|ranks - one process| {drift['logits']:.3e} "
                    + (f"(held to {TOL[torch.float32]})"
                       if dtype == "float32" else "(reported)")
                    + f"; greedy tokens agree in {drift['agree']} of "
                    f"{drift['of']}; launches "
                    f"{ {k: run['launches'][k] for k in ('decode_attention', 'fused_gate_up', 'gmm')} }"
                    f" ({paths})")
            if dtype == "bfloat16":
                text += "; " + _state_bf16_gate(name, run, merges, fails)
                if cfg.is_moe:
                    text += "; " + _dec_moe_gate(
                        name, cfg, run, fails,
                        ST_STEPS * len(_moe_positions(cfg)))
            log(text)
            coll = {k: round(v / ST_STEPS, 2) for k, v in
                    run["collective_ms"].items()}
            gathered = {k: round(v / ST_STEPS / 1e6, 2) for k, v in
                        run["collective_bytes"].items()
                        if "all_gather" in k}
            log(f"  {name}: decode step wall median "
                f"{float(np.median(run['walls'])):.1f} ms (one process "
                f"{float(np.median(one['walls'])):.1f}); prefill "
                f"{run['prefill_ms']:.0f} ms (one process "
                f"{one['prefill_ms']:.0f}); host ms a step by collective "
                f"{coll}; MB gathered a step {gathered}; resident "
                f"{run['resident']} bytes "
                f"{'==' if run['resident'] == run['reckoned'] else '!='} "
                f"the dry-run's; peak {run['peak_gb']:.2f} GB; "
                f"{run['seconds']:.1f} s on the rank; on {card}")
        rec = {"walls_ms": [float(np.median(r["state_runs"][key]["walls"]))
                            for r in ranks],
               "one_process_ms": float(np.median(one["walls"])),
               "gathered_mb": [sum(v for k, v in r["state_runs"][key]
                                   ["collective_bytes"].items()
                                   if "all_gather" in k) / ST_STEPS / 1e6
                               for r in ranks],
               "logits_drift": drift["logits"],
               "launches": [{k: r["state_runs"][key]["launches"][k]
                             for k in ("decode_attention", "fused_gate_up",
                                       "gmm")} for r in ranks],
               "peak_gb": [r["state_runs"][key]["peak_gb"] for r in ranks]}
        if dtype == "float32":
            mesh = _logical(shape)
            parts = [torch.load(r["state_runs"][key]["cache_file"])
                     for r in ranks]
            specs = ranks[0]["state_runs"][key]["specs"]
            worst = 0.0
            for k, want in one["cache"].items():
                got = SH.assemble([p[k] for p in parts], SH.NamedSharding(
                    mesh, SH.P(*specs[k])))
                if k.endswith("/pos"):
                    if not torch.equal(got, want):
                        fails.append(f"{tag}: the assembled {k} differs")
                    continue
                worst = max(worst, float((got.float() - want.float())
                                         .abs().max()))
                if not torch.allclose(got, want, atol=ST_STATE_TOL,
                                      rtol=ST_STATE_TOL):
                    fails.append(f"{tag}: the assembled {k} "
                                 f"{float((got - want).abs().max()):.3e} "
                                 f"off, beyond atol=rtol={ST_STATE_TOL}")
            rec["cache_err"] = worst
            log(f"  {tag}: every cache leaf ({len(one['cache'])}) assembled "
                f"from the ranks' shards after the last step: positions "
                f"equal, the rest within {worst:.3e} of one process (held "
                f"to {ST_STATE_TOL})")
        out[f"{arch} {dtype} {layout}"] = rec
    return out


# ------------------------------------------------------------ phase 17

# phase 17: the expert-parallel layout (``params_shardings(ep_experts=
# True)``): each model rank holds E/model whole experts and runs the
# expert kernels on its experts' rows of the dispatch buffer, their
# outputs all-gathered over "model" in group-rank order before the
# combine (``moe.dispatch_moe``), so no expert leaf is gathered over
# "model". It runs on phase 14's ranks after phases 14 and 16 (no spawn
# of its own): mixtral-8x7b at its published widths, bf16, impl "auto",
# on each mesh of EP_SERVE (its depth and whether ZeRO-3 splits the
# parameters over data as well): phase 13's prefill cell (TP_PREFILL_B x
# TP_PREFILL_S) and phase 14's decode cell under the default cache
# layout (the oracle's prefill and teacher tokens, DEC_STEPS steps); on
# (2, 2) also phase 15's training cell through the ZeRO-3 step (impl
# "ref", one step), against phase 13's ZeRO-2 step on (2, 2). Gates:
# (a) every MoE sublayer of the prefill and of every decode step, run
# from the one-process path's input, bit for bit or within TOL[bf16]
# elementwise and DEC_REL in norm of its output, the control
# (``RolledExperts``: the gathered outputs rolled by one rank's experts)
# moving the norm past DEC_CONTROL x DEC_REL; (b) the prefill's logits on
# (1, 2), whose rows and attention are the one process's, bit for bit or
# within TOL[bf16] and DEC_REL, loads and drops equal (on (2, 2), whose
# rows split over data, reported); every decode step's loads and greedy
# tokens equal to one process's and its logits within TOL[bf16] and
# DEC_REL where phase 14's own run of the cell on the same ranks (the
# default layout's experts, F-split) agrees with one process in tokens
# and loads (its witness), else reported; and always against that run
# (the same attention and sequence merge, only the experts' layout
# differs): greedy tokens, and rows whose logits lie within DEC_CONTROL x
# DEC_REL of its in norm, each in at least EP_DEC_AGREE of the rows and
# steps; (c) ``fused_gate_up`` and ``gmm`` launched once a layer a call
# at (E/model, C, D, F) with F whole, on "wgmma", decode attention once a
# layer a step; (d) no expert leaf over "model": each call's
# "all_gather/model" bytes equal the weights phase 14's run of the cell
# gathers a step (its banks are column/row pairs, never gathered), plus
# the prefill's logit columns, and "all_gather/model/experts" moves E x C
# x D x 2 bytes a layer a call; (e) resident parameter (and cache) bytes
# equal to the dry-run's ``ep_experts`` variant, and each rank's peak
# less what it held before the call (the prefill) or the steps (the
# decode), less under ZeRO-3 the period's E/model experts its gather over
# data makes whole at use, below one period's whole expert banks
# (``ep_bank_bytes``, by the reckoning); (f) training: the loss within
# MB_LOSS_TOL of ZeRO-2's, the step-1 gradients within GRAD_REL_TOL of
# its accumulator in each leaf's norm, the sharded update within one bf16
# ulp of the unsharded update of those gradients (``ep_train_gates``).
EP_SERVE = {(1, 2): (DEC_BF16_LAYERS, False), (2, 2): (DEC_22_LAYERS, True)}
# the decode step against phase 14's run of the cell on the same ranks:
# the share of rows and steps whose greedy token agrees and whose logits
# lie within DEC_CONTROL x DEC_REL of its in norm (a row past that has
# taken another expert or a wrong expert's output)
EP_DEC_AGREE = 0.9


def ep_bank_bytes(cfg) -> int:
    """One period's whole expert banks of `cfg` in bf16, by the
    reckoning: what a rank held beside its shards while the layout
    gathered its banks whole at use."""
    from repro_torch.models import transformer as T
    moe = sum(sub.ffn == "moe" for sub in T.layer_pattern(cfg))
    return moe * cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.d_ff * 2


def ep_kernel_shapes(gen, b22: int) -> dict:
    """``fused_gate_up`` and ``gmm`` at the shapes phase 17's steps give
    them: E/2 = 4 of mixtral's 8 experts, F whole, C of the (1, 2) and
    (2, 2) decode cells and prefills; each against its plain version and
    timed beside its bound."""
    cfg = _mixtral("bfloat16", 1)
    e, d, f = cfg.moe.num_experts // 2, cfg.d_model, cfg.moe.d_ff
    rows = {"dec (1, 2)": _dec_expert_rows(cfg, DEC_B, (1, 2), "default"),
            "dec (2, 2)": _dec_expert_rows(cfg, b22, (2, 2), "default"),
            "prefill (1, 2)": _tp_expert_rows(cfg, 1),
            "prefill (2, 2)": _tp_expert_rows(cfg, 2)}
    out = {}
    for name, fused in (("fused_gate_up", True), ("gmm", False)):
        out[name] = {}
        for label, c in rows.items():
            shape = (e, c, d, f) if fused else (e, c, f, d)
            out[name][f"ep {label} C{c}"] = dict(
                shape=list(shape), **gmm_shape_timed(
                    gen, name, fused, f"ep {label}", shape + ([c] * e,)))
    return out


def ep_prefill_oracle(tmp: str) -> dict:
    """The one-process bf16 prefill of the cell on the kernel path at
    each mesh's depth and dispatch groups (EP_SERVE), in this process:
    last-position logits, loads, drops and wall on the host, and each MoE
    sublayer's calls to `tmp` (``MoeCalls``: the rows of each data rank
    run alone too). Frees the card."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    out = {}
    for shape, (layers, _) in EP_SERVE.items():
        dp = shape[0]
        cfg = _mixtral("bfloat16", layers)
        params = init_params(cfg, seed=0, device="cuda")
        step = M.make_prefill_step(cfg)
        batch = {k: v.cuda() for k, v in _tp_prefill_batch(cfg).items()}
        calls = MoeCalls()
        T.set_moe_dispatch_groups(dp)
        try:
            with torch.no_grad():
                step(params, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, m = step(params, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                with calls:
                    step(params, batch)
                calls.save(os.path.join(tmp, f"ep-prefill-{layers}-{dp}.pt"),
                           layers, dp)
        finally:
            T.set_moe_dispatch_groups(1)
        out[shape] = {"logits": logits[:, -1].float().cpu(),
                      "wall_ms": wall,
                      "expert_load": m["expert_load"].tolist(),
                      "dropped": m["dropped"].tolist()}
        del params, step, logits, m, calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ep_prefill(mesh, cfg, params, ps, fsdp: bool, tmp: str) -> dict:
    """Phase 17's prefill on this rank: a warm call, then the counted and
    timed ``make_prefill_step(param_shardings=)`` call, its peak less
    what the rank held before it, its collectives; the resident bytes
    against the dry-run's; each MoE sublayer from the one-process input
    (the rank's rows of it), gated with its control."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    dp, r = mesh.shape["data"], mesh.index("data")
    batch = _tp_prefill_batch(cfg)
    step = M.make_prefill_step(cfg, param_shardings=ps)
    _, args, shardings = D.build_step(
        cfg, InputShape("prefill", TP_PREFILL_S, TP_PREFILL_B, "prefill"),
        {"fsdp_params": fsdp, "ep_experts": True}, mesh=mesh)
    rec = {"resident": _nbytes(params),
           "reckoned": SH.shard_nbytes(args[0], shardings(mesh)[0])}
    T.set_moe_dispatch_groups(dp)
    try:
        with torch.no_grad():
            step(params, batch)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec["held_before"] = torch.cuda.memory_allocated()
            K.reset_launch_counts()
            mesh.host_ms.clear()
            mesh.nbytes.clear()
            with KernelShapes() as shapes:
                t0 = time.perf_counter()
                logits, m = step(params, batch)
                torch.cuda.synchronize()
            rec.update(wall_ms=(time.perf_counter() - t0) * 1e3,
                       peak=torch.cuda.max_memory_allocated(),
                       launches=dict(K.launch_counts()),
                       shapes=dict(shapes.seen),
                       collective_ms=dict(mesh.host_ms),
                       collective_bytes=dict(mesh.nbytes),
                       logits=logits[:, -1].float().cpu(),
                       expert_load=m["expert_load"].tolist(),
                       dropped=m["dropped"].tolist())
            del logits, m
        io = torch.load(os.path.join(
            tmp, f"ep-prefill-{cfg.num_layers}-{dp}.pt"))
        n = TP_PREFILL_B // dp
        ios = [[(c["x"][r * n:(r + 1) * n],
                 c["blocks"][r] if dp > 1 else c["y"]) for c in calls]
               for calls in io]
        rec["moe_gates"] = moe_sublayer_gates(mesh, cfg, params, ios, mesh,
                                              shardings=ps)
    finally:
        T.set_moe_dispatch_groups(1)
    return rec


def ep_rank(mesh, shape: tuple, tmp: str, b: int) -> dict:
    """Phase 17 on this rank of phase 14's mesh `shape`: its parameter
    shards of the ``ep_experts`` layout (EP_SERVE), the prefill
    (``ep_prefill``) and the decode cell (``dec_run`` at `b` rows under
    the default cache layout), then on (2, 2) the ZeRO-3 training step
    (``z3_train``). Everything returned lives on the host."""
    t0 = time.perf_counter()
    layers, fsdp = EP_SERVE[shape]
    cfg = _mixtral("bfloat16", layers)
    params, ps = _rank_shards(mesh, cfg, fsdp=fsdp, ep=True)
    out = {"prefill": ep_prefill(mesh, cfg, params, ps, fsdp, tmp)}
    out["decode"] = dec_run(mesh, cfg, params, ps, {}, b, tmp,
                            f"ep-{shape[0]}x{shape[1]}", fsdp=fsdp, ep=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if shape == (2, 2):
        out["train"] = z3_train(mesh, shape, tmp, ep=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _ep_launch_gate(name, cfg, run, calls: int, attn: int,
                    fails: list) -> str:
    """Phase 15's launch gate (``_z3_launch_gate``) on one phase-17 call
    or run, and every expert kernel at E/2 experts with F whole."""
    text = _z3_launch_gate(name, run, calls, attn, fails)
    e = cfg.moe.num_experts // 2
    for k_name, xs, ws, _, _ in run["shapes"]:
        if k_name != "decode_attention" and not (
                xs[0] == ws[0] == e and cfg.moe.d_ff in ws[1:]):
            fails.append(f"{name}: {k_name} at {xs} x {ws}, not on E/2 "
                         "whole experts")
    return text


def _ep_moe_gate(name, gates: list, fails: list) -> str:
    """Phase 17's MoE gate on one call's or run's records
    (``moe_sublayer_gates``); a failed gate's message goes to `fails`."""
    tol = TOL[torch.bfloat16]
    for g in gates:
        if not (g["same"] or (g["ok"] and g["finite"]
                              and g["rel"] <= DEC_REL)):
            fails.append(f"{name} MoE layer {g['layer']}: rel "
                         f"{g['rel']:.3e}, max |err| {g['max_abs_err']:.3e}"
                         f" (held to bit for bit, or {tol} and {DEC_REL})")
        if g["control_rel"] <= DEC_CONTROL * DEC_REL:
            fails.append(f"{name} MoE layer {g['layer']}: the control moved "
                         f"only {g['control_rel']:.3e}")
    same = sum(g["same"] for g in gates)
    return (f"MoE sublayers from the one-process input: {same} of "
            f"{len(gates)} bit for bit, max |err| "
            f"{max(g['max_abs_err'] for g in gates):.3e}, rel up to "
            f"{max(g['rel'] for g in gates):.3e}; the control (outputs "
            f"rolled by one rank's experts) rel "
            f"{min(g['control_rel'] for g in gates):.3f}-"
            f"{max(g['control_rel'] for g in gates):.3f} (held above "
            f"{DEC_CONTROL * DEC_REL:.1f})")


def _ep_logits(got, want) -> dict:
    """One step's bf16 logits against one process's: bit for bit, max
    |err|, |err| / |want| in norm, within TOL[bf16] and DEC_REL."""
    tol = TOL[torch.bfloat16]
    d = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    return {"same": bool(torch.equal(got, want)), "err": float(d.max()),
            "rel": rel, "ok": bool((d <= tol + tol * want.abs()).all())
            and rel <= DEC_REL}


def _ep_rows(got: dict, want: dict) -> list:
    """|err| / |want| in norm of each row of each step's logits of one
    decode run against another's."""
    return [float(r) for g, w in zip(got["steps"], want["steps"])
            for r in (g["logits"] - w["logits"]).norm(dim=-1)
            / w["logits"].norm(dim=-1).clamp_min(1e-30)]


def ep_gates(shape, ranks, one, oracle, b, card, fails: list,
             zero2=None) -> dict:
    """Phase 17's gates on the ranks of phase 14's mesh `shape` (the
    constants' comment): `one` the one-process prefill's record,
    `oracle` phase 14's bf16 one-process decode of the cell, `zero2`
    phase 13's ZeRO-2 training record on (2, 2). Returns the record."""
    layers, fsdp = EP_SERVE[shape]
    cfg = _mixtral("bfloat16", layers)
    e, d, mp = cfg.moe.num_experts, cfg.d_model, shape[1]
    bank = ep_bank_bytes(cfg)
    lay = f"{'ZeRO-3' if fsdp else 'fsdp=False'} ep_experts"
    out = {"prefill": [], "decode": []}
    for r in ranks:
        name = f"[17] {shape} rank {r['rank']}"
        z14 = r["runs"]["bfloat16", "default"]
        weights = z14["collective_bytes"].get("all_gather/model", 0) \
            // DEC_STEPS
        p, dd = r["ep"]["prefill"], r["ep"]["decode"]
        # (a) the MoE sublayers
        ptext = _ep_moe_gate(f"{name} prefill", p["moe_gates"], fails)
        dtext = _ep_moe_gate(f"{name} decode", dd["moe_gates"], fails)
        # (b) the whole step against one process
        lg = _ep_logits(p["logits"], one["logits"])
        loads = p["expert_load"] == one["expert_load"] and \
            p["dropped"] == one["dropped"]
        if shape[0] == 1 and not (lg["same"] or lg["ok"]) or \
                shape[0] == 1 and not loads:
            fails.append(f"{name} prefill: logits {lg}, loads and drops "
                         f"equal {loads}")
        witness = _dec_drift(z14, oracle)
        agrees = witness["agree"] == witness["of"] and witness["loads"]
        drift = _dec_drift(dd, oracle)
        steps = [_ep_logits(g["logits"], w["logits"])
                 for g, w in zip(dd["steps"], oracle["steps"])]
        if agrees and not (drift["agree"] == drift["of"] and drift["loads"]
                           and all(s["same"] or s["ok"] for s in steps)):
            fails.append(f"{name} decode: where phase 14's run agrees with "
                         f"one process, tokens {drift['agree']} of "
                         f"{drift['of']}, loads equal {drift['loads']}, "
                         f"logits rel up to "
                         f"{max(s['rel'] for s in steps):.3e}")
        # ... and always against phase 14's run on these ranks
        d14 = _dec_drift(dd, z14)
        rows = _ep_rows(dd, z14)
        close = sum(x <= DEC_CONTROL * DEC_REL for x in rows)
        if min(d14["agree"], close) < EP_DEC_AGREE * d14["of"]:
            fails.append(f"{name} decode against phase 14's run: tokens "
                         f"{d14['agree']}, rows within "
                         f"{DEC_CONTROL * DEC_REL:.1f} in norm {close}, of "
                         f"{d14['of']} (held to {EP_DEC_AGREE} of them)")
        # (c) the kernels
        kp = _ep_launch_gate(f"{name} prefill", cfg, p, cfg.num_layers, 0,
                             fails)
        n = cfg.num_layers * DEC_STEPS
        kd = _ep_launch_gate(f"{name} decode", cfg, dd, n, n, fails)
        # (d) no expert leaf over "model"
        pb, db = p["collective_bytes"], dd["collective_bytes"]
        cols = TP_PREFILL_B // shape[0] * cfg.padded_vocab * 2
        cp = _tp_expert_rows(cfg, shape[0])
        cd = _dec_expert_rows(cfg, b, shape, "default")
        for what, got, want in (
                ("prefill all_gather/model", pb.get("all_gather/model"),
                 weights + cols),
                ("decode all_gather/model", db.get("all_gather/model"),
                 weights * DEC_STEPS),
                ("prefill all_gather/model/experts",
                 pb.get("all_gather/model/experts"),
                 cfg.num_layers * e * cp * d * 2),
                ("decode all_gather/model/experts",
                 db.get("all_gather/model/experts"),
                 n * e * cd * d * 2)):
            if got != want:
                fails.append(f"{name}: {what} {got} bytes, not {want}")
        # (e) bytes a rank
        if p["resident"] != p["reckoned"] or \
                dd["resident"] != dd["reckoned"]:
            fails.append(f"{name}: resident {p['resident']}, "
                         f"{dd['resident']} != the dry-run's "
                         f"{p['reckoned']}, {dd['reckoned']}")
        # peak less held, less the E/model experts of a period that
        # ZeRO-3's gather over data makes whole on the rank at use (a
        # rank of the layout that gathered the banks over "model" held
        # the whole banks beside those)
        dgath = bank // mp if fsdp else 0
        raw_p = p["peak"] - p["held_before"]
        raw_d = dd["steps_peak"] - dd["held_before_steps"]
        over_p, over_d = raw_p - dgath, raw_d - dgath
        if not max(over_p, over_d) < bank:
            fails.append(f"{name}: peak less held {raw_p}, {raw_d} bytes, "
                         f"less the data-gathered experts {dgath}, not "
                         f"below one period's expert banks {bank}")
        log(f"  {name} prefill {TP_PREFILL_B} x {TP_PREFILL_S}, "
            f"{cfg.num_layers} layer(s), {lay}: {ptext}; logits "
            f"{'bit for bit' if lg['same'] else 'max |err| %.3e, rel %.3e' % (lg['err'], lg['rel'])}"
            f" of one process ({'gated' if shape[0] == 1 else 'reported'}),"
            f" loads and drops {'equal' if loads else 'DIFFER'}; launches "
            f"{kp}; wall {p['wall_ms']:.1f} ms (one process "
            f"{one['wall_ms']:.1f}); host ms by collective "
            f"{ {k: round(v, 2) for k, v in p['collective_ms'].items()} }, "
            f"MB {_per_call(pb, 1, 1e6)} (all_gather/model/experts moves "
            f"{cfg.num_layers * (e - e // mp) * cp * d * 2 / 1e6:.2f} MB "
            f"into a rank); peak less held {raw_p / 1e9:.3f} GB, less "
            f"the data-gathered experts {dgath / 1e9:.3f}: "
            f"{over_p / 1e9:.3f} (one "
            f"period's banks {bank / 1e9:.3f}); resident {p['resident']} "
            f"bytes (the dry-run's {p['reckoned']}); on {card}")
        log(f"  {name} decode, B {b}, a {DEC_PREFILL}-token prefill into "
            f"{DEC_SLOTS} slots + {DEC_STEPS} steps, default cache layout, "
            f"{lay}: {dtext}; logits "
            f"{sum(s['same'] for s in steps)} of {len(steps)} steps bit for "
            f"bit, max |err| {drift['logits']:.3e}, rel up to "
            f"{max(s['rel'] for s in steps):.3e}; greedy tokens "
            f"{drift['agree']} of {drift['of']}, loads "
            f"{'equal' if drift['loads'] else 'DIFFER'} (gated: phase 14's "
            f"run {'agrees' if agrees else 'does not agree'} with one "
            f"process, {witness['agree']} of {witness['of']}); against "
            f"phase 14's run on these ranks: greedy tokens {d14['agree']}"
            f" of {d14['of']}, rows within {DEC_CONTROL * DEC_REL:.1f} in "
            f"norm {close}, row rel median {float(np.median(rows)):.3e}, "
            f"max {max(rows):.3e} (held to {EP_DEC_AGREE} of them); "
            f"launches "
            f"{kd}; decode step wall median "
            f"{float(np.median(dd['walls'])):.1f} ms (phase 14's default "
            f"layout {float(np.median(z14['walls'])):.1f}, one process "
            f"{float(np.median(oracle['walls'])):.1f}); host ms a step "
            f"{_per_call(dd['collective_ms'], DEC_STEPS)}, MB a step "
            f"{_per_call(db, DEC_STEPS, 1e6)} (all_gather/model/experts "
            f"moves {cfg.num_layers * (e - e // mp) * cd * d * 2 / 1e6:.3f}"
            f" MB a step into a rank); peak less held "
            f"{raw_d / 1e9:.3f} GB, less the data-gathered experts "
            f"{dgath / 1e9:.3f}: {over_d / 1e9:.3f};"
            f" resident {dd['resident']} (the dry-run's {dd['reckoned']}); "
            f"on {card}")
        out["prefill"].append({
            "wall_ms": p["wall_ms"], "one_process_ms": one["wall_ms"],
            "same": lg["same"], "rel": lg["rel"],
            "launches": {k: p["launches"][k]
                         for k in ("fused_gate_up", "gmm")},
            "over_gb": over_p / 1e9, "raw_gb": raw_p / 1e9,
            "moe_same": sum(g["same"] for g in p["moe_gates"]),
            "collective_bytes": pb})
        out["decode"].append({
            "wall_ms": float(np.median(dd["walls"])),
            "default_ms": float(np.median(z14["walls"])),
            "one_process_ms": float(np.median(oracle["walls"])),
            "same_steps": sum(s["same"] for s in steps),
            "rel": max(s["rel"] for s in steps),
            "vs_phase14": {"agree": d14["agree"], "close": close,
                           "of": d14["of"], "rel_max": max(rows)},
            "launches": {k: dd["launches"][k] for k in
                         ("fused_gate_up", "gmm", "decode_attention")},
            "over_gb": over_d / 1e9, "raw_gb": raw_d / 1e9,
            "moe_same": sum(g["same"] for g in dd["moe_gates"]),
            "collective_bytes": db})
    out["bank_gb"] = bank / 1e9
    if zero2 is not None:
        out["train"] = ep_train_gates(shape, ranks, zero2, card, fails)
    return out


def ep_summary(tp, ep, zero3) -> dict:
    """Phase 17's walls a rank beside the default layout's on the same
    mesh and depth (phase 13's (1, 2) prefill, phase 14's decode on the
    same ranks, phase 15's (2, 2) ZeRO-3 prefill and decode) and one
    process's; peaks less held, and less ZeRO-3's data-gathered experts,
    against one period's banks; the decode steps against phase 14's.
    `tp`, `ep`, `zero3`: phases 13's, 17's and 15's records."""
    z15 = zero3["(2, 2)"]["serve"]
    return {
        "(1, 2) prefill ms a rank": {
            "ep_experts": [round(x["wall_ms"], 2)
                           for x in ep["(1, 2)"]["prefill"]],
            "default (phase 13)": [round(x, 2) for x in
                                   tp["prefill"]["bfloat16"]["wall_ms"]],
            "one process": round(ep["(1, 2)"]["prefill"][0]
                                 ["one_process_ms"], 2)},
        "(2, 2) ZeRO-3 prefill ms a rank": {
            "ep_experts": [round(x["wall_ms"], 2)
                           for x in ep["(2, 2)"]["prefill"]],
            "default (phase 15)": [round(x, 2) for x in z15["prefill_ms"]],
            "one process": round(ep["(2, 2)"]["prefill"][0]
                                 ["one_process_ms"], 2)},
        **{f"{shape} decode step ms a rank": {
            "ep_experts": [round(x["wall_ms"], 2)
                           for x in ep[shape]["decode"]],
            "default fsdp=False (phase 14)": [round(x["default_ms"], 2)
                                              for x in ep[shape]["decode"]],
            "one process": round(ep[shape]["decode"][0]["one_process_ms"],
                                 2)} for shape in ("(1, 2)", "(2, 2)")},
        "(2, 2) ZeRO-3 decode step ms (phase 15, seq_over_dp)": {
            lay: round(v["wall_ms"], 2) for lay, v in z15["decode"].items()},
        **{f"peak less held GB a rank ({key})": {
            shape: [round(max(a[key], b[key]), 3) for a, b in
                    zip(ep[shape]["prefill"], ep[shape]["decode"])]
            for shape in ("(1, 2)", "(2, 2)")}
           for key in ("raw_gb", "over_gb")},
        "decode against phase 14's run (rank 0)": {
            shape: ep[shape]["decode"][0]["vs_phase14"]
            for shape in ("(1, 2)", "(2, 2)")},
        "one period's expert banks GB": round(ep["(1, 2)"]["bank_gb"], 3),
        "seconds": round(ep["seconds"], 1)}


def ep_train_gates(shape, ranks, zero2, card, fails: list) -> dict:
    """Phase 17's training gates on the ranks of `shape` against `zero2`
    (phase 13's ZeRO-2 record on the same mesh: losses, the step-1
    accumulator and parameters, whole, resident bytes): the loss within
    MB_LOSS_TOL; the step-1 accumulator assembled from the ranks' shards
    within GRAD_REL_TOL of ZeRO-2's in each leaf's norm; the sharded
    AdamW within one bf16 ulp of the unsharded update of those
    gradients (phase 13's gate: Adam's first step is sign(g) lr, so a
    gradient that rounds to the other sign moves a weight by 2 lr,
    millions of ulps at a weight near 0, and ZeRO-2 is no oracle of it);
    resident bytes the dry-run's and below ZeRO-2's; the parameters
    still the rank's shards. Printed beside ZeRO-2's walls and peaks."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.checkpoint import leaf_paths
    cfg, opt, _ = _z2_setup()
    mesh = _logical(shape)
    aparams = abstract_params(cfg)
    specs = list(_leaves(SH.params_shardings(aparams, mesh, fsdp=True,
                                             ep_experts=True)))
    runs = [r["ep"]["train"] for r in ranks]
    acc = [SH.assemble(list(p), s) for s, p in zip(specs, zip(
        *[_leaves(torch.load(t["acc"], map_location="cpu")) for t in runs]))]
    p1 = [SH.assemble(list(p), s) for s, p in zip(specs, zip(
        *[_leaves(torch.load(t["params"], map_location="cpu"))
          for t in runs]))]
    rel = {k: float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
           for (k, _), g, w in zip(leaf_paths(aparams), acc, zero2["acc"])}
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL_TOL:
        fails.append(f"{shape} ep_experts training: the step-1 gradients "
                     f"{rel[worst]:.3e} of {worst}'s norm off ZeRO-2's")
    p0 = init_params(cfg, seed=0, device="cuda")
    it = iter(acc)
    g = O._map(lambda _: next(it).cuda(), p0)
    want, _ = opt.update(p0, g, opt.init(p0))
    del g, p0, acc
    ulps = [float(((a.cuda().float() - b.float()).abs()
                   / _ulp_bf16(b)).max()) for a, b in zip(p1, _leaves(want))]
    same = all(torch.equal(a, b) for a, b in zip(p1, _leaves(zero2["params"])))
    del want, p1
    gc.collect()
    torch.cuda.empty_cache()
    if max(ulps) > 1:
        fails.append(f"{shape} ep_experts training: the sharded update "
                     f"{max(ulps):.3f} bf16 ulp off the unsharded update of "
                     "its gradients")
    for r, t in zip(ranks, runs):
        name = f"{shape} ep_experts rank {r['rank']}"
        for i, st in enumerate(t["steps"]):
            if abs(st["loss"] - zero2["losses"][i]) > MB_LOSS_TOL:
                fails.append(f"{name} step {i + 1}: loss {st['loss']} "
                             f"against ZeRO-2's {zero2['losses'][i]}")
        if t["resident"]["params"] != t["reckoned"]["params"] or \
                t["resident"]["opt"] != t["reckoned"]["opt"]:
            fails.append(f"{name}: resident {t['resident']} != the "
                         f"dry-run's {t['reckoned']}")
        if not t["shards_kept"]:
            fails.append(f"{name}: the parameters are not its shards after "
                         "the step")
        if not sum(t["resident"].values()) < zero2["resident"]:
            fails.append(f"{name}: resident {sum(t['resident'].values())} "
                         f"not below ZeRO-2's {zero2['resident']}")
    t = runs[0]
    log(f"  [17] {shape} ZeRO-3 ep_experts training, {len(t['steps'])} "
        f"step: loss {t['steps'][0]['loss']:.6f} against ZeRO-2's "
        f"{zero2['losses'][0]:.6f} (held to {MB_LOSS_TOL:.0e}); the step-1 "
        f"gradients at most {rel[worst]:.3e} of the norm off ZeRO-2's "
        f"({worst}; held to {GRAD_REL_TOL:.0e}); the sharded update "
        f"{max(ulps):.3f} bf16 ulp off the unsharded update of its "
        f"gradients (held to 1); parameters "
        + ("bit for bit with ZeRO-2's" if same else "not bit for bit with "
           "ZeRO-2's (whose F-split sums the expert partials otherwise)"))
    for r, t in zip(ranks, runs):
        log(f"  [17] {shape} ep_experts rank {r['rank']} "
            f"{tuple(r['coords'])}: step wall "
            f"{[round(s['wall_ms'], 1) for s in t['steps']]} ms; host ms "
            f"{[_per_call(s['collective_ms'], 1) for s in t['steps']]}; GB "
            f"{[_per_call(s['collective_bytes'], 1, 1e9) for s in t['steps']]}"
            f"; resident {t['resident']} bytes == the dry-run's reckoning "
            f"(ep_experts, fsdp_params on), ZeRO-2's {zero2['resident']}; "
            f"peak {t['peak_gb']:.2f} GB (ZeRO-2 {zero2['peak_gb']:.2f}); on "
            f"{card}")
    return {"losses": [s["loss"] for s in runs[0]["steps"]],
            "grad_rel": rel[worst], "ulps": max(ulps), "bitwise": same,
            "walls": [[s["wall_ms"] for s in t["steps"]] for t in runs],
            "resident": [t["resident"] for t in runs],
            "peak_gb": [t["peak_gb"] for t in runs]}


# ------------------------------------------------------------ phase 15

# phase 15: the ZeRO-3 layout (params_shardings(fsdp=True)): each leaf
# held as this rank's (data, model) shard and gathered over the data
# group at use, a layer period at a time, ranks on cuda:0.
# (a) mixtral-8x7b at its published widths, Z3_LAYERS deep, bf16, impl
# "auto": phase 13's prefill cell (TP_PREFILL_B x TP_PREFILL_S) and phase
# 14's decode cell (DEC_B rows, a DEC_PREFILL-token prefill into DEC_SLOTS
# slots, the first of its steps fed the same tokens) on each mesh of
# Z3_SERVE under its cache layout, against the same mesh's fsdp=False
# step from
# the same weights and inputs in the same process: logits and caches bit
# for bit where two runs of the fsdp=False step agree bit for bit (the
# witness), else at phase 14's TOL[bf16] elementwise and DEC_REL in norm;
# the control (``SwappedShards``: the data shards of layer 0's attention
# output projection gathered in swapped order) must fail the gate that
# applies. (b) phase 12's training cell through make_train_step(
# param_shardings=) for Z3_TRAIN[shape] steps, against the ZeRO-2 step
# on the same mesh from the same weights and batches (phase 12's ranks
# on (2, 1), phase 13's on (2, 2), which this phase reads back): each
# step's loss within MB_LOSS_TOL, the assembled parameters after the last
# step within one bf16 ulp of ZeRO-2's (bit for bit reported).
# phase 14's (2, 2) depth: every ZeRO-3 call gathers the whole model
# shard (~3.4 GB a call on (2, 1) at one layer, the expert banks 82% of
# it)
Z3_LAYERS = DEC_22_LAYERS
# Each mesh's decode cell: (the name of phase 14's cache layout, its
# ``cache_shardings`` keywords, decode steps). Every ZeRO-3 step gathers
# the model shard again (3.4 GB on (2, 1), 1.7 on (2, 2)) and the
# script's time holds neither both layouts a mesh nor phase 14's 16
# steps: (2, 1) runs the default layout (rows over data, no sequence
# split) for 4 steps; (2, 2) runs seq_over_dp through DEC_CROSS, whose
# write is the first into its second data rank's slots, and one after.
Z3_SERVE = {(2, 1): ("default", {}, 4),
            (2, 2): ("seq_over_dp", {"seq_over_dp": True}, DEC_CROSS + 1)}
# (2, 1) trains phase 12's two steps, against its ZeRO-2 parameters after
# the second; (2, 2) phase 13's one
Z3_TRAIN = {(2, 1): Z2_STEPS, (2, 2): 1}


class SwappedShards:
    """The control of phase 15's serving gate: within the block, the data
    group's shards of one leaf (`leaf`: each period's slice of it that
    starts its storage, period 0) are concatenated in rolled order, one
    shard over: at data 2 swapped."""

    def __init__(self, leaf):
        self.ptr = leaf.untyped_storage().data_ptr()
        self.hits = 0

    def __enter__(self):
        from repro_torch.distributed import tensor_parallel as TP
        self._tp, self._fn = TP, TP.gather_from_data
        inner = self._fn

        def run(x, mesh, dim, sink=None):
            y = inner(x, mesh, dim, sink)
            if x.untyped_storage().data_ptr() == self.ptr and \
                    x.storage_offset() == 0 and y.shape[dim] != x.shape[dim]:
                self.hits += 1
                y = torch.roll(y, x.shape[dim], dim)
            return y

        TP.gather_from_data = run
        return self

    def __exit__(self, *exc):
        self._tp.gather_from_data = self._fn


def _z3_layouts(mesh, cfg):
    """(fsdp=False shards, their shardings, ZeRO-3 shards, theirs) of
    `cfg`'s parameters on this rank, built whole on the card one rank at
    a time and cut."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import init_params
    for r in range(mesh.size):
        if mesh.rank == r:
            full = init_params(cfg, seed=0, device="cuda")
            ps2 = SH.params_shardings(full, mesh, fsdp=False)
            ps3 = SH.params_shardings(full, mesh, fsdp=True)
            out = (SH.shard_tree(full, ps2, copy=True), ps2,
                   SH.shard_tree(full, ps3, copy=True), ps3)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _within(got: list, want: list) -> tuple[bool, float, float]:
    """(every tensor of `got` within TOL[bf16] of `want`'s elementwise
    and within DEC_REL in norm, the max |err|, the largest norm ratio)."""
    tol, ok, err, rel = TOL[torch.bfloat16], True, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        r = float((g - w).norm() / w.norm().clamp_min(1e-30))
        ok &= bool((d <= tol + tol * w.abs()).all()) and r <= DEC_REL
        err, rel = max(err, float(d.max())), max(rel, r)
    return ok, err, rel


def _z3_pair(got: list, want: list) -> dict:
    """`got` against `want` (lists of tensors), bit for bit and at the
    tolerance (``_within``)."""
    ok, err, rel = _within(got, want)
    return {"same": _same(got, want), "within": ok, "max_abs_err": err,
            "rel": rel}


def _z3_compare(runs: dict, key: str = "logits",
                names=("B", "zero3", "control")) -> dict:
    """Phase 15's serving records of one cell: the tensors under `key`
    of each run of `names` against the first fsdp=False run's ("A"):
    the witness ("B"), the ZeRO-3 run, the control."""
    return {name: _z3_pair(runs[name][key], runs["A"][key])
            for name in names}


def z3_prefill(mesh, cfg, layouts, card_hits: list) -> dict:
    """Phase 15 (a)'s prefill on this rank: the fsdp=False step twice
    (A, then the witness B), the ZeRO-3 step counted and timed, the
    control; each one's global last-position logits on the card."""
    from repro_torch.models import model as M
    sh2, ps2, sh3, ps3 = layouts
    batch = _tp_prefill_batch(cfg)
    step2 = M.make_prefill_step(cfg, param_shardings=ps2)
    step3 = M.make_prefill_step(cfg, param_shardings=ps3)
    runs, rec = {}, {}
    with torch.no_grad():
        step2(sh2, batch)   # warm
        for name in ("A", "B"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, m = step2(sh2, batch)
            torch.cuda.synchronize()
            rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            runs[name] = {"logits": [lg], "metrics": m}
        K.reset_launch_counts()
        mesh.host_ms.clear()
        mesh.nbytes.clear()
        with KernelShapes() as shapes:
            t0 = time.perf_counter()
            lg, m = step3(sh3, batch)
            torch.cuda.synchronize()
        rec["zero3_ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(launches=dict(K.launch_counts()), shapes=dict(shapes.seen),
                   collective_ms=dict(mesh.host_ms),
                   collective_bytes=dict(mesh.nbytes))
        runs["zero3"] = {"logits": [lg], "metrics": m}
        ctrl = SwappedShards(sh3["layers"][0]["attn"]["wo"])
        with ctrl:
            lg, _ = step3(sh3, batch)
        card_hits.append(ctrl.hits)
        runs["control"] = {"logits": [lg]}
    rec["compare"] = _z3_compare(runs)
    rec["metrics_same"] = all(
        torch.equal(runs["zero3"]["metrics"][k], runs["A"]["metrics"][k])
        for k in ("expert_load", "dropped"))
    return rec


def z3_decode(mesh, cfg, layouts, layout: dict, steps: int,
              card_hits: list) -> dict:
    """Phase 15 (a)'s decode cell on this rank under `layout`, `steps`
    decode steps after the prefill: the
    fsdp=False serve step (A: greedy, its tokens fed to every other
    run), again (the witness B), the ZeRO-3 step (its decode steps
    counted and timed); the control, the ZeRO-3 step's first decode
    step again from its post-prefill cache with the shards swapped. The
    global last-position logits of every step and the final cache
    shards, compared on the card."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    sh2, ps2, sh3, ps3 = layouts
    whole = T.init_cache(cfg, sh2, DEC_B, DEC_SLOTS)
    cs = SH.cache_shardings(whole, mesh, **layout)
    held0 = SH.shard_tree(whole, cs, copy=True)
    del whole
    cl = torch.full((DEC_B,), DEC_PREFILL, dtype=torch.int32, device="cuda")
    prompts = dec_prompts(cfg, DEC_B)
    runs, teacher = {}, None
    for name, params, ps in (("A", sh2, ps2), ("B", sh2, ps2),
                             ("zero3", sh3, ps3)):
        # four ranks' prefill transients share the card: hand back what
        # the last run's left reserved
        gc.collect()
        torch.cuda.empty_cache()
        step = M.make_serve_step(cfg, param_shardings=ps, cache_shardings=cs)
        held = clone_tree(held0)
        rec, counted = {"walls": []}, name == "zero3"
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, held = step(params, {"tokens": prompts}, held, 0)
            torch.cuda.synchronize()
            rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            # a copy: a view would hold the prefill's (B, S, V) logits
            logits, tokens = [lg[:, -1].clone()], []
            del lg
            if counted:
                snap = clone_tree(held)
                K.reset_launch_counts()
                mesh.host_ms.clear()
                mesh.nbytes.clear()
            with KernelShapes() if counted else \
                    contextlib.nullcontext() as shapes:
                for i in range(steps):
                    fed = logits[-1].float().argmax(-1).to(torch.int32) \
                        if teacher is None else teacher[:, i]
                    tokens.append(fed)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, held = step(params, {"tokens": fed[:, None]}, held,
                                    cl + i)
                    torch.cuda.synchronize()
                    rec["walls"].append((time.perf_counter() - t0) * 1e3)
                    logits.append(lg[:, -1].clone())
            if counted:
                rec.update(launches=dict(K.launch_counts()),
                           shapes=dict(shapes.seen),
                           collective_ms=dict(mesh.host_ms),
                           collective_bytes=dict(mesh.nbytes))
                ctrl = SwappedShards(sh3["layers"][0]["attn"]["wo"])
                with ctrl:
                    lg, _ = step(params, {"tokens": teacher[:, :1]}, snap,
                                 cl)
                card_hits.append(ctrl.hits)
                control = [lg[:, -1].clone()]
                del snap
        if teacher is None:
            teacher = torch.stack(tokens, 1)
        rec.update(logits=logits, cache=[t for c in held
                                         for t in c["attn"].values()])
        runs[name] = rec
        del held, step
    out = {k: v for k, v in runs["zero3"].items()
           if k not in ("logits", "cache")}
    out.update(compare=dict(_z3_compare(runs, names=("B", "zero3")),
                            control=_z3_pair(control,
                                             runs["A"]["logits"][1:2])),
               cache=_z3_compare(runs, "cache", ("B", "zero3")),
               fsdp_false_walls=runs["A"]["walls"],
               cache_bytes=_nbytes(held0))
    del runs, held0
    return out


def z3_serve(mesh, shape) -> dict:
    """Phase 15 (a) on this rank: the parameters in both layouts, the
    resident bytes against the dry-run's reckoning of the default
    variant's prefill and decode steps on this mesh, then the prefill
    and each decode layout."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    cfg = _mixtral("bfloat16", Z3_LAYERS)
    layouts = _z3_layouts(mesh, cfg)
    reckoned = {}
    for kind, s, b in (("prefill", TP_PREFILL_S, TP_PREFILL_B),
                       ("decode", DEC_SLOTS, DEC_B)):
        _, args, shardings = D.build_step(cfg, InputShape(kind, s, b, kind),
                                          mesh=mesh)
        reckoned[kind] = SH.shard_nbytes(args[0], shardings(mesh)[0])
    out = {"resident": _nbytes(layouts[2]), "fsdp_false": _nbytes(layouts[0]),
           "reckoned": reckoned, "hits": []}
    T.set_moe_dispatch_groups(shape[0])
    try:
        torch.cuda.reset_peak_memory_stats()
        out["prefill"] = z3_prefill(mesh, cfg, layouts, out["hits"])
        name, lay, steps = Z3_SERVE[shape]
        out["decode"] = {name: z3_decode(mesh, cfg, layouts, lay, steps,
                                         out["hits"])}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        T.set_moe_dispatch_groups(1)
    del layouts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def z3_train(mesh, shape, tmp: str, ep: bool = False) -> dict:
    """Phase 15 (b) on this rank: phase 12's cell through the ZeRO-3 step
    (``make_train_step(param_shardings=)``) for Z3_TRAIN[shape] steps;
    each step's loss, wall and collectives, the resident bytes against
    the dry-run's reckoning of the default variant's train step, the
    final (data, model) shards to a file in `tmp`. With `ep` (phase 17)
    the layout is ``params_shardings(fsdp=True, ep_experts=True)``, the
    reckoning the ``ep_experts`` variant's, and step 1 runs in its two
    halves, its float32 accumulator shards to a file in `tmp` too."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.model import init_params
    cfg, opt, batches = _z2_setup()
    T.set_moe_dispatch_groups(shape[0])
    try:
        full = init_params(cfg, seed=0, device="cuda")
        ps = SH.params_shardings(full, mesh, fsdp=True, ep_experts=ep)
        params = SH.shard_tree(full, ps, copy=True)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        state = opt.init(params)
        step = M.make_train_step(cfg, opt, microbatches=Z2_MB,
                                 param_shardings=ps)
        _, args, shardings = D.build_step(
            cfg, InputShape("z3", TRAIN_SEQ, TRAIN_BATCH, "train"),
            {"microbatches": Z2_MB, "ep_experts": ep}, mesh=mesh)
        reckoned = {k: SH.shard_nbytes(a, s) for k, a, s in
                    zip(("params", "opt", "batch"), args, shardings(mesh))}
        want = [tuple(SH.shard_shape(a.shape, s)) for a, s in
                zip(_leaves(args[0]), _leaves(shardings(mesh)[0]))]
        out = {"steps": [], "reckoned": reckoned}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tag = "ep" if ep else ""
        for i, b in enumerate(batches[:Z3_TRAIN[shape]]):
            mesh.host_ms.clear()
            mesh.nbytes.clear()
            t0 = time.perf_counter()
            if ep and i == 0:
                m, g = step.grads(params, b)
                with torch.no_grad():
                    params, state = step.apply(params, g, state)
            else:
                params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            out["steps"].append({
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(m["loss"]), "aux_loss": float(m["aux_loss"]),
                "collective_ms": dict(mesh.host_ms),
                "collective_bytes": dict(mesh.nbytes)})
            if ep and i == 0:
                out["acc"] = os.path.join(tmp, f"z3{tag}a{mesh.rank}.pt")
                torch.save(_host(g), out["acc"])
                del g
        out["resident"] = {"params": _nbytes(params), "opt": _nbytes(state),
                           "batch": step.stats["batch_bytes"]}
        out["shards_kept"] = [tuple(t.shape) for t in _leaves(params)] == want
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["params"] = os.path.join(tmp, f"z3{tag}p{mesh.rank}.pt")
        torch.save(_host(params), out["params"])
    finally:
        T.set_moe_dispatch_groups(1)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def z3_rank(rank: int, shape: tuple, tmp: str) -> dict:
    """One rank of phase 15 on a (data, model) = `shape` mesh: (a), then
    (b). Everything returned lives on the host."""
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_process_mesh(*shape, device="cuda:0",
                             transport="shared")
    out = {"rank": rank, "coords": mesh.coords,
           "serve": z3_serve(mesh, shape),
           "train": z3_train(mesh, shape, tmp)}
    out["seconds"] = time.perf_counter() - t0
    return out


def _z3_said(c: dict) -> str:
    """One comparison of ``_z3_compare`` in words."""
    return "bit for bit" if c["same"] else \
        f"max |err| {c['max_abs_err']:.3e}, rel {c['rel']:.3e}"


def _z3_cell_gate(name, cmp: dict, fails: list) -> str:
    """The serving gate of one cell on one rank (module docstring): bit
    for bit where the witness is, else at the tolerance; the control
    must fail the gate that applies. Without "control" in `cmp` (a
    cache) only the first part."""
    exact = cmp["B"]["same"]
    key = "same" if exact else "within"
    if not cmp["zero3"][key]:
        fails.append(f"{name}: ZeRO-3 against fsdp=False: "
                     f"{_z3_said(cmp['zero3'])}, beyond the gate "
                     f"({'bit for bit' if exact else 'the tolerance'})")
    text = (f"witness (two fsdp=False runs) {_z3_said(cmp['B'])}; ZeRO-3 "
            f"{_z3_said(cmp['zero3'])} (gated "
            f"{'bit for bit' if exact else f'at TOL[bf16], rel {DEC_REL}'})")
    if "control" not in cmp:
        return text
    if cmp["control"][key]:
        fails.append(f"{name}: the control (swapped shards) passed the gate")
    return text + f"; the control {_z3_said(cmp['control'])}"


def _z3_launch_gate(name, run, calls: int, attn: int, fails: list) -> str:
    """The kernels of one ZeRO-3 run: the expert kernels `calls` times
    each (once a layer a call), decode attention `attn` times, bf16 on
    "wgmma" and "mma"."""
    for k_name, n in (("fused_gate_up", calls), ("gmm", calls),
                      ("decode_attention", attn)):
        if run["launches"][k_name] != n:
            fails.append(f"{name}: {k_name} launched "
                         f"{run['launches'][k_name]} times, not {n}")
    paths = []
    for (k_name, xs, ws, dt, stats), n in run["shapes"].items():
        x = torch.empty(xs, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(ws, dtype=torch.bfloat16, device="cuda")
        if k_name == "decode_attention":
            path, want = DA.kernel_path(x, w, w)[0], "mma"
        else:
            path, want = MG.kernel_path(x, w, k_name == "fused_gate_up")[0], \
                "wgmma"
        if path != want or "bfloat16" not in dt:
            fails.append(f"{name}: {k_name} at {xs} x {ws} took {path}")
        paths.append(f"{n} {k_name} {xs}x{ws} {path}"
                     + (" stats" if stats else ""))
        del x, w
    return "; ".join(paths)


def _per_call(d: dict, n: int, scale: float = 1.0) -> dict:
    return {k: round(v / n / scale, 2) for k, v in d.items()}


def z3_serve_gates(shape, ranks, card, fails: list) -> dict:
    """Phase 15 (a)'s gates on one mesh's ranks; printed with walls,
    collectives, bytes and peaks."""
    cfg = _mixtral("bfloat16", Z3_LAYERS)
    steps = Z3_SERVE[shape][2]
    for r in ranks:
        s = r["serve"]
        name = f"{shape} rank {r['rank']}"
        if s["resident"] != s["reckoned"]["prefill"] or \
                s["resident"] != s["reckoned"]["decode"]:
            fails.append(f"{name}: resident parameter bytes {s['resident']} "
                         f"!= the dry-run's {s['reckoned']}")
        if not s["resident"] < s["fsdp_false"]:
            fails.append(f"{name}: ZeRO-3 holds {s['resident']} bytes, not "
                         f"below fsdp=False's {s['fsdp_false']}")
        if not all(h > 0 for h in s["hits"]):
            fails.append(f"{name}: the control swapped nothing ({s['hits']})")
        p = s["prefill"]
        text = _z3_cell_gate(f"{name} prefill", p["compare"], fails)
        if not p["metrics_same"]:
            fails.append(f"{name} prefill: loads or drops differ")
        paths = _z3_launch_gate(f"{name} prefill", p, cfg.num_layers, 0,
                                fails)
        log(f"  {name} prefill {TP_PREFILL_B} x {TP_PREFILL_S}, "
            f"{cfg.num_layers} of 32 layers, bf16: {text}; loads and drops "
            f"{'equal' if p['metrics_same'] else 'DIFFER'}; launches {paths}; "
            f"wall {p['zero3_ms']:.1f} ms (fsdp=False {p['B_ms']:.1f}); "
            f"host ms by collective "
            f"{ {k: round(v, 1) for k, v in p['collective_ms'].items()} }, "
            f"MB {_per_call(p['collective_bytes'], 1, 1e6)}; on {card}")
        for lay, d in s["decode"].items():
            cell = f"{name} decode {lay}"
            text = _z3_cell_gate(cell, d["compare"], fails)
            ctext = _z3_cell_gate(cell + " cache", d["cache"], fails)
            n = cfg.num_layers * steps
            paths = _z3_launch_gate(cell, d, n, n, fails)
            log(f"  {cell}, B {DEC_B}, a {DEC_PREFILL}-token prefill into "
                f"{DEC_SLOTS} slots + {steps} steps: logits {text}; "
                f"caches: {ctext}; launches "
                f"{paths}; decode step wall median "
                f"{float(np.median(d['walls'])):.1f} ms (fsdp=False "
                f"{float(np.median(d['fsdp_false_walls'])):.1f}), prefill "
                f"{d['prefill_ms']:.0f} ms; host ms a step by collective "
                f"{_per_call(d['collective_ms'], steps)}, MB a step "
                f"{_per_call(d['collective_bytes'], steps, 1e6)}; on "
                f"{card}")
        log(f"  {name}: parameters resident {s['resident']} bytes == the "
            f"dry-run's reckoning (fsdp_params on) {s['reckoned']}; "
            f"fsdp=False {s['fsdp_false']}; peak {s['peak_gb']:.2f} GB "
            f"(both layouts held); on {card}")
    r0 = ranks[0]["serve"]
    out = {"resident": [r["serve"]["resident"] for r in ranks],
           "fsdp_false": r0["fsdp_false"], "peak_gb":
           [r["serve"]["peak_gb"] for r in ranks],
           "prefill_ms": [r["serve"]["prefill"]["zero3_ms"] for r in ranks],
           "prefill_fsdp_false_ms": r0["prefill"]["B_ms"],
           "launches": [{k: sum(d["launches"][k] for d in
                                r["serve"]["decode"].values())
                         + r["serve"]["prefill"]["launches"][k]
                         for k in ("fused_gate_up", "gmm",
                                   "decode_attention")} for r in ranks],
           "decode": {lay: {"wall_ms": float(np.median(d["walls"])),
                            "fsdp_false_ms": float(np.median(
                                d["fsdp_false_walls"])),
                            "gathered_mb_a_step": d["collective_bytes"].get(
                                "all_gather/data/params", 0) / steps
                            / 1e6}
                      for lay, d in r0["decode"].items()}}
    return out


def z3_train_gates(shape, ranks, zero2, card, fails: list) -> dict:
    """Phase 15 (b)'s gates on one mesh's ranks against `zero2`, the
    ZeRO-2 step's record on the same mesh ({losses, params: the whole
    leaves after the last step, resident, peak_gb})."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import abstract_params
    cfg, _, _ = _z2_setup()
    mesh = _logical(shape)
    specs = _leaves(SH.params_shardings(abstract_params(cfg), mesh,
                                        fsdp=True))
    # on the card: the host takes ~25 s a mesh for these 1.7 B elements
    parts = [_leaves(torch.load(r["train"]["params"], map_location="cuda"))
             for r in ranks]
    ulps, same = [], True
    for s, p, want in zip(specs, zip(*parts), _leaves(zero2["params"])):
        a, b = SH.assemble(list(p), s), want.cuda()
        ulps.append(float(((a.float() - b.float()).abs()
                           / _ulp_bf16(b)).max()))
        same &= bool(torch.equal(a, b))
        del a, b
    del parts
    gc.collect()
    torch.cuda.empty_cache()
    if max(ulps) > 1:
        fails.append(f"{shape} training: the parameters after the last step "
                     f"{max(ulps):.3f} bf16 ulp off ZeRO-2's")
    for r in ranks:
        t = r["train"]
        for i, s in enumerate(t["steps"]):
            want = zero2["losses"][i]
            if abs(s["loss"] - want) > MB_LOSS_TOL:
                fails.append(f"{shape} rank {r['rank']} step {i + 1}: loss "
                             f"{s['loss']} against ZeRO-2's {want}")
        if t["resident"]["params"] != t["reckoned"]["params"] or \
                t["resident"]["opt"] != t["reckoned"]["opt"]:
            fails.append(f"{shape} rank {r['rank']}: resident {t['resident']}"
                         f" != the dry-run's {t['reckoned']}")
        if not t["shards_kept"]:
            fails.append(f"{shape} rank {r['rank']}: the parameters are not "
                         "the (data, model) shards after the steps")
        if not sum(t["resident"].values()) < zero2["resident"]:
            fails.append(f"{shape} rank {r['rank']}: resident "
                         f"{sum(t['resident'].values())} not below ZeRO-2's "
                         f"{zero2['resident']}")
    t = ranks[0]["train"]
    log(f"  {shape} training, {len(t['steps'])} step(s): losses "
        f"{[round(s['loss'], 6) for s in t['steps']]} against ZeRO-2's "
        f"{[round(x, 6) for x in zero2['losses'][:len(t['steps'])]]} (held "
        f"to {MB_LOSS_TOL:.0e}); parameters after the last step "
        f"{'bit for bit' if same else 'within %.3f bf16 ulp' % max(ulps)} of "
        f"ZeRO-2's (held to 1 ulp)")
    for r in ranks:
        t = r["train"]
        gb = [_per_call(s["collective_bytes"], 1, 1e9) for s in t["steps"]]
        log(f"  {shape} rank {r['rank']} {tuple(r['coords'])}: step walls "
            f"{[round(s['wall_ms'], 1) for s in t['steps']]} ms; host ms a "
            f"step {[_per_call(s['collective_ms'], 1) for s in t['steps']]};"
            f" GB a step {gb}; resident {t['resident']} bytes == the "
            f"dry-run's reckoning (fsdp_params on), ZeRO-2's "
            f"{zero2['resident']}; peak "
            f"{t['peak_gb']:.2f} GB (ZeRO-2 {zero2['peak_gb']:.2f}); "
            f"{r['seconds']:.1f} s from its start to its return; on {card}")
    return {"losses": [s["loss"] for s in ranks[0]["train"]["steps"]],
            "bitwise": same, "ulps": max(ulps),
            "walls": [[s["wall_ms"] for s in r["train"]["steps"]]
                      for r in ranks],
            "resident": [r["train"]["resident"] for r in ranks],
            "peak_gb": [r["train"]["peak_gb"] for r in ranks]}


def zero3_phase(card: str, zero2: dict) -> dict:
    """Phase 15: for each mesh of Z3_SERVE the ranks (``launch.mesh.
    spawn_local`` on cuda:0), serving then training, gated as the
    module docstring says. `zero2`: {shape: the ZeRO-2 step's record on
    that mesh} (phases 12 and 13)."""
    from repro_torch.launch.mesh import spawn_local
    t15 = time.perf_counter()
    res, fails = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for shape in Z3_SERVE:
            t0 = time.perf_counter()
            ranks = spawn_local(z3_rank, shape[0] * shape[1], backend="gloo",
                                args=(shape, tmp), wall_s=900.0,
                                start_method=START_METHOD)
            log(f"  {len(ranks)} ranks on {shape} {ON_CARD} "
                f"{time.perf_counter() - t0:.1f} s")
            res[str(shape)] = {
                "serve": z3_serve_gates(shape, ranks, card, fails),
                "train": z3_train_gates(shape, ranks, zero2[shape], card,
                                        fails)}
    res["seconds"] = time.perf_counter() - t15
    log(f"  phase 15 took {res['seconds']:.1f} s")
    if fails:
        raise AssertionError("phase 15: " + "; ".join(fails))
    return res


# ------------------------------------------------------------ phase 18

# The paper's trace replay (``launch/serve_trace.py``) at published
# widths: one ``generate_requests`` trace of 23 requests (3 s at a peak
# rate of 16 a second), each to at most 16 new tokens, prompts clipped
# to 256 tokens (half of max_len), 8 KV slots, 8 modeled devices.
REPLAY_TRACE = dict(duration_s=3.0, base_rate=16.0, seed=0)
REPLAY_SLOTS, REPLAY_MAX_LEN, REPLAY_MAX_NEW = 8, 512, 16
# At these depths the v5e cost model prices a decode iteration at ~3
# ms (phi-3.5-moe, 8 layers) and ~1.6 ms (mixtral-8x7b, 4; each replay
# prints its mean layer ms): a 16-token request lives ~50 ms of modeled
# time while the arrivals span 3 s, so at time_scale 1 hardly two
# requests would share a batch. At 20 a request lives about the gap of
# 8 arrivals and the batch fills at the trace's peak (each replay
# prints its mean occupancy: 4.1-6.2 of 8).
REPLAY_TIME_SCALE = 20.0
# phi-3.5-moe's runtime-off replay: 8 of 32 layers, mixtral's cut (32
# layers of expert banks are 80.5 GB). The runtime-on replays of both
# models: 4 of 32, for the slot banks. MoEless's serverless pool keeps
# each instance warm for its 60 s keep-alive, past the whole modeled
# span, so instances pile up: each replay prints the most slots a layer
# held, and MoEless's pool on phi's geometry (E 16, 8 devices) holds
# 125 of 128 (16 on one device), more than 15 a device could give. So
# MoEless gets E slots a device (``ControlPlane(
# max_replicas_per_device=E)``, which the reference's balancer takes;
# phase 4c's geometry for mixtral, whose pool holds 43 of 64): a device
# never holds more than E instances, so no allocation can fail. 128
# int8 slots of phi are 10.07 GB a layer, which at 8 layers cannot sit
# beside the weights. The other strategies take no slot setting and
# keep the default (phi 5 a device, mixtral 3; they hold at most 4 and
# 2). Banks are single-buffered, as in phase 4c.
REPLAY_LAYERS, REPLAY_RUNTIME_LAYERS = 8, RUNTIME_LAYERS
# the float32 gate: phi-3.5-moe at 2 layers (~10 GB), 7 requests of at
# most 8 tokens, int8 banks, kernels (impl "cuda") against plain ("ref")
REPLAY_F32_LAYERS, REPLAY_F32_MAX_NEW = 2, 8
REPLAY_F32_TRACE = dict(duration_s=1.0, base_rate=16.0, seed=0)


def first_periods(params, n: int):
    """`params` with every layer leaf cut to its first `n` periods, as
    views: the weights of the same model `n` periods deep."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cut(v) for v in tree]
        return tree[:n]
    return {**params, "layers": cut(params["layers"])}


class PlainCalls:
    """Within the block, counts the calls of each kernel's plain version
    through the dispatch (``kernels/ops.py``): none may come while the
    kernels serve on the card."""

    def __enter__(self):
        from repro_torch.kernels import ref as KR
        self.counts = {}
        self._saved = []
        for mod, fn_name in ((KR, "expert_ffn_ref"),
                             (KR, "expert_ffn_ref_quant"), (KR, "gmm_ref"),
                             (KR, "gmm_ref_quant"),
                             (DA, "decode_attention_ref"),
                             (DA, "decode_attention_paged_ref")):
            fn = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, fn))

            def counted(*a, _fn=fn, _name=fn_name, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **kw)

            setattr(mod, fn_name, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self._saved:
            setattr(mod, fn_name, fn)


class ApplyTimer:
    """Within the block, the host seconds and calls of
    ``ExpertRuntime.apply`` (the slot state machine and its flush), and
    the most slots any layer, and any device of a layer, held after a
    call (of ``total_slots`` and ``slots_per_device``)."""

    def __enter__(self):
        from repro_torch.serving.expert_runtime import ExpertRuntime
        self.s, self.calls = 0.0, 0
        self.held = {"layer": 0, "device": 0}
        self._cls, self._fn = ExpertRuntime, ExpertRuntime.apply
        inner = self._fn

        def apply(rt, *a, **kw):
            t = time.perf_counter()
            try:
                return inner(rt, *a, **kw)
            finally:
                self.s += time.perf_counter() - t
                self.calls += 1
                used = (rt.slot_expert != rt.num_experts).reshape(
                    rt.n_layers, rt.num_devices, -1).sum(-1)
                self.held = {
                    "layer": max(self.held["layer"], int(used.sum(1).max())),
                    "device": max(self.held["device"], int(used.max())),
                    "of": (rt.total_slots, rt.slots_per_device)}

        ExpertRuntime.apply = apply
        return self

    def __exit__(self, *exc):
        self._cls.apply = self._fn


def replay_identity(rp) -> dict:
    """What the float32 gate holds equal: tokens, iterations, clock and
    drops; the control plane's per-layer latencies, replica counts, cost
    and host transfers; the runtime's starts and bytes moved."""
    res, c, st = rp.result, rp.control, rp.stats
    return {"tokens": [list(r.tokens) for r in rp.requests],
            "iterations": res.iterations, "clock_s": res.clock_s,
            "dropped_tokens": res.dropped_tokens,
            "layer_latency": list(c.layer_latency),
            "replica_counts": list(c.replica_counts), "cost": c.cost,
            "host_transfers": c.host_transfers,
            "runtime": None if st is None else
            (st.counts(), st.transfers, st.bytes_moved)}


def replay_run(label, cfg, params, trace, strategy, runtime: str,
               max_new: int = REPLAY_MAX_NEW) -> dict:
    """One strategy's replay through ``serve_trace.replay`` (8 slots, the
    phase's time scale, single-buffered banks), with that run's kernel
    launches, their paths, the plain versions' calls, the host time of
    the runtime's ``apply`` and the peak memory. Every request must end
    with its budget. Returns the record."""
    from repro_torch.launch.serve_trace import replay
    # MoEless's slot setting (see REPLAY_LAYERS); the others take none
    slots = {"max_replicas_per_device": cfg.moe.num_experts} \
        if strategy == "moeless" else {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with GmmPaths() as gp, AttnPaths() as ap, PlainCalls() as pc, \
            ApplyTimer() as at:
        rp = replay(cfg, params, trace, strategy, slots=REPLAY_SLOTS,
                    max_len=REPLAY_MAX_LEN, max_new=max_new, distance=1,
                    expert_runtime=runtime, time_scale=REPLAY_TIME_SCALE,
                    seed=0, runtime_double_buffer=False,
                    num_devices=EP_DEVICES, **slots)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = K.launch_counts()
    res, st, s = rp.result, rp.stats, rp.result.summary()
    check_budgets(rp.requests, f"{label} request")
    if res.rejected or len(rp.requests) != len(trace):
        raise AssertionError(f"{label}: {res.rejected} rejected of "
                             f"{len(rp.requests)}")
    ms = {m: (s[m]["p50"] * 1e3, s[m]["p99"] * 1e3)
          for m in ("ttft", "tpot", "e2e")}
    out = dict(
        requests=len(rp.requests), iterations=res.iterations,
        prefills=res.prefills, occupancy=res.mean_batch_occupancy,
        dropped_tokens=res.dropped_tokens, tokens=res.generated_tokens,
        wall_s=res.wall_s, iter_ms=float(np.median(rp.iter_walls)) * 1e3,
        tokens_per_s=res.generated_tokens / res.wall_s,
        peak_gb=peak / 1e9, launches=launches,
        gmm_paths=gp.counts, attn_paths=ap.counts, plain=pc.counts,
        quant_paths={k: dict(v) for k, v in
                     MG.QUANT_PATH_LAUNCHES.items()},
        modeled_ms=ms, layer_ms=rp.control.mean_layer_ms(),
        cost=rp.control.cost, identity=replay_identity(rp))
    rt = ""
    if st is not None:
        out.update(starts=st.counts(), transfers=st.transfers,
                   bytes_moved=st.bytes_moved,
                   gb_s=st.instance_seconds_gb, apply_ms=at.s * 1e3,
                   apply_calls=at.calls, slots_held=at.held)
        rt = (f"; runtime c/w/p {st.counts()}, {st.transfers} copies, "
              f"{st.bytes_moved / 1e9:.3f} GB moved, "
              f"{st.instance_seconds_gb:.4g} GB-s, apply {at.s * 1e3:.1f} "
              f"ms host over {at.calls} calls, slots held at most "
              f"{at.held['layer']} of {at.held['of'][0]} a layer, "
              f"{at.held['device']} of {at.held['of'][1]} a device")
    log(f"  {label}: {out['requests']} requests, {res.iterations} "
        f"iterations + {res.prefills} prefills, occupancy "
        f"{res.mean_batch_occupancy:.2f}, {res.dropped_tokens:.0f} "
        f"dropped; wall {res.wall_s:.2f} s, iteration median "
        f"{out['iter_ms']:.2f} ms, {out['tokens_per_s']:.1f} decode "
        f"tokens/s by wall{rt}; peak {out['peak_gb']:.2f} GB")
    log(f"    modeled (v5e cost model, x{REPLAY_TIME_SCALE:g}) TTFT "
        f"p50/p99 {ms['ttft'][0]:.2f}/{ms['ttft'][1]:.2f} ms, TPOT "
        f"{ms['tpot'][0]:.3f}/{ms['tpot'][1]:.3f}, E2E "
        f"{ms['e2e'][0]:.1f}/{ms['e2e'][1]:.1f}, layer "
        f"{out['layer_ms']:.4f}, cost {out['cost']:.4g}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out


def _replay_launch_gate(label, rec, runtime: str, dtype) -> None:
    """The run launched ``decode_attention`` and the expert kernels of its
    path (int8 with the runtime on, bf16/float32 ``moe_gmm`` off), none of
    the other path's, each on the path its plan names at bf16, and never
    called a plain version."""
    n = rec["launches"]
    want = ("fused_gate_up_quant", "gmm_quant") if runtime == "on" \
        else ("fused_gate_up", "gmm")
    other = ("fused_gate_up", "gmm") if runtime == "on" \
        else ("fused_gate_up_quant", "gmm_quant")
    for k_name in want + ("decode_attention",):
        if n[k_name] <= 0:
            raise AssertionError(f"{label}: {k_name} was never launched")
    for k_name in other + ("decode_attention_paged",):
        if n[k_name]:
            raise AssertionError(f"{label}: {k_name} launched {n[k_name]} "
                                 "times off this run's path")
    if rec["plain"]:
        raise AssertionError(f"{label}: plain versions called "
                             f"{rec['plain']} with the card present")
    if dtype == torch.bfloat16:
        paths = {k: rec["gmm_paths"][k] for k in want} if runtime == "off" \
            else {k: rec["quant_paths"][k] for k in want}
        for k_name, by in paths.items():
            if by.get("wgmma", 0) != n[k_name]:
                raise AssertionError(f"{label}: {k_name} launches by path "
                                     f"{by} of {n[k_name]}, not all wgmma")
        if rec["attn_paths"] != {"mma": n["decode_attention"]}:
            raise AssertionError(f"{label}: decode_attention by path "
                                 f"{rec['attn_paths']}, not all mma")


def quant_shape_timed(gen, name, fused, label, shape, max_active) -> dict:
    """``fused_gate_up_quant`` or ``gmm_quant`` at one bf16 slot-bank shape
    (slots, C, D, F, rows a slot): the plan must be "wgmma"; against its
    plain version, timed beside its bound, the plain version and the
    library composition. Returns the record."""
    e, c, d, f, gs = shape
    x, ws, g = _quant_inputs(gen, e, c, d, f, torch.bfloat16, gs, fused)
    path, info = MG.quant_plan(x, ws[0], max_active, scale=ws[1])
    if path != "wgmma":
        raise AssertionError(f"{name}: the {label} shape took {path}")
    run_k = MG.fused_gate_up_quant if fused else MG.gmm_quant
    run_p = MG.fused_gate_up_quant_ref if fused else MG.gmm_quant_ref
    err = _quant_check(name, fused, label, x, ws, g, torch.bfloat16,
                       max_active)
    library, idx = _quant_library(fused, x, ws, g)
    ms = time_ms(lambda: run_k(x, *ws, g, max_active=max_active))
    plain_ms = time_ms(lambda: run_p(x, *ws, g), iters=5, reps=3)
    lib_ms = time_ms(library, iters=5, reps=3)
    nbytes, flops = _quant_bytes_flops(x, ws, g)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    log(f"  {name:<20} {label:<14} E={e} ({len(idx)} with rows) C={c} "
        f"D={d} F={f} bf16 x, int8 W ({path}, N={info['rows']}, "
        f"{info['stages']} stages, {info['smem']} B shared a CTA) "
        f"max_abs_err={err:.3e} ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{nbytes / 1e9:.3f} GB) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f}")
    del x, ws
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err, path=path)


def replay_kernel_shapes(gen, cfg) -> dict:
    """The expert kernels at phi-3.5-moe's serving shapes: ``fused_gate_up``
    and ``gmm`` at a decode step of 8 slots (C = ceil(1.25 x 2 x 8 / 16)
    = 2) and the 256-token prefill bucket (C 40), group sizes from a
    seeded routing clipped at the capacity; the int8 pair on the slot
    banks of the runtime-on replays: 40 slots (the default geometry) at
    decode, 128 (MoEless's) at decode and prefill, with rows in 16 slots
    at decode (8 tokens x top-2) and 32 at prefill. Returns {kernel:
    [record, ...]}, each with its "shape"."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    d, f = cfg.d_model, cfg.moe.d_ff
    rng = np.random.default_rng(18)
    out = {n: [] for n in ("fused_gate_up", "gmm", "fused_gate_up_quant",
                           "gmm_quant")}
    caps = {}
    for phase, n in (("decode", REPLAY_SLOTS), ("prefill", 256)):
        cap = caps[phase] = max(1, math.ceil(cfg.moe.capacity_factor * k
                                             * n / e))
        gs = np.minimum(np.bincount(rng.integers(0, e, n * k),
                                    minlength=e), cap).tolist()
        for name, fused, shape in (("fused_gate_up", True, (e, cap, d, f,
                                                            gs)),
                                   ("gmm", False, (e, cap, f, d, gs))):
            r = gmm_shape_timed(gen, name, fused, f"phi {phase}", shape)
            out[name].append(dict(shape=f"phi {phase} E{e} C{cap} "
                                  f"D{shape[2]} F{shape[3]}", **r))
    for phase, slots in (("decode", EP_DEVICES * 5), ("decode", EP_DEVICES
                                                     * e),
                         ("prefill", EP_DEVICES * e)):
        cap = caps[phase]
        live = REPLAY_SLOTS * k if phase == "decode" else 2 * e
        ma = min(slots, REPLAY_SLOTS * k if phase == "decode" else 256 * k)
        rows = [0] * slots
        for i in rng.choice(slots, live, replace=False):
            rows[i] = int(rng.integers(1 if phase == "decode" else cap // 4,
                                       cap + 1))
        for name, fused, shape in (
                ("fused_gate_up_quant", True, (slots, cap, d, f, rows)),
                ("gmm_quant", False, (slots, cap, f, d, rows))):
            r = quant_shape_timed(gen, name, fused, f"phi {phase} S{slots}",
                                  shape, ma)
            out[name].append(dict(shape=f"phi {phase} E{slots} ({live} "
                                  f"with rows) C{cap} D{shape[2]} "
                                  f"F{shape[3]}", **r))
    return out


def replay_f32_gate() -> dict:
    """The float32 gate: the four strategies' replays of a short trace on
    phi-3.5-moe at 2 layers with int8 banks, through the kernels (impl
    "cuda") and through the plain versions on the card (impl "ref"),
    equal exactly per strategy (``replay_identity``); the kernel runs
    never call a plain version, the plain runs launch nothing. The
    control, MoEless through the kernels with decode attention blind to
    the newest eighth of the keys (``BlindNewest``), must differ."""
    from repro_torch.configs import get_config
    from repro_torch.core.trace import TraceConfig, generate_requests
    from repro_torch.launch.serve_trace import STRATEGIES
    from repro_torch.models.model import init_params
    full = get_config("phi-3.5-moe")
    cfg = full.with_(num_layers=REPLAY_F32_LAYERS, dtype="float32",
                     moe=dataclasses.replace(full.moe, slot_dtype="int8"))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    log(f"  float32 gate: phi-3.5-moe {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) * 4 / 1e9:.1f} GB made "
        f"in {time.perf_counter() - t0:.1f} s")
    trace = generate_requests(TraceConfig(**REPLAY_F32_TRACE))
    out = {}
    for s in STRATEGIES:
        recs = {}
        for impl in ("cuda", "ref"):
            recs[impl] = replay_run(
                f"phi-3.5-moe f32 {s} {impl}", cfg.with_(impl=impl), params,
                trace, s, "on", REPLAY_F32_MAX_NEW)
        k_run, p_run = recs["cuda"], recs["ref"]
        _replay_launch_gate(f"f32 {s} cuda", k_run, "on", torch.float32)
        if any(p_run["launches"].values()) or not p_run["plain"]:
            raise AssertionError(f"f32 {s} ref: launches "
                                 f"{p_run['launches']}, plain calls "
                                 f"{p_run['plain']}")
        diff = [k for k in k_run["identity"]
                if k_run["identity"][k] != p_run["identity"][k]]
        if diff:
            raise AssertionError(f"float32 gate, {s}: kernels and plain "
                                 f"differ in {diff}")
        log(f"  float32 gate, {s}: kernels == plain in tokens, "
            f"iterations, clock, drops, layer latencies, replica counts, "
            f"cost, host transfers and runtime starts/bytes "
            f"({k_run['identity']['runtime']})")
        out[s] = {"kernels": k_run, "plain": p_run}
    with BlindNewest():
        ctl = replay_run("phi-3.5-moe f32 moeless cuda, control (decode "
                         "attention blind to the newest keys)",
                         cfg.with_(impl="cuda"), params, trace, "moeless",
                         "on", REPLAY_F32_MAX_NEW)
    diff = [k for k in ctl["identity"]
            if ctl["identity"][k] != out["moeless"]["plain"]["identity"][k]]
    if "tokens" not in diff:
        raise AssertionError("float32 gate: the blind-attention control "
                             "passed it")
    log(f"  float32 gate control: differs in {diff}, as it must")
    del params
    return out


def replay_phase(card: str) -> dict:
    """Phase 18: the paper's trace replay at published widths through
    ``serve_trace.replay`` (-> ``ServingEngine.serve`` ->
    ``ControlPlane.step`` -> ``ExpertRuntime.apply`` -> the kernels):
    (a) phi-3.5-moe (8 of 32 layers, bf16, seeded weights) under MoEless
    with the runtime off (the GShard dispatch: ``fused_gate_up``/``gmm``),
    then, on the first 4 of those layers, the trace under each of the
    four strategies with the runtime on and int8 slot banks; (b)
    mixtral-8x7b at phase 4c's depth (4 layers) under the four; (c) the
    float32 gate (``replay_f32_gate``). Slot geometry, depths and time
    scale: the constants above. Each replay's launches are gated
    (``_replay_launch_gate``); bf16 tokens are reported, not gated (a
    near-tie router flips between kernel and plain). Returns the
    records."""
    from repro_torch.configs import get_config
    from repro_torch.core.trace import TraceConfig, generate_requests
    from repro_torch.launch.serve_trace import STRATEGIES
    from repro_torch.models.model import init_params
    out = {}
    phi = get_config("phi-3.5-moe")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(18)
    out["kernels"] = replay_kernel_shapes(gen, phi)
    log(f"  kernels at phi-3.5-moe's shapes took "
        f"{time.perf_counter() - t0:.1f} s")
    trace = generate_requests(TraceConfig(**REPLAY_TRACE))
    log(f"  trace: generate_requests(TraceConfig({REPLAY_TRACE})): "
        f"{len(trace)} requests over {trace[-1].arrival:.2f} s; "
        f"{REPLAY_SLOTS} slots, max_len {REPLAY_MAX_LEN}, max_new "
        f"{REPLAY_MAX_NEW}, time_scale {REPLAY_TIME_SCALE:g}, "
        f"{EP_DEVICES} modeled devices, MoEless with the gate replicas at "
        f"distance 1")
    cfg = phi.with_(num_layers=REPLAY_LAYERS)
    log(f"  (a) phi-3.5-moe: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} kv, head_dim {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff}, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"num_layers {phi.num_layers}->{cfg.num_layers} (runtime off), "
        f"->{REPLAY_RUNTIME_LAYERS} (runtime on, int8 banks)")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params: {sum(t.numel() for t in _leaves(params)) * 2 / 1e9:.1f}"
        f" GB made on the card in {time.perf_counter() - t0:.1f} s")
    runs = {}
    runs["phi-3.5-moe moeless off"] = rec = replay_run(
        "phi-3.5-moe/moeless, runtime off", cfg, params, trace, "moeless",
        "off")
    _replay_launch_gate("phi moeless off", rec, "off", torch.bfloat16)
    rcfg = cfg.with_(num_layers=REPLAY_RUNTIME_LAYERS,
                     moe=dataclasses.replace(cfg.moe, slot_dtype="int8"))
    rparams = first_periods(params, REPLAY_RUNTIME_LAYERS)
    for s in STRATEGIES:
        runs[f"phi-3.5-moe {s} int8"] = rec = replay_run(
            f"phi-3.5-moe/{s}, int8 banks", rcfg, rparams, trace, s, "on")
        _replay_launch_gate(f"phi {s} int8", rec, "on", torch.bfloat16)
    del params, rparams
    mix = get_config("mixtral-8x7b")
    mcfg = mix.with_(num_layers=REPLAY_RUNTIME_LAYERS,
                     moe=dataclasses.replace(mix.moe, slot_dtype="int8"))
    log(f"  (b) mixtral-8x7b: num_layers {mix.num_layers}->"
        f"{mcfg.num_layers}, int8 banks (phase 4c's setup)")
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(mcfg, seed=0, device="cuda")
    for s in STRATEGIES:
        runs[f"mixtral-8x7b {s} int8"] = rec = replay_run(
            f"mixtral-8x7b/{s}, int8 banks", mcfg, params, trace, s, "on")
        _replay_launch_gate(f"mixtral {s} int8", rec, "on", torch.bfloat16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = runs
    out["f32"] = replay_f32_gate()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  on {card}")
    return out


def replay_summary(out: dict) -> dict:
    """Phase 18's numbers, one entry a replay."""
    keys = ("requests", "iterations", "prefills", "occupancy",
            "dropped_tokens", "tokens", "wall_s", "iter_ms",
            "tokens_per_s", "peak_gb", "layer_ms", "cost", "starts",
            "transfers", "bytes_moved", "gb_s", "apply_ms", "apply_calls",
            "slots_held")
    rnd = lambda v: round(v, 4) if isinstance(v, float) else v  # noqa: E731
    runs = {**out["runs"], **{f"phi-3.5-moe f32 {s} {side}": r
                              for s, pair in out["f32"].items()
                              for side, r in pair.items()}}
    return {label: {**{k: rnd(r[k]) for k in keys if k in r},
                    "modeled_ms (v5e cost model)": {
                        m: [round(v, 4) for v in p50_p99]
                        for m, p50_p99 in r["modeled_ms"].items()}}
            for label, r in runs.items()}

# ------------------------------------------------------------ phase 19

# phase 19 (a): quickstart.run at mixtral-8x7b's published widths, at
# the example's own depth (4 layers, bf16: 4 x 2.82 GB of experts +
# 0.34 GB of attention + 0.52 GB of embeddings and head); the float32
# gate at 2 layers (~12.7 GB), kernels (impl "cuda") against the plain
# versions on the card (impl "ref") from the same weights
QS_LAYERS, QS_F32_LAYERS = 4, 2


class CollectLaunches:
    """Within the block, the kernel launches counted when each
    ``predictor.collect_gate_dataset`` call returns: the gate dataset's
    forward, apart from the serving that follows it."""

    def __enter__(self):
        from repro_torch.core import predictor as P
        self.mod, self._fn = P, P.collect_gate_dataset
        self.launches = None
        inner = self._fn

        def collect(*a, **kw):
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            self.launches = K.launch_counts()
            return out

        P.collect_gate_dataset = collect
        return self

    def __exit__(self, *exc):
        self.mod.collect_gate_dataset = self._fn


def quickstart_run(label, cfg, params, requests=None) -> dict:
    """``quickstart.run`` on `cfg` and `params` with its kernel launches
    (the gate dataset's forward apart), their paths, the plain versions'
    calls, the walls and the peak memory. The run's own assertion holds
    the streamed tokens to handle 0's. Returns the record."""
    from repro_torch.launch import quickstart as Q
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    with GmmPaths() as gp, AttnPaths() as ap, PlainCalls() as pc, \
            CollectLaunches() as cl:
        q = Q.run(cfg, params, requests=requests, log=lines.append)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    res = q.result
    out = dict(
        acc_before=q.acc_before.tolist(), acc_after=q.acc_after.tolist(),
        finetuned=q.finetuned_layers, tokens=q.tokens, streamed=q.streamed,
        records=sorted(dataclasses.astuple(r)[:4] for r in res.records),
        n_records=len(res.records), cancelled=res.cancelled,
        iterations=res.iterations, prefills=res.prefills,
        serve_wall_s=res.wall_s, wall_s=wall,
        ctrl_iterations=q.controller.iterations,
        host_transfers=q.controller.host_transfers,
        t_static_ms=q.t_static * 1e3, t_moeless_ms=q.t_moeless * 1e3,
        launches=launches, forward_launches=cl.launches,
        gmm_paths=gp.counts, attn_paths=ap.counts, plain=pc.counts,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, lines=lines)
    log(f"  {label}: " + "; ".join(lines))
    log(f"    {out['n_records']} records, {res.cancelled} cancelled, "
        f"{res.iterations} decode iterations + {res.prefills} prefills, "
        f"serving wall {res.wall_s:.2f} s, whole run {wall:.2f} s, "
        f"controller {q.controller.iterations} iterations / "
        f"{q.controller.host_transfers} host transfers; launches "
        f"{ {k: v for k, v in launches.items() if v} } (gate dataset "
        f"{ {k: v for k, v in (cl.launches or {}).items() if v} }); "
        f"peak {out['peak_gb']:.2f} GB")
    return out


def _quickstart_gates(label, rec, dtype) -> None:
    """7 records and 1 cancelled, every request but the cancelled one
    to its 12 tokens, the streamed tokens handle 0's; through the
    kernels: the gate dataset's forward and the serving launch
    ``fused_gate_up``/``gmm`` (on "wgmma" at bf16) and the serving
    ``decode_attention`` (on "mma" at bf16), and no plain version is
    called."""
    from repro_torch.launch import quickstart as Q
    if rec["n_records"] != 7 or rec["cancelled"] != 1:
        raise AssertionError(f"{label}: {rec['n_records']} records, "
                             f"{rec['cancelled']} cancelled")
    short = [i for i, t in enumerate(rec["tokens"][:-1])
             if len(t) != Q.MAX_NEW]
    if short or rec["streamed"] != rec["tokens"][0]:
        raise AssertionError(f"{label}: requests {short} short of "
                             f"{Q.MAX_NEW} tokens, or the streamed tokens "
                             "differ from handle 0's")
    n, fw = rec["launches"], rec["forward_launches"]
    for k_name in ("fused_gate_up", "gmm"):
        if fw[k_name] <= 0 or n[k_name] <= fw[k_name]:
            raise AssertionError(f"{label}: {k_name} launched {fw[k_name]} "
                                 f"times in the gate dataset's forward, "
                                 f"{n[k_name]} in all")
    if fw["decode_attention"] or n["decode_attention"] <= 0:
        raise AssertionError(f"{label}: decode_attention launched "
                             f"{fw['decode_attention']} times in the "
                             f"forward, {n['decode_attention']} in all")
    for k_name in ("fused_gate_up_quant", "gmm_quant",
                   "decode_attention_paged"):
        if n[k_name]:
            raise AssertionError(f"{label}: {k_name} launched off the path")
    if rec["plain"]:
        raise AssertionError(f"{label}: plain versions called "
                             f"{rec['plain']} with the card present")
    if dtype == torch.bfloat16:
        for k_name in ("fused_gate_up", "gmm"):
            if rec["gmm_paths"][k_name] != {"wgmma": n[k_name]}:
                raise AssertionError(f"{label}: {k_name} by path "
                                     f"{rec['gmm_paths'][k_name]}")
        if rec["attn_paths"] != {"mma": n["decode_attention"]}:
            raise AssertionError(f"{label}: decode_attention by path "
                                 f"{rec['attn_paths']}")


def quickstart_f32_gate() -> dict:
    """The float32 gate: ``quickstart.run`` on mixtral-8x7b at 2 layers
    through the kernels (impl "cuda") and through the plain versions on
    the card (impl "ref") from the same weights: every handle's tokens,
    the streamed tokens, the records (but their wall-clock latencies),
    the cancelled count and the fine-tuned layers equal; the accuracies
    before and after fine-tuning equal or within one top-k overlap
    (1 / (test tokens x top_k)), reported either way. The control, the
    kernels with request 1's sampling seed changed, must differ in
    request 1's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart as Q
    from repro_torch.models.model import init_params
    full = get_config("mixtral-8x7b")
    cfg = full.with_(num_layers=QS_F32_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  float32 gate: mixtral-8x7b {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) * 4 / 1e9:.1f} GB made "
        f"in {time.perf_counter() - t0:.1f} s")
    recs = {impl: quickstart_run(f"f32 impl {impl}", cfg.with_(impl=impl),
                                 params) for impl in ("cuda", "ref")}
    k_run, p_run = recs["cuda"], recs["ref"]
    _quickstart_gates("f32 cuda", k_run, torch.float32)
    if any(p_run["launches"].values()) or not p_run["plain"]:
        raise AssertionError(f"f32 ref: launches {p_run['launches']}, "
                             f"plain calls {p_run['plain']}")
    keys = ("tokens", "streamed", "records", "cancelled", "finetuned")
    diff = [k for k in keys if k_run[k] != p_run[k]]
    if diff:
        raise AssertionError(f"quickstart float32 gate: kernels and plain "
                             f"differ in {diff}")
    # split_dataset's test share of the gate dataset's tokens
    n = Q.GATE_BATCHES * int(np.prod(Q.GATE_SHAPE))
    one = 1.0 / ((n - int(0.7 * n)) * cfg.moe.top_k)
    acc = {k: float(np.max(np.abs(np.subtract(k_run[k], p_run[k]))))
           for k in ("acc_before", "acc_after")}
    if max(acc.values()) > one + 1e-12:
        raise AssertionError(f"quickstart float32 gate: accuracies differ "
                             f"by {acc}, more than one top-k overlap "
                             f"({one:.3e})")
    log(f"  float32 gate: kernels == plain in every handle's tokens, the "
        f"streamed tokens, the records, the cancelled count and the "
        f"fine-tuned layers {k_run['finetuned']}; accuracies differ by "
        f"{acc} (one top-k overlap {one:.3e})")
    reqs = Q.make_requests(cfg.vocab_size)
    reqs[1].sampling = dataclasses.replace(reqs[1].sampling, seed=101)
    ctl = quickstart_run("f32 impl cuda, control (request 1's sampling "
                         "seed 1 -> 101)", cfg.with_(impl="cuda"), params,
                         requests=reqs)
    if ctl["tokens"][1] == k_run["tokens"][1]:
        raise AssertionError("quickstart float32 gate: the changed seed "
                             "left request 1's tokens unchanged")
    same = [i for i in range(len(reqs)) if i != 1
            and ctl["tokens"][i] != k_run["tokens"][i]]
    log(f"  float32 gate control: request 1's tokens differ, as they must "
        f"(other requests differing: {same})")
    del params
    return recs


def train_moe_run(card: str) -> dict:
    """``train_moe.run`` at the example's config, 200 steps on the card
    (checkpoints in a temporary directory): every loss finite, the
    run's own assertion that the loss dropped. Returns the record."""
    from repro_torch.launch import train_moe as TM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        # train's per-step lines go to stderr; the run's lines are kept
        r = TM.run(checkpoint_path=os.path.join(tmp, "moe_ckpt"),
                   device="cuda", log=lines.append)
    wall = time.perf_counter() - t0
    losses = r.result.losses
    if len(losses) != 200 or not np.isfinite(losses).all():
        raise AssertionError(f"train_moe: {len(losses)} losses, finite "
                             f"{bool(np.isfinite(losses).all())}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("  train_moe: " + "; ".join(l.strip() for l in lines))
    log(f"    200 steps in {wall:.1f} s ({r.result.steps_per_s:.2f} steps/s), "
        f"peak {peak:.3f} GB on {card}")
    return dict(n_params=r.n_params, first=r.first, last=r.last,
                cv=r.cv.tolist(), steps_per_s=r.result.steps_per_s,
                wall_s=wall, peak_gb=peak)


def gateway_smoke_run() -> dict:
    """``python -m repro_torch.launch.gateway_smoke --device cuda`` as a
    user starts it (the launcher it boots runs ``--impl auto``: the
    paged decode and the EP slot plane on the kernels): exit code 0.
    The smoke script's own offline engine is run again here, its
    launches counted, and its tokens must be the ones the subprocess
    printed."""
    from repro_torch.launch import gateway_smoke as G
    from repro_torch.models.model import init_params
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gateway_smoke",
         "--device", "cuda"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=G.BOOT_TIMEOUT_S + 120)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        log(f"    | {line}")
    if out.returncode != 0:
        raise AssertionError(f"gateway_smoke exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    cfg = G.smoke_config()
    params = init_params(cfg, G.SEED, device="cuda")
    K.reset_launch_counts()
    with PlainCalls() as pc:
        tokens = G.offline_tokens(cfg, params)
    launches = K.launch_counts()
    printed = out.stdout.splitlines()[0]
    if printed != f"offline greedy tokens: {tokens}":
        raise AssertionError(f"gateway_smoke: the subprocess printed "
                             f"{printed!r}, this process's offline engine "
                             f"gives {tokens}")
    for k_name in ("fused_gate_up", "gmm", "decode_attention"):
        if launches[k_name] <= 0:
            raise AssertionError(f"gateway_smoke offline engine: {k_name} "
                                 "never launched")
    if pc.counts:
        raise AssertionError(f"gateway_smoke offline engine: plain "
                             f"versions called {pc.counts}")
    log(f"  gateway_smoke: exit 0 in {wall:.1f} s (the launcher's boot, "
        f"HTTP and the script's offline engine); the offline engine here "
        f"gives the printed tokens with launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return dict(wall_s=wall, tokens=tokens, launches=launches)


def examples_phase(card: str) -> dict:
    """Phase 19: the JAX package's last entry points in the port, in one
    process: (a) ``launch/quickstart.py``'s ``run`` on mixtral-8x7b at
    published widths and the example's 4 layers, bf16 (gated by
    ``_quickstart_gates``; the tuned layers' mean accuracy must not
    fall), then the float32 gate (``quickstart_f32_gate``); (b)
    ``launch/train_moe.py`` at the example's config, 200 steps
    (``train_moe_run``); (c) ``launch/gateway_smoke.py`` as a subprocess
    (``gateway_smoke_run``). Returns the records."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    out = {}
    t0 = time.perf_counter()
    full = get_config("mixtral-8x7b")
    cfg = full.with_(num_layers=QS_LAYERS)
    log(f"  (a) quickstart: mixtral-8x7b, num_layers {full.num_layers}->"
        f"{cfg.num_layers}, {cfg.dtype}, seeded weights")
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params: {sum(t.numel() for t in _leaves(params)) * 2 / 1e9:.1f}"
        f" GB made on the card in {time.perf_counter() - t0:.1f} s")
    rec = out["quickstart"] = quickstart_run("quickstart bf16", cfg, params)
    _quickstart_gates("quickstart bf16", rec, torch.bfloat16)
    tuned = rec["finetuned"]
    if tuned:
        before = float(np.mean([rec["acc_before"][i] for i in tuned]))
        after = float(np.mean([rec["acc_after"][i] for i in tuned]))
        if after < before:
            raise AssertionError(f"quickstart: the tuned layers' mean "
                                 f"accuracy fell {before:.4f} -> "
                                 f"{after:.4f}")
        log(f"  tuned layers {tuned}: mean accuracy {before:.4f} -> "
            f"{after:.4f}")
    del params
    out["quickstart_f32"] = quickstart_f32_gate()
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    out["train_moe"] = train_moe_run(card)
    log(f"  (b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out["gateway_smoke"] = gateway_smoke_run()
    log(f"  (c) took {time.perf_counter() - t1:.1f} s; on {card}")
    return out


# ------------------------------------------------------------ phase 20

# phase 20: ep_shardmap_serving.run on the example's (2, 2, 2) mesh of 8
# local ranks sharing the card, at mixtral-8x7b's published widths (E 8,
# D 4096, F 14336, top-2, bf16), the example's slots/experts ratio kept
# (8 slots a rank, 16 replicas at most); the example's 4 iterations,
# then 2 more whose plans come from a skewed load vector (phase 11's
# draw): iteration 4 runs a changed plan, iteration 5 the same one
EX_DEGREES = (2, 2, 2)
EX_WIDTHS = dict(num_experts=8, d_model=4096, d_ff=14336, top_k=2,
                 slots_per_device=8, max_total_replicas=16, iters=6,
                 dtype=torch.bfloat16)
EX_SKEW_AT = (3, 4)


def ex_override():
    """Phase 11's seeded load draw standing in for the measured loads of
    iterations 3 and 4 in the re-plans after them."""
    skew = np.random.default_rng(11).integers(1, 100, 8).astype(float)
    return [skew.tolist() if it in EX_SKEW_AT else None
            for it in range(EX_WIDTHS["iters"])]


def ex_reckoning_gb() -> dict:
    """A rank's device bytes: the padded bank (E + 1 experts) and its
    8 slots of its F half (held), and at set-up the whole bank beside
    the padded one, or at a materialisation the padded bank's F half
    sliced for the copy beside it."""
    e, d, f = (EX_WIDTHS[k] for k in ("num_experts", "d_model", "d_ff"))
    expert = 3 * d * f * 2
    tp = EX_DEGREES[2]
    padded = (e + 1) * expert
    slots = EX_WIDTHS["slots_per_device"] * expert / tp
    return {"held": (padded + slots) / 1e9,
            "set_up": max(e * expert + padded,
                          padded + padded / tp + slots) / 1e9}


def _ex_y_error(got, want) -> dict:
    """Phase 20's gate on a layer output against one process's: every
    element within TOL[bf16] x max|want| and the norm of the error
    within DEC_REL of want's (phase 14's bf16 bound). At the example's
    weight scales (0.1 at D 4096, F 14336) |y| reaches ~1600 and a tp
    rank's partial is rounded to bf16 (an ulp of 2-8 there) before the
    float32 sum, so an element's error follows its partials, not its
    own value: TOL elementwise against each element (``check``) would
    fail near zero; its share of elements out is reported."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    top = float(w.abs().max())
    tol = TOL[torch.bfloat16]
    rel = float((g - w).norm() / w.norm())
    return {"max_abs": float(d.max()), "max_abs_y": top,
            "rel_norm": rel,
            "share_out_elementwise": float(
                (d > tol + tol * w.abs()).float().mean()),
            "ok": bool(torch.isfinite(g).all()) and float(d.max())
            <= tol * top and rel <= DEC_REL}


def _ex_records(recs) -> dict:
    """What the gates compare across ranks and against one process."""
    return {k: [getattr(r, k) for r in recs]
            for k in ("loads", "dropped", "rank_loads", "replicas",
                      "slots_updated")}


class SwappedSlots:
    """The control of phase 20's gate: on rank 1, every materialised slot
    bank has its first two slots swapped, so the tokens routed to them
    run the other slot's expert."""

    def __init__(self, rank: int):
        self.rank = rank

    def __enter__(self):
        from repro_torch.distributed import ep as EP
        self.mod, self._fn = EP, EP.materialise_slots
        inner, rank = self._fn, self.rank

        def swapped(*a, **kw):
            out = inner(*a, **kw)
            if rank == 1:
                out = {k: w[[1, 0, *range(2, w.shape[0])]]
                       for k, w in out.items()}
            return out

        EP.materialise_slots = swapped
        return self

    def __exit__(self, *exc):
        self.mod.materialise_slots = self._fn


def ex_rank(rank: int, override) -> dict:
    """One rank of phase 20's world: ``ep_shardmap_serving.run`` on the
    mesh with its launches, their paths and peak memory, then the
    control's first iteration. Everything returned lives on the host."""
    from repro_torch.launch import ep_shardmap_serving as S
    from repro_torch.launch.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    data, ep, tp = EX_DEGREES
    mesh = make_serving_mesh(data=data, ep=ep, tp=tp, device="cuda:0",
                             transport="shared")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with GmmPaths() as gp, PlainCalls() as pc:
        recs = S.run(mesh, **EX_WIDTHS, loads_override=override,
                     log=lambda _: None)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rank": rank, "coords": list(mesh.coords), "recs": recs,
           "launches": K.launch_counts(), "paths": gp.counts,
           "plain": pc.counts, "wall_s": wall,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    gc.collect()
    torch.cuda.empty_cache()
    with SwappedSlots(rank):
        out["control_y"] = S.run(mesh, **{**EX_WIDTHS, "iters": 1},
                                 log=lambda _: None)[0].y
    return out


def ex_kernel_shapes(gen) -> dict:
    """``fused_gate_up`` and ``gmm`` at a rank's geometry: 8 slots, C =
    ceil(2.0 x 2 x 128 / 8) = 64, D 4096, F 7168 (its tp half), rows a
    slot from a seeded routing of a rank's share of the assignments
    (128 tokens x top-2 over data x ep = 4 ranks) clipped at C, against
    their plain versions and timed beside their bounds and library
    calls. Returns {kernel: [record]}."""
    e, k = EX_WIDTHS["num_experts"], EX_WIDTHS["top_k"]
    d, f = EX_WIDTHS["d_model"], EX_WIDTHS["d_ff"] // EX_DEGREES[2]
    slots, t = EX_WIDTHS["slots_per_device"], 4 * 32
    cap = math.ceil(2.0 * k * t / e)
    rng = np.random.default_rng(20)
    share = t * k // (EX_DEGREES[0] * EX_DEGREES[1])
    gs = np.minimum(np.bincount(rng.integers(0, slots, share),
                                minlength=slots), cap).tolist()
    out = {}
    for name, fused, shape in (("fused_gate_up", True, (slots, cap, d, f,
                                                        gs)),
                               ("gmm", False, (slots, cap, f, d, gs))):
        r = gmm_shape_timed(gen, name, fused, "ep rank", shape)
        out[name] = [dict(shape=f"ep_shardmap rank E{slots} C{cap} "
                          f"D{shape[2]} F{shape[3]}", **r)]
    return out


def ep_example_phase(card: str) -> dict:
    """Phase 20: ``launch/ep_shardmap_serving.py``'s ``run`` on the
    example's (2, 2, 2) mesh of 8 ranks on cuda:0 at mixtral-8x7b's
    published widths (``EX_WIDTHS``), after the one-process run
    (``mesh=None``: all 16 slots) on the same inputs in this process,
    freed before the spawn. Gated: every rank's ``y`` equals rank 0's
    at every iteration; rank 0's within TOL[bf16] x max|y| and DEC_REL
    in norm of one process's (``_ex_y_error``); loads,
    drops, rank loads, replicas and slots updated equal to one process's
    exactly; the plan changes at iteration 4 and not at 5; each rank's
    bytes written equal its changed slots (counted from its slots'
    fingerprints) x a slot's bytes, zero at iteration 5, nonzero summed
    over the ranks at iteration 4; the control (rank 1's slot banks with
    two slots swapped, ``SwappedSlots``) must fail that gate and move
    the norm past DEC_CONTROL x DEC_REL; every
    expert launch on "wgmma", no plain version called. Returns the
    records."""
    from repro_torch.launch import ep_shardmap_serving as S
    from repro_torch.launch.mesh import spawn_local
    t20 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = {"kernels": ex_kernel_shapes(gen)}
    override = ex_override()
    log(f"  widths {EX_WIDTHS}; (data, ep, tp) = {EX_DEGREES}; re-plans "
        f"after iterations {list(EX_SKEW_AT)} from loads {override[3]}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with GmmPaths() as gp:
        one = S.run(None, ep=EX_DEGREES[1], **EX_WIDTHS,
                    loads_override=override, device="cuda", log=log)
        torch.cuda.synchronize()
    one_launches = K.launch_counts()
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n = int(np.prod(EX_DEGREES))
    ranks = spawn_local(ex_rank, n, backend="gloo", args=(override,),
                        wall_s=600.0, start_method=START_METHOD)
    t2 = time.perf_counter()
    log(f"  one process {t1 - t0:.1f} s (peak {one_peak:.2f} GB, launches "
        f"{ {k: v for k, v in one_launches.items() if v} }, paths "
        f"{gp.counts}); {n} ranks {ON_CARD} {t2 - t1:.1f} s")
    want = _ex_records(one)
    fails = []
    r0 = ranks[0]["recs"]
    for r in ranks:
        for it, (a, b) in enumerate(zip(r["recs"], r0)):
            if not torch.equal(a.y, b.y):
                fails.append(f"rank {r['rank']}'s y differs from rank 0's "
                             f"at iteration {it}")
        got = _ex_records(r["recs"])
        for k in got:
            if got[k] != want[k]:
                fails.append(f"rank {r['rank']}: {k} {got[k]} != one "
                             f"process's {want[k]}")
        for k_name in ("fused_gate_up", "gmm"):
            n_k = r["launches"][k_name]
            if n_k <= 0 or r["paths"][k_name] != {"wgmma": n_k}:
                fails.append(f"rank {r['rank']}: {k_name} launched {n_k}, "
                             f"by path {r['paths'][k_name]}")
        if r["plain"]:
            fails.append(f"rank {r['rank']}: plain versions called "
                         f"{r['plain']}")
    errs = []
    for it, (a, b) in enumerate(zip(r0, one)):
        e = _ex_y_error(a.y, b.y)
        errs.append(e)
        if not e["ok"]:
            fails.append(f"iteration {it}: {e} beyond TOL[bf16] x max|y| "
                         f"or DEC_REL in norm")
    changed = want["slots_updated"]
    if changed[0] != "all" or not changed[4] or changed[5] != 0:
        fails.append(f"slots updated {changed}: the skewed plan must change "
                     "at iteration 4 and stay at 5")
    written = []
    for r in ranks:
        recs = r["recs"]
        slot_bytes = recs[0].bytes_written // EX_WIDTHS["slots_per_device"]
        row = [recs[0].bytes_written]
        for prev, cur in zip(recs, recs[1:]):
            moved = sum(any(prev.slot_sums[k][s] != cur.slot_sums[k][s]
                            for k in cur.slot_sums)
                        for s in range(EX_WIDTHS["slots_per_device"]))
            if cur.bytes_written != moved * slot_bytes:
                fails.append(f"rank {r['rank']}: wrote {cur.bytes_written} "
                             f"bytes, {moved} slots changed")
            row.append(cur.bytes_written)
        written.append(row)
    if sum(w[4] for w in written) <= 0 or any(w[5] for w in written):
        fails.append(f"bytes written by rank and iteration {written}")
    ctl = _ex_y_error(ranks[0]["control_y"], one[0].y)
    if ctl["ok"] or ctl["rel_norm"] <= DEC_CONTROL * DEC_REL:
        fails.append(f"the swapped-slot control passed the gate ({ctl})")
    log(f"  8 ranks vs one process by iteration: {errs}; slots updated "
        f"{changed}")
    log(f"  control (rank 1's first two slots swapped): {ctl}")
    log(f"  bytes written a rank by iteration: {written}")
    reckon = ex_reckoning_gb()
    for r in ranks:
        log(f"  rank {r['rank']} {r['coords']}: launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }; run "
            f"{r['wall_s']:.2f} s; peak {r['peak_gb']:.2f} GB (reckoned "
            f"{reckon['held']:.2f} held, {reckon['set_up']:.2f} at set-up)")
    if fails:
        raise AssertionError("phase 20: " + "; ".join(fails))
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s; on {card}")
    out.update(one_launches=one_launches, one_peak_gb=one_peak,
               rank_launches=[r["launches"] for r in ranks],
               rank_peaks=[r["peak_gb"] for r in ranks], errs=errs,
               written=written, slots_updated=changed,
               seconds=time.perf_counter() - t20)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    # float32 products in full float32 (TF32 off), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the server the multi-rank phases fork from imports their modules
    # now, beside phases 3-10, and never touches the card
    import multiprocessing.forkserver
    torch.multiprocessing.get_context(START_METHOD).set_forkserver_preload(
        FORKSERVER_PRELOAD)
    multiprocessing.forkserver.ensure_running()
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import MoElessController, ServingEngine

    t_main = time.perf_counter()
    log("[1] card")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); TF32 matmul/cudnn: off")

    log("[2] build")
    fresh = [n for n in KB.SOURCES if not KB.library_path(n).is_file()]
    t0 = time.perf_counter()
    KB.build()
    log(f"  built {', '.join(fresh) or 'nothing'} from kernels/csrc "
        f"(one nvcc each, in parallel) in {time.perf_counter() - t0:.1f} s; "
        f"libraries in {KB.BUILD_DIR.relative_to(ROOT)}")

    log("[3] kernels against their plain versions")
    t3 = time.perf_counter()
    full = get_config("mixtral-8x7b")
    slots, max_len = 8, 512 + 48 + 1
    shapes = main_path_shapes(full, slots, 512, max_len)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = check_gmm_kernels(gen, shapes)
    rec.update(check_decode_attention(gen, shapes["decode_attention"]))
    rec.update(check_decode_attention_paged(
        gen, shapes["decode_attention_paged"]))
    rec.update(check_quant_kernels(gen, shapes))
    log("  phase 8's new geometries (llama4, grok-1, jamba, stablelm, "
        "command-r+, qwen2-vl)")
    for k_name, rows in check_family_shapes(gen, slots,
                                            FAMILY_MAX_LEN).items():
        rec[k_name]["family_shapes"] = rows
    log("  phase 10's new geometry (whisper-base's decode attention)")
    w = get_config("whisper-base")
    label = f"whisper H{w.num_heads} KV{w.num_kv_heads} " \
        f"hd{w.resolved_head_dim}"
    s_w = max(WHISPER_LENS) + WHISPER_STEPS + 1
    rec["decode_attention"]["whisper_shape"] = dict(
        shape=f"{label} B{WHISPER_BATCH} S{s_w}", **decode_attention_timed(
            gen, (WHISPER_BATCH, w.num_heads, w.num_kv_heads,
                  w.resolved_head_dim, s_w,
                  [s_w - WHISPER_STEPS // 2] * WHISPER_BATCH), label,
            "mma"))
    log(f"  phase 3 took {time.perf_counter() - t3:.1f} s")

    log("[4] mixtral-8x7b at full width through ServingEngine")
    t4 = time.perf_counter()
    cfg = full.with_(num_layers=8)
    log(f"  reduced: num_layers {full.num_layers}->{cfg.num_layers}")
    log(f"  widths: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} kv, head_dim {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts x d_ff {cfg.moe.d_ff}, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"  params: {n_par / 1e9:.2f} B, {n_par * 2 / 1e9:.1f} GB, made on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    ctrl = MoElessController(cfg, num_devices=8)
    engine = ServingEngine(cfg, params, max_len=max_len, controller=ctrl)
    reqs = make_requests(cfg, (128, 256, 384, 512), (16, 32, 48), 12)
    torch.cuda.reset_peak_memory_stats()
    res, launches, pre_s, dec_s, dec_tok, wall = serve_timed(
        engine, reqs, slots)
    peak = torch.cuda.max_memory_allocated()
    check_budgets(reqs, "request")
    log(f"  served {len(reqs)} requests, {res.generated_tokens} tokens in "
        f"{res.iterations} decode steps + {res.prefills} prefills "
        f"(mean occupancy {res.mean_batch_occupancy:.2f})")
    log(f"  launches in this run: {launches}")
    for k_name in ("fused_gate_up", "gmm", "decode_attention"):
        if launches[k_name] <= 0:
            raise AssertionError(f"{k_name} was never launched on the main "
                                 "path")
    n_moe = cfg.num_layers // cfg.moe.every_n_layers
    if len(ctrl.plans) != n_moe or len(ctrl.last_plans) != n_moe:
        raise AssertionError(f"controller planned {len(ctrl.plans)} of "
                             f"{n_moe} MoE layers")
    log(f"  controller: {ctrl.iterations} iterations, a plan for each of "
        f"{n_moe} MoE layers (replicas/layer "
        f"{[p.total_replicas for p in ctrl.plans]})")
    logits_check(cfg, params, [r.prompt for r in reqs], max_len, slots)
    med_dec = float(np.median(dec_s)) * 1e3
    log(f"  wall times on {card}:")
    for bucket in sorted(pre_s):
        log(f"    prefill bucket {bucket}: median "
            f"{np.median(pre_s[bucket]) * 1e3:.2f} ms over "
            f"{len(pre_s[bucket])}")
    log(f"    decode step: median {med_dec:.2f} ms over {len(dec_s)} "
        f"steps; {dec_tok / sum(dec_s):.1f} decode tokens/s")
    log(f"    whole run: {wall:.2f} s, {res.generated_tokens / wall:.1f} "
        f"tokens/s; max_memory_allocated {peak / 1e9:.2f} GB")
    del engine, ctrl
    torch.cuda.empty_cache()
    log(f"  phase 4 took {time.perf_counter() - t4:.1f} s")

    log("[4b] paged KV, chunked prefill and the prefix cache at full width "
        "(same weights)")
    t4 = time.perf_counter()
    paged = paged_phase(cfg, params, max_len, slots, card)
    log(f"  phase 4b took {time.perf_counter() - t4:.1f} s")

    log("[6] the OpenAI-compatible gateway at full width (phase 4's "
        "weights; run before 4c, whose slot banks cannot sit beside them)")
    t6 = time.perf_counter()
    gateway_phase(cfg, params, card)
    log(f"  phase 6 took {time.perf_counter() - t6:.1f} s")

    log("[7] the expert load predictor at full width (phase 4's weights)")
    t7 = time.perf_counter()
    pred = predictor_phase(cfg, params, max_len, slots, card)
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")
    del params
    # the phase's replicas, drivers and timing wrappers reference one
    # another (and the weights): collect the cycles before 4c allocates
    gc.collect()
    torch.cuda.empty_cache()

    log("[4c] the expert runtime on the EP slot plane at full width, int8 "
        "slot banks")
    t4 = time.perf_counter()
    ep_launches = runtime_phase(full, max_len, slots, card)
    log(f"  phase 4c took {time.perf_counter() - t4:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    log("[8] the model families at their published widths")
    t8 = time.perf_counter()
    families = {}
    for arch in FAMILY_LAYERS:
        phase = recurrent_phase if arch in RECURRENT else family_phase
        families[arch] = phase(arch, card)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")
    log("  phase 8 summary: " + json.dumps({
        arch: {"layers": r["layers"], "weights_gb": round(r["weights_gb"], 2),
               "attention_path": r.get("attention_path"),
               "decode_ms": round(r["contiguous"]["decode_ms"], 3),
               "prefill_ms": {bk: round(v, 3) for bk, v in
                              r["contiguous"]["prefill_ms"].items()},
               "peak_gb": round(r["contiguous"]["peak_gb"], 2),
               **({"paged_decode_ms": round(r["paged"]["decode_ms"], 3),
                   "paged_mixed_ms": round(r["paged"]["mixed_ms"], 3)}
                  if "paged" in r else {})}
        for arch, r in families.items()}))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log("[9] training at full width: mixtral-8x7b (1 of 32 layers) and "
        "xlstm-125m through train_loop.train, impl ref")
    t9 = time.perf_counter()
    training_phase(card)
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    log("[10] whisper-base at its published widths through the fixed-batch "
        "API (encoder-decoder)")
    t10 = time.perf_counter()
    whisper = whisper_phase(card)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
    keys = ("encoder_wall_ms", "encoder_device_ms", "prefill_wall_ms",
            "prefill_device_ms", "decode_wall_ms", "decode_device_ms",
            "decode_launches", "decode_idle_share",
            "cross_attention_device_ms", "cross_attention_share",
            "kv_products_device_ms", "kv_products_share")
    log("  phase 10 summary: " + json.dumps({
        **{f"bf16 {plen}": {k: round(whisper[plen][k], 4) for k in keys}
           for plen in WHISPER_LENS},
        **{f"float32 {plen}": {
            "prefill_vs_forward": whisper["float32"][plen]["forward_errs"][0],
            "decode_vs_forward": max(
                whisper["float32"][plen]["forward_errs"][1:]),
            "zeroed_enc_out_moves":
                whisper["float32"][plen]["zeroed_enc_out_moves"]}
           for plen in WHISPER_LENS},
        "peak_gb": round(whisper["peak_gb"], 3)}))

    log("[5] token identity at float32 (smoke config): kernels vs plain")
    t5 = time.perf_counter()
    small = get_config("mixtral-8x7b", smoke=True).with_(dtype="float32")
    sp = init_params(small, seed=0, device="cuda")
    capacity_identity(small, sp)
    log("  drop-free capacity factor: contiguous and paged layouts")
    free = small.with_(moe=dataclasses.replace(
        small.moe, capacity_factor=float(small.moe.num_experts)))
    token_identity(free, sp)
    sampled_batching(free, sp)
    log("  expert runtime on (EP slot plane): float32 and int8 slot banks")
    runtime_identity(small, sp)
    log("  the load predictor on the session controller (distance 1)")
    predictor_identity(small, sp)
    del sp
    log("  the model families' smoke configs (llama4 also at its "
        "dense/MoE interleave; jamba and xlstm on the contiguous cache)")
    for arch in FAMILY_LAYERS:
        family_identity(arch)
    family_identity("llama4-maverick-400b-a17b", every_n_layers=2)
    log("  the encoder-decoder and gelu experts (gmm up, gelu, gmm down): "
        "whisper-base's smoke config through the fixed-batch API, "
        "mixtral-8x7b's at act gelu")
    encdec_identity()
    family_identity("mixtral-8x7b", act="gelu")
    log(f"  phase 5 took {time.perf_counter() - t5:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    log("[18] the paper's trace replay (launch/serve_trace.py) at published "
        "widths: phi-3.5-moe and mixtral-8x7b under megatron-lm, eplb, "
        "oracle and moeless")
    t18 = time.perf_counter()
    replays = replay_phase(card)
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s")
    log("  phase 18 summary: " + json.dumps(replay_summary(replays)))

    gc.collect()
    torch.cuda.empty_cache()
    log("[19] the JAX package's last entry points in the port: quickstart "
        "(mixtral-8x7b at published widths, 4 layers), train_moe, "
        "gateway_smoke")
    t19 = time.perf_counter()
    examples = examples_phase(card)
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")
    qs, tm = examples["quickstart"], examples["train_moe"]
    log("  phase 19 summary: " + json.dumps({
        "quickstart": {k: qs[k] for k in (
            "acc_before", "acc_after", "finetuned", "iterations",
            "prefills", "serve_wall_s", "wall_s", "t_static_ms",
            "t_moeless_ms", "peak_gb")},
        "train_moe": {k: tm[k] for k in (
            "first", "last", "cv", "steps_per_s", "wall_s", "peak_gb")},
        "gateway_smoke_wall_s": examples["gateway_smoke"]["wall_s"]}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[11] multi-rank EP on the card: local ranks on cuda:0, "
        "mixtral-8x7b at its published widths through "
        "ServingEngine(mesh=...)")
    worlds = ep_phase(card)

    gc.collect()
    torch.cuda.empty_cache()
    log("[20] the EP data plane example (launch/ep_shardmap_serving.py) on "
        "a (2, 2, 2) mesh of 8 local ranks, mixtral-8x7b's expert widths")
    ep_example = ep_example_phase(card)

    gc.collect()
    torch.cuda.empty_cache()
    log("[12] the dry-run and sharding: the meta-device sweep, ZeRO-2 "
        "training of mixtral-8x7b on two ranks, the Mamba levers")
    z2 = sharding_phase(card)["zero2"]

    gc.collect()
    torch.cuda.empty_cache()
    log("[13] tensor parallelism (model > 1): mixtral-8x7b trained on (1, 2) "
        "and (2, 2) process meshes, the (1, 2) prefill through the kernels "
        "on F-shards")
    tp = tp_phase(card)

    gc.collect()
    torch.cuda.empty_cache()
    log("[14] the sharded decode step: mixtral-8x7b decoding on (1, 2) and "
        "(2, 2) process meshes with the KV cache sharded, decode attention "
        "on each rank's sequence shard merged by its softmax statistics; "
        "its ranks then run phase 16: jamba-v0.1-52b, xlstm-125m and "
        "whisper-base decoding with their recurrent state and "
        "encoder-decoder caches sharded; and phase 17: mixtral-8x7b on "
        "the ep_experts layout, each model rank running its whole experts")
    z22 = tp["(2, 2)"]
    zero2_22 = {"losses": z22["losses"][0],
                "params": z22.pop("params_final"),
                "acc": z22.pop("acc_final"),
                "resident": sum(z22["resident"][0].values()),
                "peak_gb": z22["peaks"][0]}
    dec = dec_phase(card, zero2_22)

    gc.collect()
    torch.cuda.empty_cache()
    log("[15] the ZeRO-3 layout: mixtral-8x7b on (2, 1) and (2, 2) process "
        "meshes with every leaf split over data as well, gathered at use a "
        "period at a time: the prefill and decode steps against fsdp=False, "
        "training against ZeRO-2")
    zero3 = zero3_phase(card, {
        (2, 1): {"losses": [s["loss"] for s in z2["ranks"][0]["steps"]],
                 "params": z2.pop("params_final"),
                 "resident": sum(z2["ranks"][0]["resident"].values()),
                 "peak_gb": z2["ranks"][0]["peak_gb"]},
        (2, 2): zero2_22})
    del zero2_22
    log("  phase 17 summary: " + json.dumps(ep_summary(tp, dec["ep"],
                                                     zero3)))

    # each kernel's launches come from the run of the path it serves
    launches["decode_attention_paged"] = \
        paged["launches"]["decode_attention_paged"]
    for k_name in ("fused_gate_up_quant", "gmm_quant"):
        launches[k_name] = ep_launches[k_name]
    # phase 7: the bf16 kernels at forward's shape, and their launches
    for k_name, r in pred["kernels"].items():
        rec[k_name].update({f"forward_{k}": v for k, v in r.items()},
                           forward_launches=pred["launches"][k_name])
    # phase 8: each family's launches of the four kernels it serves
    for k_name in ("fused_gate_up", "gmm", "decode_attention",
                   "decode_attention_paged"):
        rec[k_name]["family_launches"] = {
            arch: sum(r[kv]["launches"][k_name]
                      for kv in ("contiguous", "paged") if kv in r)
            for arch, r in families.items()}
    # phase 10: whisper-base's decode attention, both bf16 batches
    rec["decode_attention"]["family_launches"]["whisper-base"] = sum(
        whisper[plen]["launches"]["decode_attention"]
        for plen in WHISPER_LENS)
    # phase 11: each rank's launches of each kernel, by world
    for k_name in SOURCES:
        rec[k_name]["ep_world_launches"] = {
            wn: [r[k_name] for r in wr["launches"]]
            for wn, wr in worlds.items()}
    # phase 13: the bf16 prefill's launches on each (1, 2) rank, and the
    # kernels at its F-shard and one-process shapes
    for k_name in ("fused_gate_up", "gmm"):
        rec[k_name]["tp_shapes"] = tp["kernels"][k_name]
        rec[k_name]["tp_prefill_launches"] = [
            r[k_name] for r in tp["prefill"]["bfloat16"]["launches"]]
    # phase 14: decode attention with statistics at the (1, 2) sequence
    # shard, the expert kernels at the decode F-shard shapes, and the
    # bf16 (1, 2) decode steps' launches on each rank
    rec["decode_attention"]["tp_decode_shape"] = dec["kernel"]
    for k_name in ("fused_gate_up", "gmm"):
        rec[k_name]["tp_decode_shapes"] = dec["expert_shapes"][k_name]
    for k_name in ("decode_attention", "fused_gate_up", "gmm"):
        rec[k_name]["tp_decode_launches"] = [
            r[k_name] for r in dec["(1, 2)"]["bfloat16 default"]["launches"]]
    # phase 16: decode attention with statistics at jamba's and whisper's
    # shards, the expert kernels at jamba's F-shard, and each run's
    # launches on each rank
    st = dec["state"]
    rec["decode_attention"]["state_decode_shapes"] = \
        st["kernels"]["decode_attention"]
    for k_name in ("fused_gate_up", "gmm"):
        rec[k_name]["state_decode_shapes"] = st["kernels"][k_name]
    for k_name in ("decode_attention", "fused_gate_up", "gmm"):
        rec[k_name]["state_decode_launches"] = {
            f"{shape} {run}": [r[k_name] for r in got["launches"]]
            for shape in map(str, ST_RUNS) for run, got in st[shape].items()}
    # phase 17: the expert kernels at E/2 experts with F whole, and each
    # rank's launches in its prefill and decode
    for k_name in ("fused_gate_up", "gmm"):
        rec[k_name]["ep_shapes"] = dec["ep"]["kernels"][k_name]
    for k_name in ("decode_attention", "fused_gate_up", "gmm"):
        rec[k_name]["ep_launches"] = {
            shape: [(p["launches"].get(k_name, 0), d["launches"][k_name])
                    for p, d in zip(dec["ep"][shape]["prefill"],
                                    dec["ep"][shape]["decode"])]
            for shape in ("(1, 2)", "(2, 2)")}
    # phase 15: each rank's launches in its ZeRO-3 prefill and decode runs
    for k_name in ("decode_attention", "fused_gate_up", "gmm"):
        rec[k_name]["zero3_launches"] = {
            shape: [r[k_name] for r in z["serve"]["launches"]]
            for shape, z in zero3.items() if shape != "seconds"}
    # phase 18: the expert kernels at phi-3.5-moe's shapes, and each
    # replay's launches
    for k_name, rows in replays["kernels"].items():
        rec[k_name]["replay_shapes"] = rows
    for k_name in SOURCES:
        rec[k_name]["replay_launches"] = {
            label: r["launches"][k_name]
            for label, r in replays["runs"].items()}
    # phases 19 and 20: each example run's launches, and the expert
    # kernels at a phase-20 rank's geometry
    example_runs = {
        "quickstart bf16": examples["quickstart"]["launches"],
        **{f"quickstart f32 {impl}": r["launches"]
           for impl, r in examples["quickstart_f32"].items()},
        "gateway_smoke offline": examples["gateway_smoke"]["launches"],
        "ep_shardmap one process": ep_example["one_launches"],
        **{f"ep_shardmap rank {i}": n
           for i, n in enumerate(ep_example["rank_launches"])}}
    for k_name in SOURCES:
        rec[k_name]["example_launches"] = {
            label: n[k_name] for label, n in example_runs.items()}
    for k_name, rows in ep_example["kernels"].items():
        rec[k_name]["ep_shardmap_shapes"] = rows
    log(f"phases 1-20 took {time.perf_counter() - t_main:.1f} s")
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": launches[n], **rec[n]}
        for n in SOURCES]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
