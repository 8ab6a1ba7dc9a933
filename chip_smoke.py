#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line on stdout:

1. device: the card's name and power limit (nvidia-smi), TF32 switched off.
2. build: every kernel under ray_tpu_torch/ops/csrc built with nvcc for
   sm_90a; each kernel's registers, spills and static shared memory from
   the ptxas report (the whole report goes to stderr). A spill fails.
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, o and lse, at the engine's prefill shapes, at
   f32 / non-causal / D=64 / GQA / ragged shapes and at the heads of one
   tensor-parallel position (Hq 16 / Hkv 4 and 8 / 2 at S=2048); kernel,
   plain and
   scaled_dot_product_attention times (the last only as a yardstick, its
   device time under torch.profiler, and which SDPA backend ran).
4. kernel_bwd: the dQ and dK/dV kernels against their plain versions, dq,
   dk and dv, and the delta = rowsum(dO * O) that the dQ kernel computes
   against the plain row-sum, at the training shapes, at the heads of one
   tensor-parallel position (Hq 16 / Hkv 4 and 8 / 2 at S=2048, the
   train_mesh phase's) and at the same f32 /
   non-causal / D=64 / GQA / ragged shapes; the autograd Function's grads
   against autograd through plain attention; kernel (CUDA events, and the
   kernel's device time alone under torch.profiler), plain delta, plain
   and SDPA-backward times (SDPA's as for the forward). At the main training
   shape one profiled backward must run exactly the dQ and the dK/dV
   kernel on the card, nothing else.
   Then (tiling) bf16 cases that cross the kernels' tiles (S 1, 127, 129,
   255; D 64, 128; GQA groups 1, 2, 4, 8 and 16; causal or not), delta
   included, one whose q, k and v are strided views of a fused
   (B, S, Hq + 2 Hkv, D) tensor, and two dQ and two dK/dV launches on the
   same inputs, which must agree bit for bit (no atomics; the GQA group is
   summed in a fixed order).
   Then (paged_decode) the paged-decode kernel against its plain twin at
   the benchmark's decode shapes (Hq 32 / KV 8, D 128, pages of 64: chat's
   32 slots of up to 2,048 keys, all live and 4 live; docqa's 16 slots of
   2,048-3,327 keys, and its tp positions' heads Hq 16 / KV 4 and 8 / 2)
   and at f32, D=64, G 1 / 12 / 32 and pages of 8, 24 and 128: o within
   the kernel's rounding of the exact f32 function and no farther from
   the twin than the twin is from that function plus that rounding,
   inactive rows zero; kernel and twin ms (CUDA events, and the kernel's
   device time alone under torch.profiler) beside the bytes bound (each
   live key and value row, the active slots' q and every o row once, over
   3.35 TB/s).
5. serve: Llama-3-8B-GQA at full width and depth with random weights,
   four greedy requests through LLMEngine; checks tokens, the kernel's
   launch count and each prompt's prefill logits against forward() with
   plain attention.
6. serve_cache: the same params (not a second copy) behind two engines
   with the prefix cache, A unchunked and B with 512-token chunked
   prefill. Four requests sharing a 1024-token prefix on A (one miss,
   three hits over 48 pages); a 1900-token prompt chunked on B, one chunk
   per step while a decoding request emits a token every step; P/D from A
   (prefill_only) to B (decode_from), a second prompt hitting on both
   sides; a prompt run alone on A as a miss, a resident hit, and after
   every cache entry is demoted to host memory, a promoted hit whose
   tokens equal the resident hit's; a request cancelled mid-decode and
   one mid-chunked-prefill, after which every page is back. Checks the
   forward kernel's launches (32 per full prefill or first chunk, none
   for suffix prefills and later chunks) and each hit's and the chunked
   prompt's logits against an uncached prefill; prints TTFT of a miss, a
   hit and a promotion, suffix against full prefill time and chunk-step
   times.
7. serve_paged: the same params behind engines whose max_len (512) is far
   below the context: a 3000-token greedy prompt is prefilled by
   prefill_paged into six 512-token KV parts (pipelined publish to pinned
   host memory) on one engine and decoded for 16 tokens by decode_paged
   on another, which gathers the parts through its window of 8 from the
   host. Checks the prefill's logits against an uncached forward() with
   the flash kernel and each decode step's against one teacher-forced
   forward() over the prompt and the emitted tokens; the window's
   counters (6 fetches, no refetch, the six parts' bytes once, nothing
   resident after); no forward-kernel launch on the paged path (its
   attention is plain, as in the JAX package); the flight-recorder spans
   of the request (6 prefill-chunk and 15 decode sp:gather, 16
   sample_sync, no batched decode). Then, on a third engine with a window
   of 1, a 256-token context in two parts whose fetch fails after two
   steps: the paged request retires with a typed KVGatherError caused by
   the ConnectionError while a pool request beside it finishes, and every
   page and window slot is free. Prints the prefill ms, the paged decode
   step ms, one profiled paged decode step and the window's counters.
8. serve_replica: the same params behind EngineReplica (max_batch=4,
   max_len=2048, page_size=64, prefix cache), its decode loop on an
   asyncio event loop in a thread of its own and engine.step on that
   loop's executor threads. Four greedy prompts (37, 300, 1000, 1900
   tokens) one at a time through generate, whose tokens must equal a
   closed-loop LLMEngine's of the same shape (on a mismatch the step and
   the top-2 logit margin are printed); eight staggered stream_generate
   calls, two of them prefix hits and one abandoned after 3 tokens
   (max_active >= 2, cancelled 1, one request:admit span per request,
   every page free or only cached; each request's TTFT and inter-token
   gaps, the lock waits); a replica with max_queue=2 shedding 4 of 6
   concurrent requests typed, and a request queued behind a full pool with
   a 0.2 s deadline expiring typed; P/D from replica P to D
   (prefill_handoff -> decode_handoff) of the 1000-token prompt with
   generate's tokens; a
   1536-token context through P.prefill_paged_handoff (three 512-token
   parts) and D.decode_paged, whose 8 tokens must equal the engine-level
   prefill_paged/decode_paged's; a fetch failing mid-decode on a window-1
   replica giving StreamBrokenError with a KVGatherError cause; the
   open-loop harness over the replica (8 requests of 300 tokens at 2/s).
   Kernel 1's launches per section: 32 per full prefill, none for hits or
   paged steps. Prints the engine step, fan-out wait and open-loop TTFT
   and inter-token percentiles on the host clock.
9. serve_sp: the same params behind LLMEngine(max_batch=2, max_len=2048,
   page_size=64, prefix_cache=True) on sp meshes that name the card n
   times, for (n, strategy) in (2, ring), (4, ring) and (4, ulysses): the
   shards take turns on the one card, so the phase reads the mechanism,
   not a speedup (where torch.cuda.device_count() >= n the same runs go
   on distinct devices too, and the phase prints which ran). A 1900-token
   and a 37-token greedy prompt in one admission wave, then a prompt
   sharing the first one's 16 leading pages, whose suffix prefill runs
   sequence-parallel. Checks each SP prefill's last-token logits against
   forward() with plain attention (the serve phase's gate, noise printed),
   the first token equal to their argmax (or, where the reference's top-2
   margin is below its own noise floor, scored by it within that floor of
   its top; the margins printed), 16 tokens in [0, vocab), the
   sp_stripes covering exactly each request's new pages, the hit's
   counters, 0 kernel 1 launches (the SP prefill's attention is plain, as
   in the JAX package), and every weight tensor of the engine's replica on
   the card at the params' own data_ptr (no copy on a repeated device).
   Prints SP prefill ms (host clock, synchronised) beside the sp=1
   prefill of the same prompt, one profiled SP prefill and peak memory.
10. serve_tp: kernel 1 against its plain version at one tp position's
   heads (the kernel phase's comparison at Hq 16 / Hkv 4 and 8 / 2); then
   the same params behind LLMEngine(max_batch=4, max_len=2048,
   page_size=64, prefix_cache=True) on tp meshes that name the card n
   times, n in (2, 4) (on distinct devices too where
   torch.cuda.device_count() >= n; the phase prints which ran): each
   position holds its slice of the heads, kv heads and MLP hidden units
   and its kv heads' pool, and all-reduces twice a layer; the positions
   take turns on the one card, so the phase reads the mechanism's cost.
   The serve phase's four prompts in one wave (each last-token prefill
   logits against forward() with plain attention on the unsharded params,
   the serve gate, and the first token tie-aware as in serve_sp; 16
   tokens in [0, vocab)); a hit on the 1900-token prompt's 16 leading
   pages with a 300-token suffix (counters; logits against an uncached
   prefill), the same prompt again as a resident hit, every cache entry
   demoted and the prompt promoted with the resident hit's tokens
   exactly (8 tokens each); P/D from the tp engine into an unsharded
   engine of the serve shape and back, on the wave's 1000-token prompt
   (the tp export joins resident pages after a suffix prefill) and on a
   fresh 1000-token prompt (it joins a full prefill's kv), 16 tokens each
   way, the tp blob within 5e-2 of the unsharded one's; kernel 1
   launches, 32 x n per full prefill and none for suffixes, installs or
   decode steps; each position's weights on the card, their bytes plus
   the replicated tensors' equal to the params' (no second copy) and the
   pools' to the unsharded pool's. Then one EngineReplica on a tp=2 mesh, whose
   generate tokens must equal the tp=2 engine's closed loop. Prints the
   1900-token prefill and the 4-slot decode step ms beside the unsharded
   ones, one profiled prefill and decode step per n (device time by
   class, the all-reduce's apart, and the idle share) and peak memory.
11. serve_mesh: the same params behind LLMEngine (TP_ENGINE's shape) on
   the serving meshes beside sp alone and tp alone, each naming the card
   n times (on distinct devices too where torch.cuda.device_count() >= n;
   the phase prints which ran): sp=2 x tp=2 with ring and with Ulysses
   (each tp position's ring or all-to-all over its two sp positions at
   Hq 16 / Hkv 4), pp=2 and pp=2 x tp=2 (each stage its 16 layers and a
   pool of them, the hidden state handed on by .to()), dp=2 and fsdp=2
   (weights and pool once per distinct device, every step on each), then
   replicas of split layouts, dp=2 x tp=2, fsdp=2 x tp=2 and dp=2 x pp=2,
   whose second replica names the card "cuda" where the first names it
   "cuda:0" (two names of one card: two replicas, each its own slices),
   and pp=2 x sp=2 (each stage's SP prefill over its 16 layers, the
   shards' hidden states handed on by .to()). The
   serve phase's four prompts in one wave: each last-token prefill
   logits against forward() with plain attention (the serve gate, the
   first token tie-aware as in serve_sp) and 16 greedy tokens equal to an
   unsharded engine's, or parting only at a tie: where the two tokens'
   logits differ, as the unsharded engine scores them, by no more than
   the two engines' logits differ at that step; kernel 1 launches per
   full prefill, 0 under sp, 32 x tp per replica otherwise (128 on dp=2
   x tp=2 and fsdp=2 x tp=2, 64 on dp=2 x pp=2), none elsewhere; each
   replica's weights (slices plus the replicated tensors) the params'
   bytes, the replicated ones at the params' data_ptr on their card, and
   its pools the unsharded pool's (the sp positions holding nothing of
   their own on one card). On every layout but dp=2 and fsdp=2 alone a
   hit on the 1900-token prompt's 16 leading pages and P/D of a fresh
   1000-token prompt both ways with the unsharded engine (the blob within
   5e-2); under dp and fsdp each replica's prefill logits bit for bit
   equal to the first's. Then an
   EngineReplica on pp=2 whose tokens equal the pp=2 engine's closed
   loop. Fails if a run leaves another card current. Prints each run's
   1900-token prefill (host ms and one profiled prefill) and decode step
   ms beside the unsharded prefill, and peak memory.
12. device_plane: the same params through the port's device plane
   (_private/device_plane.py, serialization.py, experimental/). Rung 0:
   the whole param tree (16.06 GB of bf16) through a local-token DAG body,
   back at the same data_ptr with no byte staged. Rung 1: the 1900-token
   prompt's P/D blob from prefill_only (32 kernel 1 launches; 249,036,800
   bytes of k and v) serialized, written into one host buffer and
   deserialized onto the card, three rounds (the first cold): bit-equal,
   device->host and host->device each exactly the blob's bytes (all of them
   fallback bytes: a CUDA tensor has no host-addressable buffer), no part
   copied, GB/s each way. P/D: a second engine's decode_from of the rebuilt
   blob gives the tokens of the in-process handoff and of the first
   engine's own generation (32 more launches). prefill_paged(host_staged=
   True) against the device-resident prefill on the serve_paged engine's
   shape: the same first token, the same parts bit for bit, device->host
   exactly the parts' bytes. A spawned process rebuilds the serialized
   blob on its card (cuda:1 where there are several) and returns its
   hashes and its own audit. Device objects: device_put of k and v stacked
   on an owner store, device_get from a second store whose fetch calls the
   owner's serve_fetch (four 64 MiB chunks), bit-equal, then device_free
   and a get that raises KeyError. Prints every time (host clock,
   synchronised) and every audit delta.
12b. serve_rules: the same params behind LLMEngine(SERVE_ENGINE's shape,
   prefix_cache=True) under the reference's default table,
   LogicalAxisRules.default(), on tp=2 and on fsdp=2 x tp=2 naming the
   card 2 and 4 times: each position stores the table's slices (its
   vocabulary slice of embed and lm_head; on fsdp=2 its embed-dim slices,
   gathered a layer at a time at use), the embedding and the logits
   vocabulary-parallel. Checks each position's slice shapes, the distinct
   tensors on the card holding exactly the params' bytes (a whole tensor
   the params' own); the four prompts' first-token logits against
   forward() with plain attention (serve_tp's gate) and their greedy
   tokens against the unsharded engine's (equal, or parting at a tie);
   32 x tp kernel 1 launches per full prefill; the longest prompt again,
   a resident prefix hit with no launch. Prints the wave's decode step ms,
   a 1900-token prefill's ms and the peak memory.
12c. perf: the same params through the port's engine and device-plane
   rows (ray_tpu_torch/util/perf.py run_microbenchmarks, min_time_s 1, one
   call per report): one EngineReplica (max_len 64, 16 tokens, pages of 8)
   and a P/D replica pair (the blob through the serializer and a host
   buffer) each under the reference's open loop (a warm-up, then 3-token
   prompts at 4 Hz for 4 s); SP prefill tokens/s of 512 tokens at degree 1
   (kernel 1) and 4 (the sp mesh naming the card four times) and the paged
   path's TTFT of 384 tokens in 64-token parts, device-resident and
   host-staged; the device channel's steps/s (a 4 MiB tensor by rung-0
   token, the same-size numpy array through a host buffer) and the 64 MiB
   KV blob's GiB/s through the serializer; the prefix-cache hit rate under
   pool squeezes with demotion on and off. Checks: hits and misses exactly
   9/2 and 4/7 (the reference script's); every open-loop request served in
   full (none shed, failed, broken or short); kernel 1's launches, 32 per
   full prefill, the serving replica's 17 and the P/D prefill replica's
   17 and none on the decode replica, 32 per degree-1 SP prefill and none
   on the degree-4 SP prefill or prefill_paged; one first token for every
   timed paged serve, staged and direct; after the run the payloads on the
   card (the device tensor back at its data_ptr, the host array and the
   64 MiB blob bit-equal, 64 MiB each way in the copy audit) and an empty
   rung-0 registry; the phase under 90 s. Prints the 13 rows and each
   report's counts.
12d. serve_apps: the same params behind the serving apps
   (ray_tpu_torch/llm/openai_api.py, serve_patterns.py), each replica
   hosted on an event loop of its own thread (serve_patterns.Hosted).
   OpenAIServer (APPS_SERVER, prefix cache on, a tokenizer whose text is
   the token ids) on every route: /v1/models; a 300-token completion; a
   list of three prompts in one request (max_active 3); a chat; an SSE
   completion and an SSE chat (the role frame, one frame per token, the
   final chunk, [DONE]); a chat stream whose client leaves after 2 frames
   (cancelled 1, every page free or only cached); the reference's
   400/404/405 errors with its messages. CompiledPDApp with one prefill
   and one decode replica: two 1000-token prompts through generate and
   stream, the blob through the lane's edge once each way in the copy
   audit. LongContextApp with 2 shards and 1 decode replica whose pool
   (1024 tokens) holds less than the 3000-token context: six 512-token
   stripes round-robined 3/3, each a HostRef into its shard's buffers,
   decoded for 8 tokens through a window of 8 (6 fetches, no refetch).
   Checks every token against a closed-loop engine on the same params
   (the server's and the P/D app's against LLMEngine.generate of the same
   shape, each request alone or, for the list, in one wave; the
   long-context app's against one engine's prefill_paged/decode_paged),
   pools free at the end, every shard's buffers freed once the request is
   done and its handoff dropped (before shutdown), kernel 1's launches
   (32 per full prefill: 8 on the server, 2 on the P/D prefill replica,
   none on decode replicas or the paged path), every stream finished or cancelled where it is left,
   the phase under 90 s. With several cards the decode side sits on
   cuda:1 (its params copied there once). Prints each request's host ms,
   the SSE first-frame ms, the P/D generate ms and stream TTFT, the
   long-context prefill and decode ms and the gather counters.
13. train: the same model at full width and depth, random weights, four
   steps of make_train_step on one fixed 2048-token batch with per-layer
   checkpointing; checks finite metrics, a falling loss, each kernel's
   launches per step, step 1's loss and grad norm against a pass with
   plain attention on the same params, and each attention weight's
   gradient (wq, wk, wv, wo of every layer) from a flash pass against the
   plain pass's, beside a control: the plain pass again on the same model
   with its MLP hidden units relabelled, which changes only the rounding.
14. train_mesh: the same model at full width and depth trained on
   build_mesh(MeshSpec(dp=2, fsdp=2, tp=2), devices=[cuda:0] * 8), the
   reference's own test mesh: four batch groups of one 2048-token sequence
   (one fixed batch of 4 from np.random.default_rng(5)), each tp position
   at Hq 16 / Hkv 4, its weights gathered across fsdp a layer at a time;
   the positions take turns on the one card, so the phase reads the
   mechanism's cost. First an unsharded value_and_grad on the same params
   and batch (no optimizer state: params, grads and the (4, 2048, 128256)
   logits fit where two states would not) keeps its loss, grad norm and a
   sample of gradients (embed, lm_head, wq/wk/wv/wo/w_down of layers 0 and
   31); then the params are sharded, the sharded value_and_grad's
   sampled gradients are gathered one at a time and held against those
   (5e-2 relative), and the Adam moments are made. Checks: the sharded
   state's distinct tensors hold exactly the unsharded params', mu's and
   nu's bytes; each position's shard shapes are those its specs give; the
   planner's per-position params and optimizer bytes equal each
   position's own; step 1's loss and grad norm against the unsharded
   pass (the train phase's limits); four finite steps with a falling loss;
   512 / 256 / 256 launches of kernels 1 / 2 / 3 a step; the thread's
   current CUDA device unchanged. Prints step ms, tokens/s and MFU beside
   the train phase's, one profiled step (device time by class, with the tp
   all-reduce, the fsdp gather and the vocabulary-parallel cross-entropy
   as named ranges, and the idle share), the peak memory beside the
   planner's figure. Where torch.cuda.device_count() >= 2 the same mesh
   also runs over the visible cards (the grid in order, each card named
   8/n times), and the phase prints which ran.
14b. train_rules: train_mesh's mesh, batch and seeded params under other
   rule tables (default().with_overrides(("mlp", "fsdp")): the MLP's
   weights over fsdp on their embed dim, whole over tp; ("embed", "tp"):
   the embed dim over tp, the heads whole), then ("batch", "dp") (batch
   groups over dp alone, two rows each) where its planner figure beside
   the first table's measured peak leaves 5% of the card free. Each
   stores the params as it says and trains in the model's layout (heads,
   kv heads and MLP units over tp), the stored slices gathered and sliced
   at use. train_mesh's checks for each: the slices against the unsharded
   params, the sampled gradients and step 1's loss and grad norm against
   train_mesh's unsharded pass, the held state's bytes against the
   planner's under the table, 32 x groups x tp launches of kernel 1 (x2:
   the recompute) and of kernels 2 and 3 a step; three steps, the first
   table's last step profiled (with train_mesh's named ranges, the
   fsdp:gather range reading every build of a layer's weights from the
   stored slices).
15. train_pp: the same model at full width and depth trained on
   build_mesh(MeshSpec(pp=2, dp=2, tp=2), devices=[cuda:0] * 8), the
   reference's own pp training mesh, with two microbatches per batch
   group: train_mesh's batch and seeded params (drawn again after
   train_mesh's state is freed), held against train_mesh's unsharded
   pass (loss, grad norm, the sampled gradients of layers 0 and 31, which
   lie on different stages). Each stage's positions hold its 16 layers
   (each distinct shard bit-equal to its slice of the unsharded params),
   the embedding runs on stage 0 and the head on stage 1, the hand-off is
   a .to() between the stages' devices. The same checks as train_mesh;
   512 / 256 / 256 launches of kernels 1 / 2 / 3 a step (32 layers x 2
   microbatches x 2 batch groups x 2 tp positions, kernel 1 twice).
   Prints the same numbers, the stage hand-off's device time as the named
   range pp:send, and the train and train_mesh phases' step ms beside
   its own. Where torch.cuda.device_count() >= 2 the same mesh also runs
   over the visible cards, the stage boundary between cards.
16. train_sp: the same model trained on build_mesh(MeshSpec(dp=2, sp=2,
   tp=2), devices=[cuda:0] * 8) with attention_impl="ring": each batch
   group's sequence split over its two sp positions, each (group, tp
   position) running the ring over them at Hq 16 / Hkv 4; train_mesh's
   batch and seeded params, held against train_mesh's unsharded pass as
   train_pp is (its samples in pinned host memory). The same checks as
   train_mesh for three steps, with no kernel launched by the ring's
   steps; then one value_and_grad with attention_impl="flash" on the same
   mesh (each tp position's sequence gathered on its first sp position
   around kernel 1): 256 / 128 / 128 launches of kernels 1 / 2 / 3, its
   loss and sampled gradients against the unsharded pass. Prints the
   same numbers as train_mesh and the peak beside the planner's figure.
   Where torch.cuda.device_count() >= 2 the same mesh also runs over the
   visible cards.
17. collective: one spawned process per card (the "spawn" start method;
   torch.cuda.device_count() ranks: one on a machine with one card,
   four with four), each joining an NCCL world through the Train
   backend (train.backend.TorchConfig("nccl"): pinned to cuda:rank with
   every card visible, tcp://localhost rendezvous) and running every op
   of an NCCL TorchCollectiveGroup on CUDA tensors against numpy: the
   four allreduce ops, allgather, broadcast, barrier, reducescatter at an
   even and an uneven length, reduce, and send/recv where world >= 2
   (the line says where it was not run); where world >= 2 also the bus
   bandwidth of a 256 MiB bf16 all-reduce (algbw x 2(n - 1)/n). Each
   rank checks that it imported neither JAX nor the JAX package.
18. train_ranks: the same model at full width and depth, train_mesh's
   batch and default rules, trained with one process per card over each
   layout of TRAIN_RANKS in turn: MeshSpec(dp=2, fsdp=2) (the fsdp
   gathers an NCCL all-gather between cards, the dp replicas an NCCL
   all-reduce), then tp, sp or pp groups split over ranks. On one card a
   world of one holds each layout's positions on cuda:0: dp=2 x fsdp=2,
   then tp=4 (kernels 1-3 at Hq 8 / Hkv 2). On four cards, one position a
   rank: dp=2 x fsdp=2, tp=4 (the in-layer all-reduce over NCCL), pp=2 x
   tp=2 with two microbatches (the stage hand-off by send/recv) and sp=2
   x tp=2 (the sequence gathered on the first shard's rank around the
   kernels), then sp=2 x tp=2's step 1 again under ring attention (the
   P2P ring, no kernel). Per layout: each rank draws the seed-0 params on
   its card (their layers.attn.wk's hash against the unsharded pass's),
   value_and_grad's 12 sampled gradients gathered across ranks against
   train_mesh's unsharded pass (kept in a file the ranks read), three
   steps (step 1's loss and grad norm against it, falling losses), each
   rank's launches of kernels 1-3 (2 x its stage's layers x microbatches
   x its attending positions, and that count twice: 256 / 128 / 128 in
   the world of one, 64 / 32 / 32 a rank on four, 0 on sp's second
   shard), distinct state bytes against the planner's per-rank figure,
   replicas (dp's and sp's copies, tp's norm scales, the stages'
   top-level tensors) bit-equal across ranks, the current device kept.
   Prints per rank its step ms, tokens/s, MFU, one profiled step's device
   time by class with the fsdp:gather, tp:all_reduce, pp:send/recv and
   sp:ring/gather/scatter ranges apart, its idle share (the union of its
   kernels' intervals) and its peak memory. Then, on four cards, the
   free-standing layers across the ranks (FREE_LAYOUTS), each held on
   rank 0 against the same function in one process on a mesh naming its
   card once per position: ring and Ulysses attention at sp=4 (B 1, S
   8192, Hq 32 / Hkv 8, D 128, bf16, causal; each rank's sequence shard
   and its share of the gradients of sum(out * w)), pipeline_spmd at pp=4
   (each stage 8 of 8b-gqa's seed-0 layers at full width, plain
   attention, each layer checkpointed; 4 microbatches of one 2048-token
   sequence; the output on the last stage's rank, the stages' first and
   last layers' gradients, the layers' gradient norm and x's gradient)
   and the MoE layer at Mixtral-8x7B's widths on fsdp=2 x sp=2 and
   fsdp=2 x tp=2 (each rank its shards and its run of the tokens; the
   routing equal, y and every gathered gradient against the unsharded
   layer as in the moe phase); no kernel launched; per rank the host ms
   of the first forward and backward (NCCL's first-use set-up of the
   exchanges included) and a second, profiled, with the sp:ring,
   sp:all_to_all, pp:send/recv and ep:all_to_all ranges apart; a third
   MoE run on fsdp=2 x tp=2 with the experts whole (``("expert", None)``:
   each rank all eight experts over a quarter of the MLP units, built
   from the stored slices through the exchange, ep:all_gather). Last, the
   RULES_RANKS runs: train_mesh's model under rule tables other than
   the default, across ranks, each as a layout above (the same gates,
   launches counted into the kernels line as train_rules_ranks). On one
   card a world of one runs the batch over dp alone on dp=2 x fsdp=2; on
   four, one position a rank, the MLP units over fsdp and the batch over
   dp alone on dp=2 x fsdp=2 (two ranks compute, the fsdp > 0 ranks only
   hold slices that the others read: 0 launches there) and the heads over
   tp x fsdp with the embed dim whole on fsdp=2 x tp=2. A block another
   rank holds comes through one NCCL all-gather of the ranks' slices per
   leaf and use (reshard:all_gather), its gradient back by a
   reduce-scatter (reshard:reduce_scatter), each a named range. Before
   each run the planner's per-rank figure (the state four times, one
   group's activations, logits and workspace) must leave
   TRAIN_RULES_HEADROOM of the card free; a run that does not fit is
   printed as not run, with the figure. A rank that raises, hangs past
   its bound or exits non-zero fails the run; nothing falls back to gloo
   or the CPU.
19. moe: one MoE layer at Mixtral-8x7B's published widths (d_model 4096,
   d_ff 14336, 8 experts, top 2; capacity_factor 1.25, MoEConfig's
   default), bf16 on x of (4, 2048, 4096) from a seed, f32 params as
   JAX's init makes them (5.64 GB of experts): the forward and the
   backward of y.float().sum() plus the aux losses, unsharded and then
   ep-sharded over build_mesh(MeshSpec(fsdp=2, sp=2, tp=2), devices=
   [cuda:0] * 8), the reference's EP test mesh. Checks the routing
   (expert_idx, keep) and the fraction dropped equal between the two, y
   and every parameter's gradient within a bf16 limit of the unsharded
   layer's beside a control (the unsharded layer with its MLP units
   relabelled), each position's shard shapes, the shards on the card
   holding exactly the params' bytes. Then ep-sharded once more under
   default().with_overrides(("embed", "tp")) (w_gate and w_up stored over
   experts and the embed dim, w_down over experts and MLP units, each
   computing position gathering its experts' weights at use): the routing
   equal, y and the gradients within the same limits. Prints forward and
   backward ms (host and device) of both and the peak memory.
20. rllib: the port's rllib (ray_tpu_torch/rllib) on the card, at the JAX
   package's defaults (hiddens (64, 64)) on the port's own CartPole-v1
   (4 observations, 2 actions). Each learner (PPO, IMPALA, APPO, DQN,
   SAC, each with its config's lr and grad_clip) built on the card and on
   the CPU from one state runs one update on one seeded batch (PPO two
   runners' 64 x 8 rollouts, 24 Adam steps; IMPALA and APPO their 64 x
   16 aggregate; DQN and SAC a replay batch of 64): params and targets
   within 1e-4 of the CPU's (max |diff| / max |ref|), metrics too, and the
   update's ms on the card (CUDA events, warm). Then PPO through
   LocalRuntime with the learner and both runners on the card, the JAX
   package's learning gate (2 runners x 8 envs x 64 steps, lr 3e-4,
   entropy 0.01, seed 0): a mean episode return of 120 within 35
   iterations; per iteration the wall, sample and learn seconds, env
   steps/s, and one profiled iteration (device time by class, idle
   share). IMPALA, APPO, DQN and SAC (learning_starts one iteration's
   steps) take 3 iterations each: at least one update, finite losses.
   Every learner's and runner's params on the card; no kernel of
   ops/csrc launched (none lies on this path); the phase under 90 s.
21. rllib_offline: rllib's offline and multi-agent half on the card, at
   the same widths. BC, MARWIL (beta 2.0), CQL and IQL (their configs'
   lr, grad_clip 0.5 or 40) built on the card and on the CPU from one
   state run one update on one seeded corpus (BC and MARWIL one
   update_offline over 2048 rows, 8 Adam steps; CQL and IQL run_updates
   of 8 over 4096 transitions): params and targets within 1e-4 of the
   CPU's, metrics too, and the update's ms on the card (CUDA events,
   warm). Then the JAX tests' learning gates on corpora recorded with
   their recorders on the port's CartPole, learners and evaluation on the
   card: BC (15 iterations, lr 2e-3, 4 epochs, minibatch 256) at a greedy
   return of 100 over 5 episodes, MARWIL (25 scripted + 25 random
   episodes, beta 2.0) at 80, CQL (8 x 100 updates, lr 1e-3) and IQL
   (seed 7, expectile 0.8) at the behaviour's mean + 20; wall seconds per
   iteration, the greedy returns, and one more BC iteration profiled
   (device time by class, idle share). Then a two-CartPole
   MultiAgentEnv: MultiAgentEnvRunner.sample on the card against itself
   on the CPU under decisive weights and a 9-step time limit (obs,
   actions, rewards, dones, returns equal; logp, vf, trunc_bonus and
   bootstrap_value within 1e-4), and PPO with independent p0/p1 and with
   one shared policy, 3 iterations each: both policies move, losses
   finite, every learner's and runner's params on the card, a save/restore
   round trip bit-equal. No kernel of ops/csrc launched; the phase under
   120 s.

Phases 5 to 12 and serve_rules, perf and serve_apps run with the engine's
decode steps counted (the decode_launches line): on each phase's own path
the paged-decode kernel launches once per layer a position holds per
decode step (a replica's step counted apart), and any other count fails.

Then the kernels line, the card line and, last, the ok line. Any failure
exits non-zero without the ok line, as does a machine without CUDA.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import math
import multiprocessing
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch import collective, experimental, serve
from ray_tpu_torch._private import (deadlines, device_plane,
                                    flight_recorder, serialization)
from ray_tpu_torch.exceptions import (DeadlineExceededError, KVGatherError,
                                      OverloadedError, StreamBrokenError)
from ray_tpu_torch.llm import (EngineReplica, LLMEngine, SamplingParams,
                               run_open_loop)
from ray_tpu_torch.llm import (CompiledPDApp, LongContextApp,
                               OpenAIServer)
from ray_tpu_torch.llm import engine as llm_engine
from ray_tpu_torch.llm.serve_patterns import HostRef, Hosted
from ray_tpu_torch.llm import sequence_parallel as llm_sp
from ray_tpu_torch.models import (PRESETS, MoEConfig, forward,
                                  init_moe_params, init_params,
                                  make_optimizer, make_train_step,
                                  moe_logical_axes)
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models import moe as moe_ops
from ray_tpu_torch.models.moe import moe_layer_routed
from ray_tpu_torch.models.train_step import global_norm, value_and_grad
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import ring_attention as ring_ops
from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, build_mesh,
                                    plan_train_memory, shard_params,
                                    tree_specs)
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel import sharding as sharding_ops
from ray_tpu_torch.parallel.mesh import AXES, Mesh
from ray_tpu_torch.parallel.sharding import (all_gather_parts, gather_tensor,
                                             shard_slices)
from ray_tpu_torch.rllib import (APPOConfig, AppoLearner, BCConfig,
                                 BCLearner, CQLConfig, DQNConfig,
                                 DQNLearner, IMPALAConfig, IQLConfig,
                                 ImpalaLearner, Learner, MARWILConfig,
                                 MultiAgentEnv, MultiAgentEnvRunner,
                                 PPOConfig, SACConfig, SACLearner, envs,
                                 episodes_to_batch)
from ray_tpu_torch.rllib.cql import CQLLearner
from ray_tpu_torch.rllib.iql import IQLLearner
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec
from ray_tpu_torch.train.backend import TorchConfig, _TorchBackend
from ray_tpu_torch.util import perf
from ray_tpu_torch.ops import paged_attention
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, reference_paged_decode_attention)
from ray_tpu_torch.ops.flash_attention import (
    attention_bwd_delta, flash_attention, flash_attention_bwd,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    reference_attention, reference_attention_bwd, reference_attention_dkv,
    reference_attention_dq, reference_attention_lse)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on the
# CUDA cores (the f32 kernel does not use tensor cores), HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_S = 3.35e12

# bf16: the kernel feeds unnormalised probabilities rounded to bf16 into
# P.V where the plain version rounds the normalised ones, and o itself is
# bf16 (8 mantissa bits). f32: only the order of the sums differs.
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3},
       torch.float32: {"o": 1e-4, "lse": 1e-4}}
# Prefill last-token logits of the 8B model, flash kernel vs plain
# attention, max |diff| / max |ref|. Both run in bf16 through 32 layers of
# random weights, where one-ulp differences per layer grow to about 2% of
# the largest logit: the plain path differs from itself by that much when
# only the prompt's padding changes (printed as noise_rel_err beside it).
LOGITS_REL_TOL = 5e-2

ENGINE_HEADS = dict(B=1, Hq=32, Hkv=8, D=128, dtype=torch.bfloat16,
                    causal=True)
# serve_tp: each of n tp positions runs kernel 1 over its own 32/n query
# and 8/n kv heads.
TP_DEGREES = (2, 4)
TP_KERNEL_CASES = [dict(ENGINE_HEADS, S=2048, Hq=32 // n, Hkv=8 // n)
                   for n in TP_DEGREES]
KERNEL_CASES = (
    [dict(ENGINE_HEADS, S=s) for s in (8, 64, 512, 1024, 2048)]
    + [dict(B=1, S=256, Hq=8, Hkv=8 // g, D=64, dtype=torch.float32,
            causal=False) for g in (1, 2, 4)]
    + [dict(B=2, S=200, Hq=8, Hkv=2, D=128, dtype=torch.bfloat16,
            causal=True),
       dict(B=2, S=200, Hq=8, Hkv=4, D=64, dtype=torch.bfloat16,
            causal=False),
       dict(B=2, S=200, Hq=8, Hkv=2, D=128, dtype=torch.float32,
            causal=True)]
    + TP_KERNEL_CASES)
# bf16 cases across the kernels' tiles (128 rows; dQ's 64-key kv tiles and
# 64-row warpgroups): every (S, D, G, causal) below with Hkv = 2, and
# G = 16 on one kv head.
TILING_CASES = ([dict(B=1, S=s, Hq=2 * g, Hkv=2, D=d, causal=c)
                 for s in (1, 127, 129, 255) for d in (64, 128)
                 for g in (1, 2, 4, 8) for c in (True, False)]
                + [dict(B=1, S=255, Hq=16, Hkv=1, D=d, causal=c)
                   for d in (64, 128) for c in (True, False)])
FUSED_CASE = dict(B=2, S=300, Hq=8, Hkv=2, D=128, causal=True)
# paged_decode: the benchmark's decode shapes (portbench/workloads): the
# models' heads, pages of 64, chat's 32 slots (prompt + output at most
# 2,047 keys; all live, then 4 live as the cell mostly runs) and docqa's 16
# of 2,048-3,327 keys with the tp positions' heads; then the kernel's other
# widths. lo / hi bound the live lengths, `live` the active slots.
PD_BF16 = dict(KV=8, D=128, page=64, dtype=torch.bfloat16)
PAGED_DECODE_CASES = (
    dict(PD_BF16, name="chat", B=32, Hq=32, P=32, lo=32, hi=2047, live=32),
    dict(PD_BF16, name="chat_4_live", B=32, Hq=32, P=32, lo=128, hi=1024,
         live=4),
    dict(PD_BF16, name="docqa", B=16, Hq=32, P=64, lo=2048, hi=3327,
         live=16),
    dict(PD_BF16, name="docqa_tp2", B=16, Hq=16, KV=4, P=64, lo=2048,
         hi=3327, live=16),
    dict(PD_BF16, name="docqa_tp4", B=16, Hq=8, KV=2, P=64, lo=2048,
         hi=3327, live=16),
    dict(PD_BF16, name="G1_D64_page8", B=4, Hq=8, D=64, page=8, P=64,
         lo=0, hi=511, live=3),
    dict(PD_BF16, name="G12_page24", B=3, Hq=24, KV=2, page=24, P=22,
         lo=0, hi=527, live=3),
    dict(PD_BF16, name="G32_page128", B=2, Hq=32, KV=1, D=64, page=128,
         P=8, lo=100, hi=1023, live=2),
    dict(PD_BF16, name="f32", B=4, Hq=32, P=16, lo=0, hi=1023, live=3,
         dtype=torch.float32),
)
PROMPT_LENS = (37, 300, 1000, 1900)
MAX_TOKENS = 16
SERVE_ENGINE = dict(max_batch=4, max_len=2048, page_size=64)
# serve_cache: one shared prefix of 16 pages and four suffixes (the first
# request misses, the other three hit the 16 pages); the chunked prompt
# takes 4 chunks of at most 512 tokens; the demoted prompt has 5 full
# pages, so demoting every entry of its (1 + ... + 5) copies 15 pages of
# 8 MiB, inside the 256 MiB host window.
SHARED_PREFIX = 1024
HIT_SUFFIXES = (37, 300, 700, 900)
PREFILL_CHUNK = 512
CHUNKED_LEN = 1900
PD_LEN = 1500
DEMOTED_LEN = 330
# serve_paged: a context longer than the engines' max_len (and than the
# serve engines' 2048), in 512-token parts of 64 MiB each (32 layers x 512
# x 8 x 128 bf16, k and v): five full and one of 440 tokens.
PAGED_LEN = 3000
PAGED_SPAN = 512
PAGED_ENGINE = dict(max_len=512, page_size=64)
PAGED_WINDOW = 8
# The gather failure: a 256-token context in two 128-token parts (16 MiB
# each) beside a 37-token pool request, the fetch failing after two steps.
FAIL_LEN, FAIL_SPAN, FAIL_POOL_LEN, FAIL_AFTER_STEPS = 256, 128, 37, 2
# serve_replica: the serve phase's engine shape behind EngineReplica, with
# the prefix cache. Parity prompts come from np.random.default_rng(3).
REPLICA = dict(max_batch=4, max_len=2048, page_size=64, prefix_cache=True,
               max_tokens=MAX_TOKENS)
# Eight staggered streams: two share 600 tokens (9 pages) with the 1000-
# token parity prompt and hit; the fourth is abandoned after 3 tokens.
STREAM_LENS = (64, 128, 200, 250, 333, 420)
STREAM_HIT_PREFIX, STREAM_HIT_SUFFIX = 600, 50
STREAM_GAP_S, ABANDON_AT, ABANDON_AFTER = 0.15, 3, 3
# Shedding: max_queue=2 against 6 concurrent 100-token requests (4 shed).
# The deadline: a 1000-token request decoding 32 tokens (~70 ms each on
# the H100, PERF.md, so ~10x the deadline) holds all 17 pages of its
# replica's pool, ceil((1000 + 32 + 1) / 64), while a request with a
# deadline 0.2 s out waits behind it.
SHED_N, SHED_LEN = 6, 100
DEADLINE_LONG_LEN, DEADLINE_LONG_TOKENS, DEADLINE_S = 1000, 32, 0.2
# P/D and paged through replicas: P/D on the 1000-token parity prompt,
# whose generate tokens are known; a 1536-token context in three 512-token
# parts decoded for 8 tokens; the gather failure on a 256-token context in
# two parts through a window of 1, the fetch failing from its (2 parts x
# layers x 2 tokens + 1)-th call, in the third decode step.
RPAGED_LEN, RPAGED_SPAN, RPAGED_TOKENS = 1536, 512, 8
# The open loop: 8 requests of 300 tokens offered at 2 requests/s.
OPEN_LOOP_RATE, OPEN_LOOP_S, OPEN_LOOP_LEN = 2.0, 4.0, 300
# serve_sp: the sp layouts, one engine each; a 1900-token prompt (bucket
# 2048: 1024, 512 tokens a shard) and a 37-token one (bucket 64: its
# padding crosses shard boundaries), then a hit on the first one's 16
# leading pages with a 300-token suffix (bucket 512). Prompts come from
# np.random.default_rng(4).
SP_ENGINE = dict(max_batch=2, max_len=2048, page_size=64, prefix_cache=True)
SP_RUNS = ((2, "ring"), (4, "ring"), (4, "ulysses"))
SP_PROMPT_LENS = (1900, 37)
SP_HIT_PREFIX, SP_HIT_SUFFIX = 1024, 300
# serve_tp: the serve phase's engine shape with the prefix cache, on tp
# meshes (TP_DEGREES); the serve phase's four prompts in one wave, a hit on
# the 1900-token prompt's 16 leading pages with a 300-token suffix (from
# np.random.default_rng(5), as are the two fresh prompts of the replica's
# parity and P/D's fresh prompt), P/D on the wave's 1000-token prompt (a
# cache hit on the tp engine) and on a fresh one of 1000 tokens (a full
# prefill). Demoting every cache entry copies
# ~640 pages of 8 MiB (each entry holds its whole prefix): a 8 GiB host
# window keeps them in memory, where the default 256 MiB would spill GBs
# to files.
TP_ENGINE = dict(SERVE_ENGINE, prefix_cache=True)
TP_HIT_PREFIX, TP_HIT_SUFFIX = 1024, 300
# Tokens of the hit, the resident hit and the promoted hit: a decode step
# of one slot takes 100-300 ms at tp=4 (host-bound), and these runs check
# the first token's logits and promoted == resident, not decode length.
TP_HIT_TOKENS = 8
TP_PD_LEN = 1000
TP_REPLICA_LENS = (37, 300)
TP_DEMOTE_BYTES = 8 << 30

# serve_mesh: the serving meshes beside sp alone and tp alone, on the
# serve phase's params and TP_ENGINE's shape: sp=2 x tp=2 with ring and
# with Ulysses (Hkv 8 / tp 2 = 4 kv heads a position, split over sp 2),
# pp=2 and pp=2 x tp=2, dp=2 and fsdp=2. The serve phase's four prompts in
# one wave; on the sp x tp and pp engines also a hit on the 1900-token
# prompt's 16 leading pages with a 300-token suffix (TP_HIT_*) and P/D of
# a fresh 1000-token prompt both ways with the unsharded engine (prompts
# from np.random.default_rng(6)); on pp=2 an EngineReplica held to the pp
# engine's closed loop on two fresh prompts.
#
# Then replicas of split layouts, dp=2 x tp=2, fsdp=2 x tp=2 and dp=2 x
# pp=2, whose second replica's positions name the card "cuda" where the
# first's name it "cuda:0" (two names of one card, so the engine holds two
# replicas, each its own slices), and pp=2 x sp=2 (each stage's SP prefill
# over its 16 layers).
MESH_RUNS = (("sp2tp2-ring", dict(sp=2, tp=2), "ring"),
             ("sp2tp2-ulysses", dict(sp=2, tp=2), "ulysses"),
             ("pp2", dict(pp=2), "ring"),
             ("pp2tp2", dict(pp=2, tp=2), "ring"),
             ("dp2", dict(dp=2), "ring"), ("fsdp2", dict(fsdp=2), "ring"),
             ("dp2tp2", dict(dp=2, tp=2), "ring"),
             ("fsdp2tp2", dict(fsdp=2, tp=2), "ring"),
             ("dp2pp2", dict(dp=2, pp=2), "ring"),
             ("pp2sp2", dict(pp=2, sp=2), "ring"))
MESH_REPLICA_LENS = (37, 300)

# Backward, per gradient. bf16, max |diff| / max |ref|: the kernels round P
# and dS to bf16 as the operands of their products and emit bf16, where
# the plain version stays in f32 until its one final cast. f32, max |diff|:
# only the order of the sums differs.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# delta = rowsum(dO * O) from the dQ kernel against the plain row-sum,
# max |diff| / max |ref|: both sum f32 products of the same inputs (exact
# for bf16 inputs), only in another order.
DELTA_REL_TOL = 1e-4
TRAIN_HEADS = dict(B=1, Hq=32, Hkv=8, D=128, dtype=torch.bfloat16,
                   causal=True)
# train_mesh: each of the tp=2 positions runs the backward over its
# Hq 16 / Hkv 4 heads; Hq 8 / Hkv 2 is a tp=4 position's.
TP_BWD_CASES = [dict(TRAIN_HEADS, S=2048, Hq=32 // n, Hkv=8 // n)
                for n in TP_DEGREES]
BWD_CASES = ([dict(TRAIN_HEADS, S=s) for s in (64, 512, 1024, 2048)]
             + TP_BWD_CASES
             + [c for c in KERNEL_CASES if c["dtype"] == torch.float32
                or c["S"] == 200])

TRAIN_SEQ = 2048
TRAIN_STEPS = 4
# Step 1's loss and grad norm (flash kernels, the optimizer's first step)
# against a loss+grad pass with plain attention on the same params and
# batch, relative. Both run bf16 through 32 layers of random weights; the
# loss is a mean over 2048 tokens, so per-logit drift of ~2% (see
# LOGITS_REL_TOL) averages down to well under 1%. The grad norm sums the
# squares of 8e9 bf16 gradients whose per-element drift does not average
# out the same way, hence the wider limit.
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GNORM_REL_TOL = 5e-2
# Each attention weight's gradient, flash pass against plain pass, as
# ||g_flash - g_plain|| / ||g_plain|| per layer and weight; the worst of
# the 128 is held here. A fault confined to attention's backward (a wrong
# or zero dq, dk or dv, or wrong wiring of the autograd Function or the
# checkpointed recompute) moves these leaves by the whole size of the
# fault (a zero gradient reads 1, a zeroed kv head of 8 sqrt(1/8)),
# where the global norm above is dominated by embed and lm_head. On the
# H100 the flash pass read 0.035 and the control 0.028 (the same measure
# for two plain passes that differ only in rounding: bf16 noise grown
# through 32 layers), so the limit sits just above both (PERF.md).
TRAIN_ATTN_GRAD_REL_TOL = 5e-2
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")
# train_mesh: the reference's own test mesh (tests/test_models.py:80-122),
# one 2049-token sequence per batch group, from np.random.default_rng(5).
TRAIN_MESH = dict(dp=2, fsdp=2, tp=2)
TRAIN_MESH_BATCH = 4
# The sampled gradients, sharded against unsharded, ||g - g_ref|| /
# ||g_ref||: the same bf16 drift as the train phase's flash-against-plain
# attention weights (TRAIN_ATTN_GRAD_REL_TOL), from another order of sums
# (the tp all-reduce, the split cross-entropy, per-group accumulation).
TRAIN_MESH_GRAD_REL_TOL = 5e-2
TRAIN_MESH_SAMPLE = (("embed",), ("lm_head",)) + tuple(
    ("layers", li, part, name) for li in (0, 31)
    for part, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                       ("attn", "wo"), ("mlp", "w_down")))
# The profiled step's named ranges (the functions of models.transformer
# that one step calls, wrapped while profiling).
TRAIN_MESH_RANGES = {"all_reduce": "tp:all_reduce",
                     "reshard": "fsdp:gather",
                     "vocab_parallel_nll": "vocab:cross_entropy"}
# train_pp: the reference's own pp training mesh
# (tests/test_parallel_advanced.py:158-182), train_mesh's batch, two
# microbatches per batch group; the stage hand-off as a named range.
TRAIN_PP = dict(pp=2, dp=2, tp=2)
TRAIN_PP_MICROBATCHES = 2
TRAIN_PP_RANGES = dict(TRAIN_MESH_RANGES, stage_send="pp:send")
# train_sp: the reference's own sp training mesh beside dp and tp
# (tests/test_ops.py:50-100 runs dp=2 x sp=4; here tp=2 takes two of its
# positions so that each tp position holds Hq 16 / Hkv 4, as in
# train_mesh), train_mesh's batch and seeded params, ring attention over
# each (batch group, tp position)'s two sp positions, three steps; then
# one value_and_grad with the flash kernels on the same mesh (each
# position's sequence gathered on its first sp position around kernel 1,
# and kernels 2-3 in its backward). Step 1 is held to train_mesh's
# unsharded flash pass with the train phase's limits: the ring differs
# from the flash kernel as the flash kernel differs from plain attention
# (bf16 probabilities into an f32 sum, in another order), the control the
# train phase measured those limits on (PERF.md).
TRAIN_SP = dict(dp=2, sp=2, tp=2)
TRAIN_SP_STEPS = 3
# train_rules: train_mesh's mesh, batch and seeded params under rule
# tables other than the default: each stores the params as it says (the
# MLP's weights over fsdp on their embed dim and whole over tp; the embed
# dim over tp, the heads whole) and the model computes in its own layout,
# gathering and slicing at use. Three steps (step 2 is the first with a
# learning rate above 0, so step 3's loss is the first that can fall).
# The batch over dp alone (its batch groups twice train_mesh's) runs only
# where the planner's figure for it, beside the first table's measured
# peak, leaves TRAIN_RULES_HEADROOM of the card free.
TRAIN_RULES = (("mlp-fsdp", (("mlp", "fsdp"),)),
               ("embed-tp", (("embed", "tp"),)))
TRAIN_RULES_IF_IT_FITS = ("batch-dp", (("batch", "dp"),))
TRAIN_RULES_STEPS = 3
TRAIN_RULES_HEADROOM = 0.05
# serve_rules: the serve phase's prompts on engines under the reference's
# default table (the vocabulary over tp, the embed dim over fsdp), on tp=2
# and on fsdp=2 x tp=2 naming the card 2 and 4 times; the longest prompt
# again as a prefix hit.
SERVE_RULES = (("tp2", dict(tp=2)), ("fsdp2xtp2", dict(fsdp=2, tp=2)))
SERVE_RULES_ENGINE = dict(SERVE_ENGINE, prefix_cache=True)
# perf: the port's engine and device-plane rows (ray_tpu_torch/util/perf.py)
# on the serve params, one run_microbenchmarks call per report, each row's
# min_time_s the reference's --min-time-s of 1; a report's rows run once.
PERF_MIN_TIME_S = 1.0
PERF_GROUPS = (
    ("serving", ("serving_ttft_p50_ms", "serving_tokens_per_s_per_replica")),
    ("pd_serving", ("serving_pd_ttft_p50_ms",
                    "serving_pd_tokens_per_s_per_replica")),
    ("long_context", ("sp_prefill_tokens_per_s",
                      "sp_prefill_tokens_per_s_base", "long_context_ttft_ms",
                      "long_context_ttft_staged_ms")),
    ("device_channel", ("device_channel_steps_per_s",
                        "device_channel_steps_per_s_host")),
    ("kv_handoff", ("kv_handoff_gibs",)),
    ("kv_pressure", ("prefix_cache_hit_rate_under_pressure",
                     "prefix_cache_hit_rate_nodemote")),
)
# The reference script's counts (ray_tpu/util/perf.py:826-858): hits and
# misses with demotion on, then off.
PERF_KV_COUNTS = {"with_demotion": (9, 2), "without_demotion": (4, 7)}
PERF_OPEN_LOOP_REQUESTS = 17      # the warm-up and 4 Hz for 4 s
PERF_PHASE_S = 90.0
# serve_apps: the serving apps over the serve params. OpenAIServer on the
# serve_replica shape (prefix cache on) takes a completion, a list of three
# prompts in one request, a chat, an SSE completion and chat and a chat
# stream its client leaves after APPS_CANCEL_AFTER frames: 8 full
# prefills of distinct prompts (np.random.default_rng(6)), 16 tokens
# each, and the reference's error requests. CompiledPDApp (one prefill,
# one decode replica) takes two 1000-token prompts, through generate and
# through stream. LongContextApp: a 3000-token prompt in six 512-token
# stripes over 2 shards, decoded for 8 tokens by one replica whose pool
# (max_len 512, 2 slots: 1024 tokens) holds less than the context, through
# a window of 8.
APPS_SERVER = dict(max_batch=4, max_len=2048, page_size=64)
APPS_PROMPT_LENS = (37, 300, 1000)
APPS_CANCEL_AFTER = 2
APPS_PD = dict(max_batch=4, max_len=2048, page_size=64)
APPS_PD_LEN = 1000
APPS_LC = dict(prefill_shards=2, decode_replicas=1, span=512, max_batch=2,
               max_len=512, page_size=64, kv_gather_window=8)
APPS_LC_LEN, APPS_LC_TOKENS = 3000, 8
SERVE_APPS_PHASE_S = 90.0
# collective: a 256 MiB bf16 all-reduce timed where world >= 2 (NCCL's
# bus bandwidth: algbw x 2(n - 1)/n); every wait of the spawned ranks is
# bounded.
COLLECTIVE_BYTES = 256 << 20
COLLECTIVE_ITERS = 5
COLLECTIVE_TIMEOUT_S = 120
# train_ranks' free-standing layers across ranks (four cards, one
# position a rank), each held against the same function in one process on
# rank 0 (a mesh naming its card once per position): ring and Ulysses
# attention at sp=4 at 8b-gqa's attention widths, bf16, causal;
# pipeline_spmd at pp=4, each stage 8 of 8b-gqa's layers at full width
# (plain attention, each layer checkpointed) over 4 microbatches of one
# 2048-token sequence; the MoE layer at Mixtral-8x7B's widths (MOE, MOE_X)
# on fsdp=2 x sp=2 and fsdp=2 x tp=2. The layer name -> which of the
# four.
FREE_LAYOUTS = {"ring-sp4": "ring", "ulysses-sp4": "ulysses",
                "pipeline-pp4": "pipeline", "moe-fsdp2xsp2": "moe",
                "moe-fsdp2xtp2": "moe", "moe-expert-none-fsdp2xtp2": "moe"}
# The free-standing runs under a table other than the default: the
# experts whole, so the embed dim goes over fsdp and each rank computes
# every expert over its MLP units.
FREE_RULES = {"moe-expert-none-fsdp2xtp2": (("expert", None),)}
FREE_ATTN = dict(B=1, S=8192, Hq=32, Hkv=8, D=128)
FREE_PP_MICROBATCHES = 4
FREE_PP_SEQ = 2048
# Across ranks against one process, ||got - want|| / ||want|| of each
# output and gradient: the same operations on the same card type in the
# same order (the ring's merges, Ulysses' per-head attention, each stage's
# layers), so any difference is a fault; the limit is the bf16 backward
# kernels' (BWD_TOL), for headroom over rounding that another order of an
# all-to-all's sums could bring. The MoE layer keeps its own limits
# against the unsharded layer (MOE_Y_REL_TOL, MOE_GRAD_REL_TOL).
FREE_REL_TOL = 2e-2
# train_ranks: one process per card, train_mesh's batch, seeded params
# and default rules, the flash kernels: the reference's dp x fsdp layout
# (tests/test_models.py:80-122 without its tp axis), then tp, sp and pp
# groups split over ranks. A world of one (on one card) holds each
# layout's positions on its card; four ranks (four cards) run each layout
# one position a rank, then sp=2 x tp=2's step 1 again under ring
# attention. (name, mesh, microbatches under pp.) The kernels line reports
# the dp x fsdp layout's launches under train_ranks, the others' under
# train_split_ranks.
TRAIN_RANKS = {1: (("dp2xfsdp2", dict(dp=2, fsdp=2), None),
                   ("tp4", dict(tp=4), None)),
               4: (("dp2xfsdp2", dict(dp=2, fsdp=2), None),
                   ("tp4", dict(tp=4), None),
                   ("pp2xtp2", dict(pp=2, tp=2), 2),
                   ("sp2xtp2", dict(sp=2, tp=2), None),
                   ("ring-sp4", dict(sp=4), None),
                   ("ulysses-sp4", dict(sp=4), None),
                   ("pipeline-pp4", dict(pp=4), FREE_PP_MICROBATCHES),
                   ("moe-fsdp2xsp2", dict(fsdp=2, sp=2), None),
                   ("moe-fsdp2xtp2", dict(fsdp=2, tp=2), None),
                   ("moe-expert-none-fsdp2xtp2", dict(fsdp=2, tp=2),
                    None))}
# train_ranks' runs under other rule tables, across ranks: (name, mesh,
# the overrides of the default table). Each runs where the planner's
# per-rank figure leaves TRAIN_RULES_HEADROOM of the card free.
RULES_RANKS = {1: (("batch-dp-dp2xfsdp2", dict(dp=2, fsdp=2),
                    (("batch", "dp"),)),),
               4: (("mlp-fsdp-dp2xfsdp2", dict(dp=2, fsdp=2),
                    (("mlp", "fsdp"),)),
                   ("batch-dp-dp2xfsdp2", dict(dp=2, fsdp=2),
                    (("batch", "dp"),)),
                   ("heads-tp-fsdp-fsdp2xtp2", dict(fsdp=2, tp=2),
                    (("heads", ("tp", "fsdp")), ("embed", None))))}
TRAIN_RANKS_DP = "dp2xfsdp2"
TRAIN_RANKS_STEPS = 3
TRAIN_RANKS_TIMEOUT_S = 600
# The profiled step's named ranges: the in-layer all-reduce, the stage
# hand-off across ranks, the ring's P2P exchange and the gathered
# sequence's join and split (each over NCCL where it spans ranks).
TRAIN_RANKS_RANGES = (
    ("transformer", {"all_reduce": "tp:all_reduce",
                     "exchange": "reshard:all_gather",
                     "vocab_parallel_nll": "vocab:cross_entropy",
                     "seq_gather": "sp:gather",
                     "seq_scatter": "sp:scatter"}),
    ("exchange", {"backward": "reshard:reduce_scatter"}),
    ("handoffs", {"send": "pp:send", "recv": "pp:recv"}),
    ("ring", {"_exchange": "sp:ring", "all_to_all": "sp:all_to_all"}),
    ("moe", {"all_to_all": "ep:all_to_all", "exchange": "ep:all_gather"}))
# moe: one MoE layer at Mixtral-8x7B's published widths
# (mistralai/Mixtral-8x7B-v0.1 config.json: hidden_size 4096,
# intermediate_size 14336, num_local_experts 8, num_experts_per_tok 2),
# MoEConfig's own defaults otherwise (capacity_factor 1.25), bf16, on x of
# (4, 2048, 4096); then ep-sharded on the reference's EP test mesh
# (tests/test_parallel_advanced.py:120-140).
MOE = dict(d_model=4096, d_ff=14336, num_experts=8, num_experts_per_token=2)
MOE_X = (4, 2048)
MOE_MESH = dict(fsdp=2, sp=2, tp=2)
# ||sharded - unsharded|| / ||unsharded|| of y and of each parameter's
# gradient. The sharded layer rounds each tp position's w_down partial to
# bf16 before the f32 sum (the unsharded product rounds once), so y moves
# by about one bf16 rounding of ye (2^-9 relative per element); the
# gradients see the same rounding through ye and the dispatched slots.
# The control is the unsharded layer with its MLP units relabelled, which
# changes only the order of w_down's sums.
MOE_Y_REL_TOL = 2e-2
MOE_GRAD_REL_TOL = 5e-2
# The moe phase's second ep-sharded run: the embed dim over tp (w_gate and
# w_up stored over experts and the embed dim, w_down over experts and MLP
# units, the router over its embed dim), held to the same limits.
MOE_RULES = (("embed", "tp"),)
# The device_plane phase: the serve phase's longest prompt, whose P/D blob
# is 32 layers x 1900 tokens x 8 kv heads x 128 x 2 bytes, for k and v.
DEVICE_PLANE_LEN = PROMPT_LENS[-1]
DEVICE_PLANE_BYTES = 32 * 1900 * 8 * 128 * 2 * 2      # 249,036,800
DEVICE_PLANE_ROUNDS = 3       # serialize/deserialize rounds, cold first
DEVICE_PLANE_CHILD_S = 300    # bound on the spawned process

# rllib: the JAX package's defaults (hiddens (64, 64)) at CartPole's widths
# (4 observations, 2 actions), each algorithm's own config (lr, grad_clip).
RLLIB_SPEC = dict(obs_dim=4, num_actions=2, hiddens=(64, 64))
# One update on the card against the same update on the CPU, f32 with TF32
# off: max |diff| / max |ref| per tensor (params, targets), and
# |diff| / max(|ref|, 1) per metric. PPO's update is 24 Adam steps, whose
# unit-size moves amplify a last-bit difference in a gradient element that
# is noise; the CPU tests hold the port to JAX at 1e-5 absolute.
RLLIB_REL_TOL = 1e-4
RLLIB_UPDATE_ITERS = 5        # timed updates on the card, after two warm
# PPO's learning gate, tests/test_rllib.py:48-69: 2 runners x 8 envs x 64
# steps, lr 3e-4, entropy 0.01, seed 0; a mean return of 120 in 35.
RLLIB_PPO_RUNNERS = dict(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
RLLIB_PPO_RETURN = 120.0
RLLIB_PPO_ITERS = 35
RLLIB_OTHER_ITERS = 3
RLLIB_PHASE_S = 90.0
RLLIB_ON_CARD = dict(learner=["cuda:0"], runners=["cuda:0"])
# rllib_offline: the JAX tests' learning gates (tests/test_rllib_sac_offline
# .py:188-247, tests/test_rllib_cql_iql.py:66-109) on the card, greedy
# returns over 5 evaluation episodes: (config, training, iterations, the
# corpus's recorder, gate; a gate of None is the behaviour's mean + 20).
RLLIB_OFFLINE_GATES = {
    "bc": (BCConfig, dict(lr=2e-3, num_epochs=4, minibatch_size=256), 15,
           "scripted", 100.0),
    "marwil": (MARWILConfig, dict(lr=2e-3, num_epochs=4, minibatch_size=256,
                                  beta=2.0), 15, "scripted+random", 80.0),
    "cql": (CQLConfig, dict(lr=1e-3, cql_alpha=1.0,
                            num_updates_per_iteration=100), 8, "mixed", None),
    "iql": (IQLConfig, dict(lr=1e-3, expectile=0.8, beta=3.0,
                            num_updates_per_iteration=100), 8, "mixed-7",
            None),
}
RLLIB_OFFLINE_MARGIN = 20.0
RLLIB_OFFLINE_EVAL_EPISODES = 5
RLLIB_OFFLINE_UPDATES = 8      # run_updates of CQL and IQL in the check
# Multi-agent: the reference's PPO config (tests/test_rllib_multi_agent.py
# :59-66) for 3 iterations; the runner check's time limit and length.
RLLIB_MA_ITERS = 3
RLLIB_MA_TIME_LIMIT = 9
RLLIB_MA_SAMPLE_LEN = 25
RLLIB_OFFLINE_PHASE_S = 120.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over iters calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10):
    """(device time of one fn() call in ms, the names of the kernels it
    ran, longest first): the summed time of every kernel that ``iters``
    calls ran on the card under torch.profiler, over ``iters``, after one
    warm-up call. Host dispatch is not in it. The time is None if the
    profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.self_device_time_total > 0:
            total += evt.self_device_time_total
            names.append((evt.self_device_time_total, evt.key[:60]))
    names = [n for _, n in sorted(names, reverse=True)]
    return (total / 1e3 / iters if total else None), names


def sdpa_backend(names) -> str:
    """Which scaled_dot_product_attention backend ran, read from the names
    of its kernels."""
    joined = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in joined:
            return backend
    return "math"


def attention_bound(B, S, Hq, Hkv, D, dtype, causal, kernel="fwd"):
    """(bound_ms, bound_by) of one kernel: the larger of its operations
    over the peak rate of the type and its bytes over the memory rate.
    Per live (query, key) pair and head dim: fwd 2 products (4 ops), dq 3
    (6), dkv 4 (8). Bytes: each q-shaped and kv-shaped tensor read or
    written once (fwd q, o / k, v; dq q, o, dO, dQ / k, v; dkv q, dO / k,
    v, dK, dV) plus the f32 rows (fwd lse written; dq lse read and delta
    written; dkv lse, delta read)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    ops, n_q, n_kv, n_rows = {"fwd": (4, 2, 2, 1), "dq": (6, 4, 2, 2),
                              "dkv": (8, 2, 4, 2)}[kernel]
    flops = ops * B * Hq * D * pairs
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (elt * B * S * D * (n_q * Hq + n_kv * Hkv)
              + 4 * n_rows * B * Hq * S)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fwd_against_plain(gen, case) -> tuple:
    """Kernel 1 against its plain version on random inputs of ``case``'s
    shape: (q, k, v, max |diff| of o, of lse, all finite, within TOL)."""
    B, S, Hq, Hkv, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    dtype, causal = case["dtype"], case["causal"]

    def rand(h):
        return torch.randn((B, S, h, D), generator=gen, device="cuda"
                           ).to(dtype)
    q, k, v = rand(Hq), rand(Hkv), rand(Hkv)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = reference_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    tol = TOL[dtype]
    return (q, k, v, err_o, err_lse, finite,
            finite and err_o <= tol["o"] and err_lse <= tol["lse"])


def kernel_phase(card: str, failures: list) -> list:
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for case in KERNEL_CASES:
        B, S, Hq, Hkv, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "D"))
        dtype, causal = case["dtype"], case["causal"]
        q, k, v, err_o, err_lse, _, ok = fwd_against_plain(gen, case)
        tol = TOL[dtype]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = attention_bound(B, S, Hq, Hkv, D, dtype, causal)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        library_ms, library_kernels = device_ms(sdpa)
        row = dict(
            phase="kernel", name="flash_attention_fwd", B=B, S=S, Hq=Hq,
            Hkv=Hkv, D=D, dtype=str(dtype).replace("torch.", ""),
            causal=causal, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
            tol_o=tol["o"], tol_lse=tol["lse"], ok=ok,
            ms=time_ms(lambda: flash_attention_fwd(q, k, v,
                                                      causal=causal)),
            plain_ms=time_ms(lambda: reference_attention_lse(
                q, k, v, causal=causal)),
            library_ms=library_ms, library_backend=sdpa_backend(
                library_kernels), library_kernels=library_kernels[:3],
            library_event_ms=time_ms(sdpa),
            bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel mismatch: {row}")
    return rows


def _rel_errs(got, want):
    """Per gradient: (max |diff|, max |diff| / max |ref|)."""
    out = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        out.append((err, err / max(w.float().abs().max().item(), 1e-30)))
    return out


def _bwd_ok(errs, dtype) -> bool:
    i = 1 if dtype == torch.bfloat16 else 0   # relative, or absolute
    return all(e[i] <= BWD_TOL[dtype] for e in errs)


def _delta_err(q, k, v, o, do, lse, causal) -> float:
    """max |diff| / max |ref| of the dQ kernel's delta against the plain
    row-sum on the same o and dO."""
    got = flash_attention_dq(q, k, v, o, do, lse, causal=causal)[1]
    want = attention_bwd_delta(o, do)
    return ((got - want).abs().max()
            / max(want.abs().max().item(), 1e-30)).item()


def bwd_kernels_only(names) -> bool:
    """Whether the kernels one backward ran on the card are exactly the dQ
    and the dK/dV kernel: no elementwise or reduction pass beside them."""
    return (len(names) == 2 and sum("fa_dkv" in n for n in names) == 1
            and sum("fa_dq" in n for n in names) == 1)


def kernel_bwd_phase(card: str, failures: list) -> list:
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for case in BWD_CASES:
        B, S, Hq, Hkv, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "D"))
        dtype, causal = case["dtype"], case["causal"]

        def rand(h):
            return torch.randn((B, S, h, D), generator=gen, device="cuda"
                               ).to(dtype)
        q, k, v, do = rand(Hq), rand(Hkv), rand(Hkv), rand(Hq)
        # Both sides get the same o and lse, so only the backward differs.
        o, lse = reference_attention_lse(q, k, v, causal=causal)
        delta = attention_bwd_delta(o, do)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = reference_attention_bwd(q, k, v, o, lse, do, causal=causal)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        errs = _rel_errs(got, want)
        delta_err = _delta_err(q, k, v, o, do, lse, causal)

        # The autograd Function (forward kernel, then dQ and dK/dV) against
        # autograd through plain attention.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fa = torch.autograd.grad(flash_attention(*leaves, causal=causal),
                                 leaves, do)
        ra = torch.autograd.grad(reference_attention(*leaves, causal=causal),
                                 leaves, do)
        fn_errs = _rel_errs(fa, ra)
        ok = (finite and _bwd_ok(errs, dtype) and _bwd_ok(fn_errs, dtype)
              and delta_err <= DELTA_REL_TOL)
        # The main training shape: one backward is the two kernels alone.
        main = dict(TRAIN_HEADS, S=TRAIN_SEQ) == case
        if main:
            bwd_device, bwd_kernels = device_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal))
            if not bwd_kernels_only(bwd_kernels):
                failures.append(f"the backward ran other kernels than dQ "
                                f"and dK/dV: {bwd_kernels}")

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                       retain_graph=True)
        library_ms, library_kernels = device_ms(sdpa_bwd)
        # The kernels' device time alone: where a launch takes less time
        # on the card than on the host, the CUDA-events loop reads the
        # launch rate.
        dq_device = device_ms(lambda: flash_attention_dq(
            q, k, v, o, do, lse, causal=causal))[0]
        dkv_device = device_ms(lambda: flash_attention_dkv(
            q, k, v, do, lse, delta, causal=causal))[0]
        shape = (B, S, Hq, Hkv, D, dtype, causal)
        dq_bound, dq_by = attention_bound(*shape, kernel="dq")
        dkv_bound, dkv_by = attention_bound(*shape, kernel="dkv")
        row = dict(
            phase="kernel_bwd", B=B, S=S, Hq=Hq, Hkv=Hkv, D=D,
            dtype=str(dtype).replace("torch.", ""), causal=causal,
            max_abs_err_dq=errs[0][0], max_abs_err_dk=errs[1][0],
            max_abs_err_dv=errs[2][0],
            rel_err=[e[1] for e in errs],
            autograd_rel_err=[e[1] for e in fn_errs],
            autograd_max_abs_err=[e[0] for e in fn_errs],
            tol=BWD_TOL[dtype],
            tol_kind="relative" if dtype == torch.bfloat16 else "absolute",
            delta_rel_err=delta_err, delta_rel_tol=DELTA_REL_TOL,
            ok=ok,
            dq_ms=time_ms(lambda: flash_attention_dq(
                q, k, v, o, do, lse, causal=causal)),
            dkv_ms=time_ms(lambda: flash_attention_dkv(
                q, k, v, do, lse, delta, causal=causal)),
            dq_device_ms=dq_device, dkv_device_ms=dkv_device,
            plain_delta_ms=time_ms(lambda: attention_bwd_delta(o, do)),
            bwd_ms=time_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal)),
            plain_dq_ms=time_ms(lambda: reference_attention_dq(
                q, k, v, o, do, lse, causal=causal)),
            plain_dkv_ms=time_ms(lambda: reference_attention_dkv(
                q, k, v, do, lse, delta, causal=causal)),
            plain_ms=time_ms(lambda: reference_attention_bwd(
                q, k, v, o, lse, do, causal=causal)),
            library_ms=library_ms, library_backend=sdpa_backend(
                library_kernels), library_kernels=library_kernels[:3],
            library_event_ms=time_ms(sdpa_bwd),
            dq_bound_ms=dq_bound, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by, card=card)
        if main:
            row.update(bwd_device_ms=bwd_device,
                       bwd_device_kernels=bwd_kernels)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"backward kernel mismatch: {row}")
    return rows


def _bf16_inputs(gen, B, S, Hq, Hkv, D):
    def rand(h):
        return torch.randn((B, S, h, D), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    return rand(Hq), rand(Hkv), rand(Hkv), rand(Hq)


def _tiling_check(q, k, v, do, causal: bool):
    """(errors, ok) of the forward kernel (o, lse), the backward kernels
    (dq, dk, dv) and the dQ kernel's delta against their plain versions on
    one bf16 input. The backward is held as BWD_TOL's relative measure
    with the reference's scale floored at 1: where a gradient is zero in
    exact arithmetic (dK at S = 1, whose one probability is 1, so
    dS = dP - delta = 0) only rounding is left, and a ratio to its own
    maximum means nothing."""
    tol = TOL[torch.bfloat16]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = reference_attention_lse(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    want = reference_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    bwd = [((g.float() - w.float()).abs().max()
            / max(w.float().abs().max().item(), 1.0)).item()
           for g, w in zip(got, want)]
    delta_err = _delta_err(q, k, v, ro, do, rlse, causal)
    finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *got))
    ok = (finite and err_o <= tol["o"] and err_lse <= tol["lse"]
          and all(e <= BWD_TOL[torch.bfloat16] for e in bwd)
          and delta_err <= DELTA_REL_TOL)
    return dict(max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                bwd_err=bwd, delta_rel_err=delta_err), ok


def tiling_phase(card: str, failures: list) -> dict:
    gen = torch.Generator("cuda").manual_seed(2)
    keys = ("B", "S", "Hq", "Hkv", "D")
    cases = []
    for case in TILING_CASES:
        errs, ok = _tiling_check(
            *_bf16_inputs(gen, *(case[x] for x in keys)), case["causal"])
        cases.append(dict(case, **errs, ok=ok))
        if not ok:
            failures.append(f"tiling case mismatch: {cases[-1]}")
    worst = {name: max(cases, key=lambda c: get(c)) for name, get in (
        ("o", lambda c: c["max_abs_err_o"]),
        ("lse", lambda c: c["max_abs_err_lse"]),
        ("bwd", lambda c: max(c["bwd_err"])),
        ("delta", lambda c: c["delta_rel_err"]))}

    # q, k and v as the strided views a fused QKV projection leaves.
    B, S, Hq, Hkv, D = (FUSED_CASE[x] for x in keys)
    x = torch.randn((B, S, Hq + 2 * Hkv, D), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    q, k, v = x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
    do = _bf16_inputs(gen, B, S, Hq, Hkv, D)[3]
    errs, ok = _tiling_check(q, k, v, do, FUSED_CASE["causal"])
    fused = dict(FUSED_CASE, strides=[list(t.stride()) for t in (q, k, v)],
                 contiguous=q.is_contiguous(), **errs, ok=ok)
    if not ok or q.is_contiguous():
        failures.append(f"fused-view case: {fused}")

    # Two dQ launches, and two dK/dV launches, on the same inputs give the
    # same bits.
    det = []
    for shape in (dict(TRAIN_HEADS, S=TRAIN_SEQ),
                  dict(B=1, S=255, Hq=16, Hkv=1, D=128, causal=True)):
        q, k, v, do = _bf16_inputs(gen, *(shape[x] for x in keys))
        o, lse = flash_attention_fwd(q, k, v, causal=shape["causal"])
        delta = attention_bwd_delta(o, do)
        same = {}
        for name, run in (
                ("dq", lambda: flash_attention_dq(q, k, v, o, do, lse,
                                                  causal=shape["causal"])),
                ("dkv", lambda: flash_attention_dkv(q, k, v, do, lse, delta,
                                                    causal=shape["causal"]))):
            first, second = run(), run()
            same[f"{name}_bit_identical"] = all(
                torch.equal(a, b) for a, b in zip(first, second))
        det.append(dict({x: shape[x] for x in keys}, **same))
        if not all(same.values()):
            failures.append(f"a kernel's outputs differ between two "
                            f"launches: {det[-1]}")
    res = dict(phase="tiling", cases=len(cases),
               failed=[c for c in cases if not c["ok"]],
               worst={n: {x: c[x] for x in (*keys, "causal", "max_abs_err_o",
                                            "max_abs_err_lse", "bwd_err",
                                            "delta_rel_err")}
                      for n, c in worst.items()},
               fused_view=fused, determinism=det, card=card)
    emit(res)
    return res


def paged_decode_inputs(gen, case):
    """Random q and pools for ``case``; the first ``live`` slots active
    with lengths in [lo, hi], their live pages distinct and scattered over
    the pool, every other table entry the scratch page 0."""
    B, Hq, KV, D, page, P = (case[k] for k in ("B", "Hq", "KV", "D", "page",
                                               "P"))
    N = B * P + 1

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(case["dtype"])
    q, pk, pv = rand(B, Hq, D), rand(N, page, KV, D), rand(N, page, KV, D)
    lengths = torch.randint(case["lo"], case["hi"] + 1, (B,), generator=gen,
                            device="cuda")
    active = torch.arange(B, device="cuda") < case["live"]
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, P), dtype=torch.int64, device="cuda")
    for b, n in enumerate(lengths.tolist()):
        tables[b, :n // page + 1] = perm[b * P:b * P + n // page + 1]
    return q, pk, pv, tables, lengths, active


def paged_decode_bound(case, lengths, active):
    """(bytes, bound_ms): what the kernel must move, once, over the HBM
    rate: each live key and value row, the active slots' q, their lengths
    and the table entries their lengths reach, every slot's active flag and
    o row (an inactive slot's is written zero)."""
    elt = torch.tensor([], dtype=case["dtype"]).element_size()
    T = case["P"] * case["page"]
    keys = torch.clamp(lengths + 1, max=T)[active]
    live, row = len(keys), case["Hq"] * case["D"] * elt
    nbytes = (int(keys.sum()) * case["KV"] * case["D"] * 2 * elt
              + live * row + case["B"] * row
              + int((-(-keys // case["page"])).sum()) * 8
              + live * 8 + case["B"])
    return nbytes, nbytes / PEAK_BYTES_S * 1e3


def paged_decode_phase(card: str, failures: list) -> list:
    """The paged-decode kernel against its twin and the exact function,
    and its time beside its bytes bound (see the module docstring)."""
    gen = torch.Generator("cuda").manual_seed(3)
    rows = []
    for case in PAGED_DECODE_CASES:
        args = paged_decode_inputs(gen, case)
        q, pk, pv, tables, lengths, active = args
        scale = 1.0 / float(torch.tensor(math.sqrt(case["D"]),
                                         dtype=case["dtype"]))
        o = paged_decode_attention(*args, scale)
        twin = reference_paged_decode_attention(*args, scale)
        exact = reference_paged_decode_attention(
            q.float(), pk.float(), pv.float(), tables, lengths, active,
            scale)
        a = active
        err = (o[a].float() - exact[a]).abs().max().item()
        err_twin = (o[a].float() - twin[a].float()).abs().max().item()
        twin_err = (twin[a].float() - exact[a]).abs().max().item()
        tol = paged_attention.kernel_tolerance(case["dtype"], pv, exact[a])
        zero = not o[~a].any()
        ok = bool(torch.isfinite(o).all()) and err <= tol \
            and err_twin <= twin_err + tol and zero
        nbytes, bound_ms = paged_decode_bound(case, lengths, active)
        chunk, splits = paged_attention.split_keys(
            case["B"], case["KV"], case["Hq"] // case["KV"],
            case["P"] * case["page"],
            torch.cuda.get_device_properties(0).multi_processor_count)
        ms = time_ms(lambda: paged_decode_attention(*args, scale), iters=50)
        dev_ms, _ = device_ms(lambda: paged_decode_attention(*args, scale),
                              iters=20)
        row = dict(
            phase="paged_decode", name="paged_decode_attention",
            case=case["name"], **{k: case[k] for k in (
                "B", "Hq", "KV", "D", "page", "P", "live")},
            dtype=str(case["dtype"]).replace("torch.", ""),
            lengths=[int(lengths[active].min()), int(lengths[active].max())],
            chunk=chunk, splits=splits, max_abs_err=err, tol=tol,
            max_abs_err_twin=err_twin, twin_max_abs_err=twin_err,
            inactive_zero=zero, ok=ok, ms=ms,
            plain_ms=time_ms(
                lambda: reference_paged_decode_attention(*args, scale),
                iters=5),
            device_ms=dev_ms, bytes=nbytes, bound_ms=bound_ms,
            bound_by="bytes", share_of_bound=bound_ms / ms,
            device_share_of_bound=bound_ms / dev_ms if dev_ms else None,
            bytes_per_s=nbytes / ms * 1e3, card=card)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"paged_decode mismatch: {row}")
        del args, q, pk, pv, o, twin, exact
    torch.cuda.empty_cache()
    return rows


def serve_params():
    """(the 8B model's random bf16 params on the card, seconds to make
    them), shared by the serve and serve_cache phases."""
    t0 = time.perf_counter()
    params = init_params(PRESETS["8b-gqa"],
                         torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


class DecodeLaunches:
    """Counts, while entered, the engine's decode steps (calls of
    ``llm.engine._decode_fn``, one per replica a step) and the paged-decode
    launches they must make, one per layer each position on a card holds;
    sets ``paged_decode_attention.launches`` to 0 on entry, so that
    ``got`` is the entered block's own."""

    def __enter__(self):
        self.steps = self.want = 0
        self._step = step = llm_engine._decode_fn
        lock = threading.Lock()         # replicas decode on executor threads

        def counted(params, *args, **kwargs):
            want = sum(p["layers"]["attn"]["wq"].shape[0] for p in params
                       if p["layers"]["attn"]["wq"].device.type == "cuda")
            with lock:
                self.steps += 1
                self.want += want
            return step(params, *args, **kwargs)

        llm_engine._decode_fn = counted
        paged_decode_attention.launches = 0
        return self

    def __exit__(self, *exc):
        llm_engine._decode_fn = self._step
        self.got = paged_decode_attention.launches


def serve_phases(card: str, failures: list) -> list:
    """The serve phases on one copy of the 8B params, in order, each with
    its decode launches counted (DecodeLaunches); emits those counts as
    the decode_launches line and returns the phases' results and then the
    counts, {phase: {steps, got, want}}."""
    params, init_s = serve_params()
    phases = (("serve", functools.partial(serve_phase, init_s=init_s)),
              ("serve_cache", serve_cache_phase),
              ("serve_paged", serve_paged_phase),
              ("serve_replica", serve_replica_phase),
              ("serve_sp", serve_sp_phase), ("serve_tp", serve_tp_phase),
              ("serve_mesh", serve_mesh_phase),
              ("device_plane", device_plane_phase),
              ("serve_rules", serve_rules_phase), ("perf", perf_phase),
              ("serve_apps", serve_apps_phase))
    out, counts = [], {}
    for name, phase in phases:
        with DecodeLaunches() as n:
            out.append(phase(card, failures, params))
        counts[name] = dict(steps=n.steps, got=n.got, want=n.want)
        if n.got != n.want:
            failures.append(f"paged-decode kernel launched {n.got} times "
                            f"in {name}'s {n.steps} decode steps, expected "
                            f"{n.want}")
    if not sum(c["got"] for c in counts.values()):
        failures.append("no serve phase launched the paged-decode kernel")
    emit(dict(phase="decode_launches", by_phase=counts, card=card))
    del params
    return out + [counts]


def plain_logits(params, cfg, prompt, bucket: int) -> tuple:
    """(forward() with plain attention's last-token logits of ``prompt``,
    the same on the prompt padded to ``bucket``): the reference, and the
    noise floor of two orderings of the same bf16 sums. Copies of the rows,
    so that the (1, S, V) f32 logits they come from are freed."""
    ref_cfg = dataclasses.replace(cfg, attention_impl="xla")
    n = len(prompt)
    with torch.no_grad():
        ref = forward(params, torch.tensor([prompt]), ref_cfg,
                      device="cuda")[0, -1].clone()
        padded = prompt + [0] * (bucket - n)
        noise = forward(params, torch.tensor([padded]), ref_cfg,
                        device="cuda")[0, n - 1].clone()
    return ref, noise


def serve_phase(card: str, failures: list, params, init_s: float) -> dict:
    cfg = PRESETS["8b-gqa"]
    eng = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    sp = SamplingParams(max_tokens=MAX_TOKENS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    t_start = time.perf_counter()
    ids = [eng.add_request(p, sp) for p in prompts]
    ttft, outs, step_s, step_tokens = {}, {}, [], []
    while eng.has_unfinished():
        t_step = time.perf_counter()
        finished = eng.step()
        now = time.perf_counter()
        events = eng.take_tick_events()
        step_s.append(now - t_step)
        step_tokens.append(len(events))
        for rid, _, _ in events:
            ttft.setdefault(rid, now - t_start)
        for req in finished:
            outs[req.req_id] = req.out
    total_s = time.perf_counter() - t_start
    launches = flash_attention_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want_launches = len(prompts) * cfg.num_layers
    if launches != want_launches:
        failures.append(f"flash kernel launched {launches} times on the "
                        f"serve path, expected {want_launches}")
    for rid in ids:
        out = outs.get(rid, [])
        if len(out) != MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                             for t in out):
            failures.append(f"request {rid} returned {out}")

    # Each prompt's prefill logits (flash kernel, padded bucket) against
    # forward() with plain attention on the unpadded prompt. The noise
    # floor is plain attention on the padded bucket against the same.
    checks = []
    with torch.no_grad():
        for rid, prompt in zip(ids, prompts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = eng._run_prefill(prompt)[0]
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            n = len(prompt)
            ref, noise = plain_logits(params, cfg, prompt, eng._bucket(n))
            scale = ref.abs().max()
            rel = ((logits - ref).abs().max() / scale).item()
            first_ok = int(logits.argmax()) == outs.get(rid, [None])[0]
            checks.append(dict(
                prompt_len=n, prefill_ms=prefill_ms, logits_rel_err=rel,
                noise_rel_err=((noise - ref).abs().max() / scale).item(),
                first_token_ok=first_ok))
            if not (rel < LOGITS_REL_TOL and first_ok
                    and bool(torch.isfinite(logits).all())):
                failures.append(f"prefill logits mismatch: {checks[-1]}")

    decode_tokens = sum(step_tokens[1:])
    decode_s = sum(step_s[1:])
    res = dict(
        phase="serve", preset="8b-gqa", params=cfg.param_count(),
        layers=cfg.num_layers, init_s=init_s, max_batch=4, max_len=2048,
        page_size=64, prompt_lens=list(PROMPT_LENS), max_tokens=MAX_TOKENS,
        flash_launches=launches, expected_launches=want_launches,
        ttft_s=[ttft.get(rid) for rid in ids], steps=len(step_s),
        first_step_s=step_s[0], total_s=total_s,
        decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
        peak_memory_gb=peak_gb, prefill=checks,
        logits_rel_tol=LOGITS_REL_TOL, card=card)
    emit(res)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def uncounted():
    """Keep the forward kernel's launches inside the block (a reference
    prefill held against the main path, or a timing) out of the main
    path's count."""
    before = flash_attention_fwd.launches
    try:
        yield
    finally:
        flash_attention_fwd.launches = before


def keep_sampled_logits(eng) -> list:
    """Wrap ``eng._sample_batch`` so that the logits of every wave it
    samples (an admission wave, a final chunk, a prefill_only) are kept,
    one list per wave, in admission order."""
    waves = []
    sample = eng._sample_batch

    def keep(logits_list, params_list):
        waves.append([lg.clone() for lg in logits_list])
        return sample(logits_list, params_list)
    eng._sample_batch = keep
    return waves


@contextlib.contextmanager
def captured_spans():
    """Swap the port's process flight recorder for a fresh one around the
    block, so that only the block's spans are read; restore it after."""
    old = flight_recorder._recorder
    rec = flight_recorder._recorder = flight_recorder.FlightRecorder()
    try:
        yield rec
    finally:
        flight_recorder._recorder = old


def timed_steps(eng) -> list:
    """Wrap ``eng.step`` so that each call's synchronised host time (ms) is
    kept, in order."""
    times = []
    step = eng.step

    def timed():
        t0 = time.perf_counter()
        done = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return done
    eng.step = timed
    return times


def host_ms(fn, iters: int = 3) -> float:
    """Mean synchronised host time of fn() over iters calls, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profiled(fn, ranges=()) -> dict:
    """One fn() call under torch.profiler, after a warm-up: its
    synchronised wall time, device time by kernel class, the device's idle
    share over the call and the five kernels that took the most. Each of
    ``ranges``, a ``record_function`` range that fn opens, has the device
    time of the kernels launched inside it taken out of its class into a
    class of its own name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split, top = device_time_split(prof)
    busy = sum(split.values())
    split_ranges(prof, split, ranges)
    return dict(wall_ms=wall_ms, device_ms=split if busy else "not measured",
                idle_share=1 - busy / wall_ms if busy else "not measured",
                top_kernels=top[:5])


def split_ranges(prof, split: dict, ranges) -> None:
    """Take each of ``ranges``' device time out of ``split``'s "other"
    into a class of its own name. The CPU side of a ``record_function``
    range: its device time is that of the kernels its ops launched, all
    elementwise work, copies and reductions ("other")."""
    for name in ranges:
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == name
                 and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
        split[name] = ms if ms else "not measured"
        split["other"] -= ms


def run_timed(eng) -> tuple:
    """Step ``eng`` until idle: ({req_id: tokens}, ms from the first step
    to each request's first token, ms of each step)."""
    outs, first_ms, step_ms = {}, {}, []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while eng.has_unfinished():
        t0 = time.perf_counter()
        finished = eng.step()
        now = time.perf_counter()
        step_ms.append((now - t0) * 1e3)
        for rid, _, _ in eng.take_tick_events():
            first_ms.setdefault(rid, (now - t_start) * 1e3)
        for req in finished:
            outs[req.req_id] = req.out
    return outs, first_ms, step_ms


def check_logits(eng, params, prompt, logits, first: int, what: str,
                 failures: list) -> dict:
    """The main path's last-token logits of ``prompt`` (a prefix-cache hit
    or a chunked prefill) against an uncached prefill of the same prompt
    through the flash kernel, and its first greedy token against that
    prefill's argmax. The noise floor is the uncached prefill against
    forward() with plain attention on the same prompt."""
    with uncounted(), torch.no_grad():
        ref = eng._run_prefill(prompt)[0]
        plain = forward(params, torch.tensor([prompt]),
                        dataclasses.replace(eng.cfg, attention_impl="xla"),
                        device="cuda")[0, -1]
    scale = ref.abs().max()
    res = dict(what=what, prompt_len=len(prompt),
               logits_rel_err=((logits - ref).abs().max() / scale).item(),
               noise_rel_err=((plain - ref).abs().max() / scale).item(),
               first_token_ok=first == int(ref.argmax()))
    if not (res["logits_rel_err"] < LOGITS_REL_TOL and res["first_token_ok"]
            and bool(torch.isfinite(logits).all())):
        failures.append(f"serve_cache logits mismatch: {res}")
    return res


def check_tokens(outs: dict, ids, what: str, vocab: int,
                 failures: list) -> None:
    for rid in ids:
        out = outs.get(rid, [])
        if len(out) != MAX_TOKENS or not all(0 <= t < vocab for t in out):
            failures.append(f"serve_cache {what}: request {rid} returned "
                            f"{out}")


def serve_cache_phase(card: str, failures: list, params) -> dict:
    """The prefix cache, chunked prefill, P/D, KV demotion and cancellation
    on the serve phase's params (see the module docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    a = LLMEngine(cfg, params, device="cuda", prefix_cache=True,
                  **SERVE_ENGINE)
    b = LLMEngine(cfg, params, device="cuda", prefix_cache=True,
                  prefill_chunk=PREFILL_CHUNK, **SERVE_ENGINE)
    a_waves, b_waves = keep_sampled_logits(a), keep_sampled_logits(b)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    checks, timings = [], {}
    prefills = {}              # full prefills and first chunks, by section
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0

    # Prefix hits on A: four requests sharing 16 pages, submitted together.
    prefix = toks(SHARED_PREFIX)
    hit_prompts = [prefix + toks(n) for n in HIT_SUFFIXES]
    ids = [a.add_request(p, sp) for p in hit_prompts]
    outs, first_ms, _ = run_timed(a)
    prefills["prefix_hits"] = 1
    check_tokens(outs, ids, "prefix hits", cfg.vocab_size, failures)
    hit_stats = a.prefix_cache_stats()
    if (hit_stats["hits"], hit_stats["hit_pages"], hit_stats["misses"]) \
            != (3, 48, 1):
        failures.append(f"serve_cache prefix hits: {hit_stats}")
    if [len(w) for w in a_waves] != [len(ids)]:
        failures.append(f"serve_cache: the four requests were not one "
                        f"admission wave: {[len(w) for w in a_waves]}")
    else:
        for rid, prompt, logits in list(zip(ids, hit_prompts,
                                            a_waves[0]))[1:]:
            checks.append(check_logits(a, params, prompt, logits,
                                       outs.get(rid, [-1])[0], "hit",
                                       failures))
    timings["hit_wave_first_token_ms"] = [first_ms.get(r) for r in ids]
    # The longest hit's suffix prefill (against its 16 cached pages) and
    # its full prefill, each alone.
    longest = hit_prompts[-1]
    n_shared = SHARED_PREFIX // a.page
    row = np.zeros(a.pages_per_slot, np.int64)
    row[:n_shared] = a._cache._entries[a._cache._keys(longest,
                                                      n_shared)[-1]]
    with uncounted(), torch.no_grad():
        timings["suffix_prefill_ms"] = host_ms(
            lambda: a._run_suffix(longest, SHARED_PREFIX, row))
        timings["full_prefill_ms"] = host_ms(lambda: a._run_prefill(longest))
        timings["profiled"] = dict(
            suffix_prefill=profiled(
                lambda: a._run_suffix(longest, SHARED_PREFIX, row)),
            full_prefill=profiled(lambda: a._run_prefill(longest)))
    timings["prefill_prompt_len"] = len(longest)
    timings["suffix_len"] = len(longest) - SHARED_PREFIX

    # Chunked prefill on B: one chunk per step beside a decoding request.
    rid_s = b.add_request(toks(HIT_SUFFIXES[0]), sp)
    b.step()
    b.take_tick_events()
    long_prompt = toks(CHUNKED_LEN)
    rid_l = b.add_request(long_prompt, sp)
    long_req = b._requests[rid_l]
    chunk_steps = []
    while not long_req.out and len(chunk_steps) < 2 * CHUNKED_LEN // a.page:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.step()
        torch.cuda.synchronize()
        events = b.take_tick_events()
        chunk_steps.append(dict(
            ms=(time.perf_counter() - t0) * 1e3,
            prefilled=long_req.prefilled,
            decoding_emitted=sum(r == rid_s for r, _, _ in events)))
    prefills["chunked"] = 2                # the short prompt, chunk 1
    want_prefilled = [min(PREFILL_CHUNK * i, CHUNKED_LEN)
                      for i in range(1, len(chunk_steps) + 1)]
    if len(chunk_steps) != math.ceil(CHUNKED_LEN / PREFILL_CHUNK) \
            or [c["prefilled"] for c in chunk_steps] != want_prefilled \
            or any(c["decoding_emitted"] != 1 for c in chunk_steps):
        failures.append(f"serve_cache chunked prefill: {chunk_steps}")
    if len(b_waves) != 2:
        failures.append(f"serve_cache: B sampled {len(b_waves)} waves")
    else:
        checks.append(check_logits(b, params, long_prompt, b_waves[-1][0],
                                   long_req.out[0], "last chunk", failures))
    outs = run_timed(b)[0]
    check_tokens(outs, [rid_l], "chunked", cfg.vocab_size, failures)
    timings["chunk_step_ms"] = [c["ms"] for c in chunk_steps]

    # P/D: prefill_only on A (a miss), decode_from on B (a miss); then a
    # prompt sharing the first one's 16 leading pages hits on both sides.
    pd_prompt = toks(PD_LEN)
    pd = []
    pd_before = (a.prefix_cache_stats(), b.prefix_cache_stats())
    for prompt in (pd_prompt, pd_prompt[:SHARED_PREFIX] + toks(300)):
        t0 = time.perf_counter()
        blob, first = a.prefill_only(prompt, sp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = b.decode_from(blob, first, sp, prompt_tokens=prompt)
        pd.append(dict(prompt_len=len(prompt), first=first, out=out,
                       prefill_only_ms=(t1 - t0) * 1e3,
                       decode_from_s=time.perf_counter() - t1,
                       first_is_argmax=first == int(a_waves[-1][0].argmax())))
        if len(out) != MAX_TOKENS or out[0] != first \
                or not pd[-1]["first_is_argmax"] \
                or not all(0 <= t < cfg.vocab_size for t in out):
            failures.append(f"serve_cache P/D: {pd[-1]}")
    prefills["pd"] = 1
    pd_hits = [e.prefix_cache_stats()["hits"] - s["hits"]
               for e, s in zip((a, b), pd_before)]
    if pd_hits != [1, 1]:
        failures.append(f"serve_cache P/D hits on (A, B): {pd_hits}")

    # Demotion on A. Its cache is emptied first without the hook: every
    # entry of an N-page prompt copies pages 1..k, at 8 MiB a page.
    while a._cache.evict_lru(a._decref):
        pass
    demoted = toks(DEMOTED_LEN)
    usable = (DEMOTED_LEN - 1) // a.page
    runs = []
    for run in ("miss", "resident_hit", "promoted"):
        if run == "promoted":
            while a._cache.evict_lru(a._decref, a._demote_entry):
                pass
            timings["demoted"] = a.prefix_cache_stats()
        before = a.prefix_cache_stats()
        rid = a.add_request(demoted, sp)
        req = a._requests[rid]
        outs, first_ms, step_ms = run_timed(a)
        after = a.prefix_cache_stats()
        runs.append(dict(run=run, out=outs.get(rid), ttft_ms=first_ms[rid],
                         decode_step_ms=float(np.median(step_ms[1:])),
                         prefix_len=req.prefix_len,
                         hits=after["hits"] - before["hits"],
                         hit_pages=after["hit_pages"] - before["hit_pages"],
                         promoted_pages=(after["promoted_pages"]
                                         - before["promoted_pages"])))
    prefills["demotion"] = 1
    check_tokens({r["run"]: r["out"] for r in runs},
                 [r["run"] for r in runs], "demotion", cfg.vocab_size,
                 failures)
    miss, hit, promoted = runs
    if (miss["hits"], hit["hits"], promoted["hits"]) != (0, 1, 1) \
            or hit["prefix_len"] != usable * a.page \
            or promoted["prefix_len"] != usable * a.page \
            or promoted["promoted_pages"] != usable \
            or hit["promoted_pages"] != 0:
        failures.append(f"serve_cache demotion: {runs}")
    if promoted["out"] != hit["out"]:
        failures.append(f"serve_cache: promoted tokens {promoted['out']} "
                        f"!= resident hit's {hit['out']}")
    # The pieces of those first steps again, warm: the miss's full prefill
    # and the hit's suffix prefill against the cached pages.
    row = np.zeros(a.pages_per_slot, np.int64)
    row[:usable] = a._cache._entries[a._cache._keys(demoted, usable)[-1]]
    with uncounted(), torch.no_grad():
        timings["demoted_full_prefill_ms"] = host_ms(
            lambda: a._run_prefill(demoted))
        timings["demoted_suffix_prefill_ms"] = host_ms(
            lambda: a._run_suffix(demoted, usable * a.page, row))
        timings["profiled"]["demoted_suffix_prefill"] = profiled(
            lambda: a._run_suffix(demoted, usable * a.page, row))

    # Cancellation: mid-decode on A, mid-chunked-prefill on B.
    rid_d = a.add_request(toks(200), sp)
    a.step()
    a.step()
    rid_c = b.add_request(toks(CHUNKED_LEN), sp)
    b.step()
    mid = dict(decoding=len(a._requests[rid_d].out),
               prefilled=b._requests[rid_c].prefilled)
    cancelled = [a.cancel_request(rid_d), b.cancel_request(rid_c)]
    prefills["cancel"] = 2                 # A's prefill, B's first chunk
    pages = {}
    for name, eng in (("A", a), ("B", b)):
        while eng._cache.evict_lru(eng._decref):
            pass
        st = eng.prefix_cache_stats()
        pages[name] = dict(free=eng.kv_pages_free(),
                           allocated=st["allocated_pages"],
                           total=eng.kv_pages_total,
                           unfinished=eng.has_unfinished())
        if st["allocated_pages"] or eng.has_unfinished() \
                or eng.kv_pages_free() + st["allocated_pages"] \
                != eng.kv_pages_total:
            failures.append(f"serve_cache: pages after cancellation on "
                            f"{name}: {pages[name]}")
    # A's request took its first token and two decode steps' tokens.
    if cancelled != [True, True] or mid != dict(decoding=3,
                                                prefilled=PREFILL_CHUNK):
        failures.append(f"serve_cache cancellation: {cancelled}, {mid}")

    launches = flash_attention_fwd.launches
    want_launches = cfg.num_layers * sum(prefills.values())
    if launches != want_launches:
        failures.append(f"flash kernel launched {launches} times on the "
                        f"serve_cache path, expected {want_launches} "
                        f"({cfg.num_layers} x {prefills})")
    timings.update(ttft_miss_ms=miss["ttft_ms"], ttft_hit_ms=hit["ttft_ms"],
                   ttft_promoted_ms=promoted["ttft_ms"])
    res = dict(
        phase="serve_cache", preset="8b-gqa", engine=SERVE_ENGINE,
        prefix_cache=True, prefill_chunk=PREFILL_CHUNK,
        shared_prefix=SHARED_PREFIX, hit_suffixes=list(HIT_SUFFIXES),
        hit_stats=hit_stats, flash_launches=launches,
        expected_launches=want_launches, prefills=prefills,
        logits=checks, logits_rel_tol=LOGITS_REL_TOL,
        chunk_steps=chunk_steps,
        pd=[{k: v for k, v in e.items() if k != "out"} for e in pd],
        pd_hits=pd_hits,
        demotion=[{k: v for k, v in r.items() if k != "out"} for r in runs],
        promoted_tokens_equal=promoted["out"] == hit["out"],
        cancellation=dict(cancelled=cancelled, mid=mid, pages=pages),
        timings=timings, seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pinned(part: dict) -> dict:
    """A KV part copied to pinned host memory. The copies are synchronous,
    so the part is complete when this returns, on whatever thread."""
    def pin(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return {"k": pin(part["k"]), "v": pin(part["v"]), "len": part["len"]}


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def span_summary(rows) -> dict:
    """Per span name: its count and median dur_us."""
    by = {}
    for r in rows:
        by.setdefault(r["name"], []).append(r["dur_us"])
    return {n: dict(count=len(d), median_dur_us=float(np.median(d)))
            for n, d in sorted(by.items())}


def paged_gather_failure(cfg, params, pre, publish, host_parts,
                         failures: list) -> dict:
    """A paged request on an engine with a window of 1 loses its parts'
    holder after FAIL_AFTER_STEPS steps: it must retire typed while a pool
    request beside it finishes, and leave every page and window slot
    free."""
    rng = np.random.default_rng(3)
    handoff = pre.prefill_paged(rng.integers(0, cfg.vocab_size,
                                             FAIL_LEN).tolist(),
                                span=FAIL_SPAN, publish=publish)
    alive = [True]

    def fetch(handle):
        if not alive[0]:
            raise ConnectionError("the KV parts' holder is gone")
        return host_parts[handle]

    eng = LLMEngine(cfg, params, device="cuda", max_batch=2,
                    kv_gather_window=1, kv_fetch=fetch, **PAGED_ENGINE)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    before = flash_attention_fwd.launches
    rid = eng.add_paged_request(handoff["parts"], handoff["len"],
                                handoff["first"], sp)
    other = eng.add_request(rng.integers(0, cfg.vocab_size,
                                         FAIL_POOL_LEN).tolist(), sp)
    for _ in range(FAIL_AFTER_STEPS):
        eng.step()
    alive[0] = False
    finished = {}
    while eng.has_unfinished():
        for req in eng.step():
            finished[req.req_id] = req
    paged, pool = finished.get(rid), finished.get(other)
    st = eng.kv_gather_stats()
    res = dict(parts=len(handoff["parts"]),
               paged_tokens=len(paged.out) if paged else None,
               finish_reason=paged.finish_reason if paged else None,
               error=repr(paged.error) if paged else None,
               cause=repr(paged.error.__cause__)
               if paged and paged.error else None,
               pool_tokens=len(pool.out) if pool else None,
               pool_finish_reason=pool.finish_reason if pool else None,
               free_pages=eng.kv_pages_free(), total_pages=eng.kv_pages_total,
               live_requests=len(eng._requests), gather=st,
               pool_prefill_launches=flash_attention_fwd.launches - before)
    ok = (paged is not None and paged.finish_reason == "error"
          and isinstance(paged.error, KVGatherError)
          and isinstance(paged.error.__cause__, ConnectionError)
          and pool is not None and len(pool.out) == MAX_TOKENS
          and all(0 <= t < cfg.vocab_size for t in pool.out)
          and res["free_pages"] == res["total_pages"]
          and not res["live_requests"] and st["resident"] == 0
          and res["pool_prefill_launches"] == cfg.num_layers)
    if not ok:
        failures.append(f"serve_paged gather failure: {res}")
    res["ok"] = ok
    del eng
    return res


def serve_paged_phase(card: str, failures: list, params) -> dict:
    """Paged external requests on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               PAGED_LEN).tolist()
    host_parts = {}
    names = itertools.count()

    def publish(part):
        handle = f"part{next(names)}"
        host_parts[handle] = pinned(part)
        return handle

    # The prefilling engine's window holds every part it makes: a pipelined
    # prefill reads an evicted part through its unresolved handle and fails,
    # as in the JAX engine.
    pre = LLMEngine(cfg, params, device="cuda", max_batch=1, kv_pages=1,
                    kv_gather_window=PAGED_WINDOW, **PAGED_ENGINE)
    dec = LLMEngine(cfg, params, device="cuda", max_batch=2,
                    kv_gather_window=PAGED_WINDOW,
                    kv_fetch=host_parts.__getitem__, **PAGED_ENGINE)
    pre_waves, dec_waves = keep_sampled_logits(pre), keep_sampled_logits(dec)
    step_ms = timed_steps(dec)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    with captured_spans() as rec:
        t0 = time.perf_counter()
        handoff = pre.prefill_paged(prompt, sp, span=PAGED_SPAN,
                                    publish=publish, pipeline=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out = dec.decode_paged(handoff, sp)
        # The request rows; the engine's own engine:step rows are not
        # what this path is checked on.
        rows = [r for r in rec.drain() if r["cat"] == "request"]
    launches = flash_attention_fwd.launches
    gather = dec.kv_gather_stats()
    spans = span_summary(rows)
    part_bytes = sum(p["k"].nbytes + p["v"].nbytes
                     for p in host_parts.values())

    if launches:
        failures.append(f"flash kernel launched {launches} times on the "
                        f"serve_paged path, expected 0")
    spans_by_kind = dict(
        prefill_gather=sum(r["name"] == "sp:gather"
                           and r.get("args", {}).get("prefill_chunk", False)
                           for r in rows),
        decode_gather=sum(r["name"] == "sp:gather"
                          and not r["args"].get("prefill_chunk", False)
                          and r["args"].get("parts") == len(handoff["parts"])
                          for r in rows),
        sample_sync=spans.get("sample_sync", {}).get("count", 0),
        decode=spans.get("decode", {}).get("count", 0))
    want_spans = dict(prefill_gather=6, decode_gather=MAX_TOKENS - 1,
                      sample_sync=MAX_TOKENS, decode=0)
    if spans_by_kind != want_spans or len(rows) != sum(want_spans.values()):
        failures.append(f"serve_paged spans: {spans_by_kind} of "
                        f"{len(rows)} rows, expected {want_spans}")
    spans_of_parts = [p["span"] for p in handoff["parts"]]
    want_parts = [(s0, min(s0 + PAGED_SPAN, PAGED_LEN))
                  for s0 in range(0, PAGED_LEN, PAGED_SPAN)]
    if spans_of_parts != want_parts or handoff["len"] != PAGED_LEN \
            or dec.max_len >= PAGED_LEN:
        failures.append(f"serve_paged handoff: {spans_of_parts}")
    accounting = dict(gather=gather, part_bytes=part_bytes,
                      free_pages=dec.kv_pages_free(),
                      total_pages=dec.kv_pages_total)
    if (gather["fetches"], gather["refetches"], gather["bytes"],
            gather["resident"]) != (len(want_parts), 0, part_bytes, 0) \
            or dec.kv_pages_free() != dec.kv_pages_total:
        failures.append(f"serve_paged accounting: {accounting}")
    if len(out) != MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                         for t in out):
        failures.append(f"serve_paged returned {out}")

    # The prefill's last-token logits against an uncached forward() through
    # the flash kernel; the noise floor is plain attention against it.
    flash_cfg = dataclasses.replace(cfg, attention_impl="flash")
    with uncounted(), torch.no_grad():
        ref = forward(params, torch.tensor([prompt]), flash_cfg,
                      device="cuda")[0, -1]
        plain = forward(params, torch.tensor([prompt]), cfg,
                        device="cuda")[0, -1]
        # Each decode step's logits against one teacher-forced forward over
        # the prompt and the emitted tokens, at positions 3000..3014.
        forced = forward(params, torch.tensor([prompt + out[:-1]]),
                         flash_cfg, device="cuda")[0, PAGED_LEN - 1:]
    prefill_logits = pre_waves[-1][0]
    prefill_check = dict(
        logits_rel_err=rel_err(prefill_logits, ref),
        noise_rel_err=rel_err(plain, ref),
        first_token_ok=handoff["first"] == int(ref.argmax()) == out[0])
    if not (prefill_check["logits_rel_err"] < LOGITS_REL_TOL
            and prefill_check["first_token_ok"]
            and bool(torch.isfinite(prefill_logits).all())):
        failures.append(f"serve_paged prefill logits: {prefill_check}")
    step_errs = [rel_err(w[0], forced[i + 1])
                 for i, w in enumerate(dec_waves)]
    if len(step_errs) != MAX_TOKENS - 1 \
            or not all(e < LOGITS_REL_TOL for e in step_errs) \
            or not all(bool(torch.isfinite(w[0]).all()) for w in dec_waves):
        failures.append(f"serve_paged decode logits: {step_errs}")
    argmax_equal = sum(int(forced[i].argmax()) == t
                       for i, t in enumerate(out))

    # One paged decode step under the profiler: a second request on the same
    # parts; its first step (admission and the part uploads) and the
    # profiler's warm-up step go unprofiled, its last step is profiled.
    with uncounted():
        dec.add_paged_request(handoff["parts"], handoff["len"],
                              handoff["first"], SamplingParams(max_tokens=4))
        dec.step()
        step_profile = profiled(dec.step)
        while dec.has_unfinished():
            dec.step()
        failure = paged_gather_failure(cfg, params, pre, publish, host_parts,
                                       failures)

    res = dict(
        phase="serve_paged", preset="8b-gqa", context=PAGED_LEN,
        span=PAGED_SPAN, engine=PAGED_ENGINE, window=PAGED_WINDOW,
        parts=len(handoff["parts"]), part_mib=part_bytes
        / len(want_parts) / 2 ** 20, flash_launches=launches,
        prefill_paged_ms=prefill_ms,
        decode_step_ms=step_ms[:len(out) - 1],
        decode_step_median_ms=float(np.median(step_ms[:len(out) - 1])),
        prefill_logits=prefill_check, decode_logits_rel_err=step_errs,
        argmax_equal=f"{argmax_equal} of {len(out)}",
        logits_rel_tol=LOGITS_REL_TOL, accounting=accounting, spans=spans,
        spans_by_kind=spans_by_kind, profiled_decode_step=step_profile,
        gather_failure=failure, seconds=time.perf_counter() - t_phase,
        card=card)
    emit(res)
    del pre, dec, host_parts, forced, ref, plain
    gc.collect()
    torch.cuda.empty_cache()
    return res


class TickProbe:
    """Host times around one replica's decode loop, in ms: each engine step
    (run on an executor thread), the wait from a step's return to its
    fan-out on the event loop (the loop's turn, behind whatever holds the
    GIL), and the instants at which requests took the engine lock (its
    ``_maybe_shed`` runs first under the lock)."""

    def __init__(self, er):
        self.steps, self.fan_waits, self.locked = [], [], []
        step, fan_out, shed = er.engine.step, er._fan_out, er._maybe_shed
        t_end = [0.0]

        def timed_step():
            t0 = time.perf_counter()
            done = step()
            t_end[0] = time.perf_counter()
            self.steps.append((t_end[0] - t0) * 1e3)
            return done

        def timed_fan_out(events, done):
            self.fan_waits.append((time.perf_counter() - t_end[0]) * 1e3)
            return fan_out(events, done)

        def timed_shed(deadline):
            self.locked.append(time.perf_counter())
            return shed(deadline)

        er.engine.step = timed_step
        er._fan_out = timed_fan_out
        er._maybe_shed = timed_shed

    def summary(self) -> dict:
        def stats(xs):
            return (dict(n=len(xs), median=float(np.median(xs)),
                         max=float(max(xs))) if xs else None)
        return dict(step_ms=stats(self.steps),
                    fan_out_wait_ms=stats(self.fan_waits))


async def timed_stream(er, prompt, opts=None, *, take=None,
                       delay: float = 0.0) -> dict:
    """One request through ``er.stream_generate``: its tokens, finish
    reason, submit time and each token's arrival (host clock). ``take``
    abandons the stream after that many tokens."""
    if delay:
        await asyncio.sleep(delay)
    toks, reason, stamps = [], None, []
    t_sub = time.perf_counter()
    gen = er.stream_generate(prompt, opts)
    try:
        async for item in gen:
            if isinstance(item, dict):
                reason = item["finish_reason"]
                break
            stamps.append(time.perf_counter())
            toks.append(item)
            if take and len(toks) >= take:
                break
    finally:
        await gen.aclose()
    return dict(tokens=toks, finish=reason, t_sub=t_sub, stamps=stamps)


def latency(r: dict) -> dict:
    """A timed_stream's TTFT and inter-token gaps, ms."""
    st = r["stamps"]
    return dict(ttft_ms=(st[0] - r["t_sub"]) * 1e3 if st else None,
                itl_ms=[(b - a) * 1e3 for a, b in zip(st, st[1:])])


def request_held_pages(eng) -> int:
    """Pool page references held by requests, beyond the prefix cache's
    own entries: 0 means every page is free or only cached, -1 that the
    free list and the allocated pages do not make up the pool."""
    cached = collections.Counter(
        p for pages in (eng._cache._entries.values() if eng._cache else ())
        for p in pages)
    held = sum(n - cached[p] for p, n in eng._page_refs.items())
    if eng.kv_pages_free() + len(eng._page_refs) != eng.kv_pages_total:
        return -1
    return held


def divergence(params, cfg, prompt, got, want) -> dict:
    """Where two greedy token lists part, and the top-2 logit margin there
    of a plain-attention forward() over the prompt and the agreed
    tokens."""
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    with uncounted(), torch.no_grad():
        logits = forward(params, torch.tensor([prompt + want[:i]]), cfg,
                         device="cuda")[0, -1].float()
    top = logits.topk(2).values
    return dict(step=i, got=got[i:i + 1], want=want[i:i + 1],
                top2_margin=(top[0] - top[1]).item())


class FailingFetch:
    """A KV-part fetch that raises ConnectionError from its ``fail_at``-th
    call on (the gather pool calls it from two threads)."""

    def __init__(self, parts: dict, fail_at: int):
        self.parts, self.fail_at = parts, fail_at
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, handle):
        with self._lock:
            self.calls += 1
            if self.calls >= self.fail_at:
                raise ConnectionError("the KV parts' holder is gone")
        return self.parts[handle]


def serve_replica_phase(card: str, failures: list, params) -> dict:
    """EngineReplica on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def fail(what, detail):
        failures.append(f"serve_replica {what}: {detail}")

    bridge = Hosted()
    R = EngineReplica(cfg, params, device="cuda", **REPLICA)
    ref = LLMEngine(cfg, params, device="cuda",
                    **{k: v for k, v in REPLICA.items() if k != "max_tokens"})
    probe = TickProbe(R)
    launches = {}
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0

    def counted(section, want_prefills):
        launches[section] = dict(got=flash_attention_fwd.launches,
                                 want=want_prefills * cfg.num_layers)
        flash_attention_fwd.launches = 0

    # Parity: one request at a time through generate, against the
    # closed-loop engine of the same shape on the same params.
    prompts = [toks(n) for n in PROMPT_LENS]
    parity = []
    for p in prompts:
        t0 = time.perf_counter()
        parity.append(bridge.call(R.generate(p)))
        parity[-1]["ms"] = (time.perf_counter() - t0) * 1e3
    counted("parity", len(prompts))
    want, ref_ms = [], []
    with uncounted():
        for p in prompts:
            t0 = time.perf_counter()
            want.append(ref.generate([p], sp)[0])
            ref_ms.append((time.perf_counter() - t0) * 1e3)
    for p, r, w in zip(prompts, parity, want):
        if r["tokens"] != w or r["finish_reason"] != "length":
            fail("parity", dict(prompt_len=len(p), finish=r["finish_reason"],
                                **divergence(params, cfg, p, r["tokens"],
                                             w)))

    # Concurrency: eight staggered streams, one abandoned.
    hits_before = R.engine.prefix_cache_stats()["hits"]
    hit_prefix = prompts[2][:STREAM_HIT_PREFIX]
    streams = ([hit_prefix + toks(STREAM_HIT_SUFFIX) for _ in range(2)]
               + [toks(n) for n in STREAM_LENS])
    probe.locked.clear()

    async def concurrent():
        return await asyncio.gather(*[
            timed_stream(R, p, delay=i * STREAM_GAP_S,
                         take=ABANDON_AFTER if i == ABANDON_AT else None)
            for i, p in enumerate(streams)])
    with captured_spans() as rec:
        conc = bridge.call(concurrent())
        bridge.call(asyncio.sleep(0.2))
        rows = rec.drain()
    counted("concurrency", len(streams) - 2)
    st = bridge.call(R.debug_stats())
    admits = [r for r in rows if r["name"] == "request:admit"]
    cancels = [r for r in rows if r["name"] == "request:cancelled"]
    lock_waits = [(a - r["t_sub"]) * 1e3 for a, r in
                  zip(sorted(probe.locked),
                      sorted(conc, key=lambda r: r["t_sub"]))]
    conc_ok = (st["max_active"] >= 2 and st["cancelled"] == 1
               and st["prefix_cache"]["hits"] - hits_before == 2
               and request_held_pages(R.engine) == 0
               and st["active"] == st["queue_depth"] == 0
               and len(admits) == len(streams) and len(cancels) == 1
               and all(len(r["tokens"]) == (ABANDON_AFTER if i == ABANDON_AT
                                            else MAX_TOKENS)
                       and all(0 <= t < cfg.vocab_size for t in r["tokens"])
                       for i, r in enumerate(conc)))
    concurrency = dict(
        streams=[dict(prompt_len=len(p), tokens=len(r["tokens"]),
                      finish=r["finish"], **latency(r))
                 for p, r in zip(streams, conc)],
        lock_wait_ms=lock_waits, max_active=st["max_active"],
        cancelled=st["cancelled"], admit_spans=len(admits),
        admit_args=[r["args"] for r in admits],
        cancel_instants=len(cancels),
        hits=st["prefix_cache"]["hits"] - hits_before,
        request_held_pages=request_held_pages(R.engine))
    if not conc_ok:
        fail("concurrency", {k: v for k, v in concurrency.items()
                             if k != "streams"})

    # Shedding and a queued deadline on a second replica.
    S = EngineReplica(cfg, params, device="cuda", max_batch=2,
                      max_len=REPLICA["max_len"], page_size=64,
                      prefix_cache=False, max_queue=2,
                      max_tokens=MAX_TOKENS,
                      kv_pages=math.ceil((DEADLINE_LONG_LEN
                                          + DEADLINE_LONG_TOKENS + 1) / 64))

    async def shed_and_deadline():
        out = await asyncio.gather(
            *[timed_stream(S, toks(SHED_LEN)) for _ in range(SHED_N)],
            return_exceptions=True)
        long_task = asyncio.ensure_future(timed_stream(
            S, toks(DEADLINE_LONG_LEN),
            {"max_tokens": DEADLINE_LONG_TOKENS}))
        # Once its admitting tick has fanned out (a decode tick, ~70 ms,
        # is the most the late request then waits for the lock).
        while not any(m["admitted"] for m in S._meta.values()):
            await asyncio.sleep(0.005)
        full = S.engine.kv_pages_free()
        tok = deadlines.set_current(time.time() + DEADLINE_S)
        try:
            late = await timed_stream(S, toks(SHED_LEN))
        except DeadlineExceededError as e:
            late = e
        finally:
            deadlines.reset(tok)
        return out, await long_task, full, late
    shed_out, long_run, free_when_full, late = bridge.call(
        shed_and_deadline())
    counted("shed_deadline", 2 + 1)
    sst = bridge.call(S.debug_stats())
    raised = [e for e in shed_out if isinstance(e, OverloadedError)]
    served = [r for r in shed_out if isinstance(r, dict)]
    shedding = dict(
        offered=SHED_N, shed_raised=len(raised), shed=sst["shed"],
        retry_after_s=[e.retry_after_s for e in raised],
        messages=sorted({str(e) for e in raised}), served=len(served),
        deadline_error=repr(late), expired=sst["expired"],
        pages_free_while_full=free_when_full,
        long_tokens=len(long_run["tokens"]),
        pages_free_after=sst["kv_pages_free"],
        pages_total=sst["kv_pages_total"])
    if not (len(raised) == sst["shed"] == SHED_N - 2 and len(served) == 2
            and len(raised) + len(served) == SHED_N
            and all(e.retry_after_s > 0 for e in raised)
            and isinstance(late, DeadlineExceededError)
            and str(late) == "deadline exceeded in serving admission queue"
            and sst["expired"] == 1
            and free_when_full == 0
            and long_run["finish"] == "length"
            and len(long_run["tokens"]) == DEADLINE_LONG_TOKENS
            and sst["kv_pages_free"] == sst["kv_pages_total"]
            and sst["active"] == sst["queue_depth"] == 0):
        fail("shedding", shedding)

    # P/D and paged handoffs between replicas P and D.
    P = EngineReplica(cfg, params, device="cuda", **REPLICA)
    D = EngineReplica(cfg, params, device="cuda", **REPLICA)
    pd_prompt, pd_want = prompts[2], parity[2]["tokens"]
    handoff = bridge.call(P.prefill_handoff({"prompt": pd_prompt}))
    pd_tokens = bridge.call(D.decode_handoff(handoff))["tokens"]
    counted("pd", 1)
    if pd_tokens != pd_want:
        fail("P/D", divergence(params, cfg, pd_prompt, pd_tokens, pd_want))

    paged_prompt = toks(RPAGED_LEN)
    t0 = time.perf_counter()
    paged = bridge.call(P.prefill_paged_handoff(
        {"prompt": paged_prompt, "span": RPAGED_SPAN,
         "opts": {"max_tokens": RPAGED_TOKENS}}))
    torch.cuda.synchronize()
    paged_prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    paged_out = bridge.call(D.decode_paged(paged))
    paged_decode_ms = (time.perf_counter() - t0) * 1e3
    counted("paged", 0)
    dst = bridge.call(D.debug_stats())
    with uncounted():
        sp_paged = SamplingParams(max_tokens=RPAGED_TOKENS)
        eng_handoff = ref.prefill_paged(paged_prompt, sp_paged,
                                        span=RPAGED_SPAN)
        paged_want = ref.decode_paged(eng_handoff, sp_paged)
        if launches["paged"]["got"] or flash_attention_fwd.launches:
            fail("paged", "the engine-level paged path launched kernel 1")
    paged_res = dict(
        parts=[p["span"] for p in paged["parts"]], len=paged["len"],
        first=paged["first"], tokens_equal=paged_out["tokens"] == paged_want,
        finish=paged_out["finish_reason"], prefill_ms=paged_prefill_ms,
        decode_ms=paged_decode_ms, gather=dst["kv_gather"],
        window=D.engine._kv_window.capacity)
    if not (len(paged["parts"]) == 3 and paged["len"] == RPAGED_LEN
            and D.engine._kv_window.capacity >= 3
            and paged_out["tokens"] == paged_want
            and len(paged_want) == RPAGED_TOKENS
            and dst["kv_gather"]["refetches"] == 0
            and dst["kv_gather"]["resident"] == 0
            and request_held_pages(D.engine) == 0):
        fail("paged", dict(paged_res, got=paged_out["tokens"],
                           want=paged_want))

    # A gather failure mid-decode on a replica with a window of 1.
    small = bridge.call(P.prefill_paged_handoff(
        {"prompt": toks(FAIL_LEN), "span": FAIL_SPAN}))
    parts = {f"part{i}": p["handle"] for i, p in enumerate(small["parts"])}
    fetch = FailingFetch(parts, 2 * cfg.num_layers * 2 + 1)
    F = EngineReplica(cfg, params, device="cuda", max_batch=1,
                      kv_gather_window=1, kv_fetch=fetch,
                      max_tokens=MAX_TOKENS, **PAGED_ENGINE)
    broken_handoff = dict(small, parts=[
        {"span": p["span"], "handle": f"part{i}"}
        for i, p in enumerate(small["parts"])])
    with captured_spans() as rec:
        try:
            broken = bridge.call(F.decode_paged(broken_handoff))
        except StreamBrokenError as e:
            broken = e
        fst = bridge.call(F.debug_stats())
        kv_broken_rows = [r for r in rec.drain()
                          if r["name"] == "request:kv_broken"]
    counted("kv_failure", 0)
    failure = dict(error=repr(broken), fetch_calls=fetch.calls,
                   tokens_emitted=getattr(broken, "tokens_emitted", None),
                   cause=repr(getattr(broken, "__cause__", None)),
                   kv_broken=fst["kv_broken"],
                   kv_broken_instants=len(kv_broken_rows),
                   pages_free=fst["kv_pages_free"],
                   pages_total=fst["kv_pages_total"],
                   resident=fst["kv_gather"]["resident"])
    if not (isinstance(broken, StreamBrokenError)
            and broken.tokens_emitted > 0
            and isinstance(broken.__cause__, KVGatherError)
            and fst["kv_broken"] == 1 and len(kv_broken_rows) == 1
            and fst["kv_pages_free"] == fst["kv_pages_total"]
            and fst["kv_gather"]["resident"] == 0 and fst["active"] == 0):
        fail("KV failure", failure)

    # The open loop over R through the bridge.
    open_prompts = [toks(OPEN_LOOP_LEN)
                    for _ in range(int(OPEN_LOOP_RATE * OPEN_LOOP_S))]
    probe.steps.clear()
    probe.fan_waits.clear()
    report = run_open_loop(
        lambda p: bridge.stream(R.stream_generate(p)),
        rate_hz=OPEN_LOOP_RATE, duration_s=OPEN_LOOP_S,
        prompt_fn=open_prompts.__getitem__, request_timeout_s=300.0)
    counted("open_loop", len(open_prompts))
    open_loop_ticks = probe.summary()
    if not (report["completed"] == report["offered"] == len(open_prompts)
            and report["shed"] == report["broken"] == 0
            and not report["errors"] and report["unfinished"] == 0
            and report["tokens_total"] == len(open_prompts) * MAX_TOKENS):
        fail("open loop", report)

    for section, n in launches.items():
        if n["got"] != n["want"]:
            fail("kernel 1 launches", f"{section}: {n}")
    stats = bridge.call(R.debug_stats())
    res = dict(
        phase="serve_replica", preset="8b-gqa", replica=REPLICA,
        parity=[dict(prompt_len=len(p), tokens_equal=r["tokens"] == w,
                     generate_ms=r["ms"], closed_loop_ms=t)
                for p, r, w, t in zip(prompts, parity, want, ref_ms)],
        concurrency=concurrency, shedding=shedding,
        pd=dict(prompt_len=len(pd_prompt), tokens_equal=pd_tokens == pd_want),
        paged=paged_res, kv_failure=failure,
        open_loop={k: v for k, v in report.items() if k != "errors"},
        # What the schedule offers: tokens_per_s cannot exceed it, and
        # the p99s of 8 requests are their maxima.
        open_loop_offered_tokens_per_s=OPEN_LOOP_RATE * MAX_TOKENS,
        open_loop_ticks=open_loop_ticks, flash_launches=sum(
            n["got"] for n in launches.values()),
        launches_by_section=launches,
        replica_stats={k: stats[k] for k in ("ticks", "max_active",
                                              "completed", "cancelled",
                                              "tokens_out")},
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    bridge.shutdown()
    del R, S, P, D, F, ref, parts, small, handoff, paged
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sp_check(logits, first: int, ref, noise, flash, what: str,
             failures: list, phase: str = "serve_sp",
             base: str = "sp1") -> dict:
    """An SP prefill's last-token logits against forward() with plain
    attention (the serve phase's gate) and its first greedy token against
    their argmax. Where the reference's own top-2 margin is below its noise
    floor (max |noise - ref|: the plain path against itself on the padded
    prompt), two bf16 orderings of one model may pick either token, so the
    token must be one the reference scores within that floor of its top;
    otherwise it must be the argmax. Both margins are printed, and beside
    them how the sp=1 prefill (kernel 1) of the same prompt fares against
    the same reference (``base`` names it, ``phase`` the phase)."""
    scale = ref.abs().max()
    top2 = ref.topk(2).values
    noise_abs = (noise - ref).abs().max().item()
    gap = (ref.max() - ref[first]).item()
    res = dict(what=what,
               logits_rel_err=((logits - ref).abs().max() / scale).item(),
               noise_rel_err=noise_abs / scale.item(),
               ref_top2_margin=(top2[0] - top2[1]).item(),
               noise_abs=noise_abs, first_token_gap=gap,
               first_is_argmax=first == int(ref.argmax()),
               first_token_ok=(first == int(ref.argmax())
                               or gap <= noise_abs),
               finite=bool(torch.isfinite(logits).all()),
               **{f"{base}_rel_err": ((flash - ref).abs().max()
                                      / scale).item(),
                  f"{base}_first_is_argmax": (int(flash.argmax())
                                              == int(ref.argmax()))})
    if not (res["logits_rel_err"] < LOGITS_REL_TOL and res["first_token_ok"]
            and res["finite"]):
        failures.append(f"{phase} logits mismatch: {res}")
    return res


def serve_sp_run(cfg, params, devices, strategy, prompts, hit_prompt,
                 refs, sp1_ms, failures) -> dict:
    """One SP engine over ``devices``: the two prompts as one admission
    wave, then the hit; the checks of the module docstring."""
    t_run = time.perf_counter()
    n = len(devices)
    what = f"sp={n} {strategy} on {sorted(set(map(str, devices)))}"
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(cfg, params, device="cuda", sp_strategy=strategy,
                    mesh=build_mesh(MeshSpec(sp=n), devices=devices),
                    **SP_ENGINE)
    waves = keep_sampled_logits(eng)
    home = params["embed"].device
    mine, theirs = (dict(_named_leaves(t))
                    for t in (eng._sp_params[home], params))
    same_ptr = mine.keys() == theirs.keys() and all(
        t.data_ptr() == theirs[k].data_ptr() for k, t in mine.items())
    if eng.sp_degree != n or not same_ptr \
            or list(eng._sp_params) != list(dict.fromkeys(devices)):
        failures.append(f"serve_sp {what}: degree {eng.sp_degree}, "
                        f"weights at their data_ptr {same_ptr}, replicas "
                        f"on {list(eng._sp_params)}")
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    stripes = []

    def serve(batch):
        """Admit ``batch`` in one step, read each request's stripes against
        the new pages its prompt took, then step until idle."""
        ids = [eng.add_request(p, sp) for p in batch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        admit_ms = (time.perf_counter() - t0) * 1e3
        for rid, p in zip(ids, batch):
            req = eng._requests[rid]
            new = math.ceil((len(p) - req.prefix_len) / eng.page)
            got = [q for s in (req.sp_stripes or []) for q in s]
            stripes.append(dict(prompt_len=len(p), prefix_len=req.prefix_len,
                                pages_per_shard=[len(s) for s in
                                                 req.sp_stripes or []],
                                ok=(got == req.pages[:new]
                                    and len(req.sp_stripes) == n)))
        outs = run_timed(eng)[0]
        for rid in ids:
            out = outs.get(rid, [])
            if len(out) != MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                                 for t in out):
                failures.append(f"serve_sp {what}: request {rid} "
                                f"returned {out}")
        return [outs.get(rid, [-1]) for rid in ids], admit_ms

    outs, wave_ms = serve(prompts)
    before = eng.prefix_cache_stats()
    hit_out, hit_ms = serve([hit_prompt])
    after = eng.prefix_cache_stats()
    launches = flash_attention_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hit = dict(hits=after["hits"] - before["hits"],
               hit_pages=after["hit_pages"] - before["hit_pages"])
    if hit != dict(hits=1, hit_pages=SP_HIT_PREFIX // eng.page) \
            or stripes[-1]["prefix_len"] != SP_HIT_PREFIX:
        failures.append(f"serve_sp {what} hit: {hit}, {stripes[-1]}")
    if not all(s["ok"] for s in stripes):
        failures.append(f"serve_sp {what} stripes: {stripes}")
    if launches:
        failures.append(f"serve_sp {what}: kernel 1 launched {launches} "
                        f"times in SP prefills, expected 0")
    checks = []
    if [len(w) for w in waves] != [len(prompts), 1]:
        failures.append(f"serve_sp {what}: admission waves "
                        f"{[len(w) for w in waves]}")
    else:
        for p, logits, out, ref in zip(prompts + [hit_prompt],
                                       waves[0] + waves[1], outs + hit_out,
                                       refs):
            checks.append(dict(sp_check(logits, out[0], *ref, what,
                                        failures), prompt_len=len(p)))
    timings = dict(serve_s=time.perf_counter() - t_run)
    with torch.no_grad():
        for p in prompts:
            timings[len(p)] = dict(sp_prefill_ms=host_ms(
                lambda: eng._run_prefill(p), iters=1),
                sp1_prefill_ms=sp1_ms[len(p)])
        row = np.zeros(eng.pages_per_slot, np.int64)
        n_shared = SP_HIT_PREFIX // eng.page
        row[:n_shared] = eng._cache._entries[
            eng._cache._keys(hit_prompt, n_shared)[-1]]
        timings["hit_suffix_sp_prefill_ms"] = host_ms(
            lambda: eng._run_suffix(hit_prompt, SP_HIT_PREFIX, row),
            iters=1)
        timings["timed_s"] = time.perf_counter() - t_run
        timings["profiled_sp_prefill"] = prof = profiled(
            lambda: eng._run_prefill(prompts[0]))
        if len(set(devices)) > 1:
            # The profile sums device time over the cards, which can
            # exceed the wall time: no one card's idle share.
            prof["idle_share"] = "not measured (several cards)"
    timings["run_s"] = time.perf_counter() - t_run
    res = dict(sp=n, strategy=strategy, devices=[str(d) for d in devices],
               flash_launches=launches, weights_not_copied=same_ptr,
               wave_admit_ms=wave_ms, hit_admit_ms=hit_ms, hit=hit,
               stripes=stripes, logits=checks, timings=timings,
               peak_memory_gb=peak_gb)
    del eng, waves
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_sp_phase(card: str, failures: list, params) -> dict:
    """Sequence-parallel prefill on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SP_PROMPT_LENS]
    hit_prompt = prompts[0][:SP_HIT_PREFIX] + rng.integers(
        0, cfg.vocab_size, SP_HIT_SUFFIX).tolist()
    # The sp=1 engine: the prefill beside which the SP prefill's time is
    # printed (its kernel 1 launches are not the SP path's), and the
    # buckets the noise floor pads to.
    base = LLMEngine(cfg, params, device="cuda",
                     **dict(SP_ENGINE, prefix_cache=False))
    with uncounted(), torch.no_grad():
        sp1_ms = {len(p): host_ms(lambda: base._run_prefill(p), iters=1)
                  for p in prompts}
        # Per prompt: the plain reference, its noise floor, and the sp=1
        # prefill's logits.
        pads = [base._bucket(len(p)) for p in prompts] + [
            SP_HIT_PREFIX + base._bucket(SP_HIT_SUFFIX)]
        refs = [(*plain_logits(params, cfg, p, pad), base._run_prefill(p)[0])
                for p, pad in zip(prompts + [hit_prompt], pads)]
    del base
    cuda0 = torch.device("cuda", 0)
    runs, layouts = [], []
    for n, strategy in SP_RUNS:
        grids = [[cuda0] * n]
        if torch.cuda.device_count() >= n:
            grids.append([torch.device("cuda", i) for i in range(n)])
        for devices in grids:
            layouts.append(dict(sp=n, strategy=strategy,
                                distinct=len(set(devices)) > 1))
            runs.append(serve_sp_run(cfg, params, devices, strategy, prompts,
                                     hit_prompt, refs, sp1_ms, failures))
    res = dict(phase="serve_sp", preset="8b-gqa", engine=SP_ENGINE,
               prompt_lens=list(SP_PROMPT_LENS),
               hit=dict(prefix=SP_HIT_PREFIX, suffix=SP_HIT_SUFFIX),
               device_count=torch.cuda.device_count(), ran=layouts,
               flash_launches=sum(r["flash_launches"] for r in runs),
               runs=runs, logits_rel_tol=LOGITS_REL_TOL,
               seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


@contextlib.contextmanager
def named_ranges(names: dict, owner=transformer):
    """Run every call of each ``models.transformer`` function named in
    ``names`` (or of ``owner``'s) inside a ``record_function`` range of
    the given name (the tp layer calls ``transformer.all_reduce``, which
    becomes ``tp:all_reduce``), so that a profile names their kernels
    apart. Only the calls made on the profiled thread fall in a range:
    the backward's kernels, which autograd launches from its own thread,
    do not."""
    real = {attr: getattr(owner, attr) for attr in names}

    def wrap(attr):
        def named(*args, **kwargs):
            with torch.profiler.record_function(names[attr]):
                return real[attr](*args, **kwargs)
        return named
    for attr in names:
        setattr(owner, attr, wrap(attr))
    try:
        yield
    finally:
        for attr, fn in real.items():
            setattr(owner, attr, fn)


@contextlib.contextmanager
def demoted_bytes_limit(limit: int):
    """The demotion tier's host window for engines built in the block
    (``RAY_TPU_kv_demoted_bytes_limit``); the setting is restored after."""
    name = "RAY_TPU_kv_demoted_bytes_limit"
    old = os.environ.get(name)
    os.environ[name] = str(int(limit))
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def tp_memory(shards, positions, mesh, pools, params, flat) -> dict:
    """Where a split engine's weights are and what they take: every
    position's tensors (``shards``, the mesh positions ``positions``) on
    the card; on each device, the distinct tensors' bytes equal to the
    distinct slices its positions' specs (the Megatron rules) give, so no
    slice is held twice on a device (on one card: the params' bytes); each
    replicated tensor on the params' device the params' own (same
    data_ptr); the positions' pools (``pools``, k and v) against the
    unsharded pool."""
    whole = dict(_named_leaves(params))
    specs = _dict_leaves(tree_specs(transformer.param_logical_axes(None),
                                    mesh, transformer.megatron_rules()))
    coords = mesh.coords()
    held, want, on_card, own = {}, {}, True, True
    for shard, i in zip(shards, positions):
        for name, t in _named_leaves(shard):
            on_card &= t.is_cuda
            held.setdefault(t.device, {})[id(t)] = t.nbytes
            sl = shard_slices(specs[name], whole[name].shape, mesh, coords[i])
            want.setdefault(t.device, {})[
                (name, tuple((x.start, x.stop) for x in sl))] = (
                math.prod(x.stop - x.start for x in sl)
                * whole[name].element_size())
            if t.shape == whole[name].shape \
                    and t.device == whole[name].device:
                own &= t.data_ptr() == whole[name].data_ptr()
    held = {str(d): sum(v.values()) for d, v in held.items()}
    want = {str(d): sum(v.values()) for d, v in want.items()}
    total = sum(t.nbytes for t in whole.values())
    pools = sum(t.nbytes for t in pools)
    flat_pool = sum(t.nbytes for t in flat._pk + flat._pv)
    ok = on_card and own and held == want and pools == flat_pool
    return dict(ok=ok, on_card=on_card, replicated_not_copied=own,
                params_gb=total / 1e9,
                held_gb={d: b / 1e9 for d, b in held.items()},
                expected_gb={d: b / 1e9 for d, b in want.items()},
                pools_gb=pools / 1e9, unsharded_pool_gb=flat_pool / 1e9)


def serve_tp_run(cfg, params, devices, prompts, hit_prompt, pd_fresh, refs,
                 flat, closed_prompts, failures) -> dict:
    """One tp engine over ``devices``: the wave, the prefix hit, P/D both
    ways, demotion and promotion, the closed loop the replica is held to;
    the checks and times of the module docstring."""
    t_run = time.perf_counter()
    n = len(devices)
    what = f"tp={n} on {sorted(set(map(str, devices)))}"
    L = cfg.num_layers
    sp = SamplingParams(max_tokens=MAX_TOKENS)

    def fail(section, detail):
        failures.append(f"serve_tp {what} {section}: {detail}")

    def tokens_ok(out, count=MAX_TOKENS):
        return len(out) == count and all(0 <= t < cfg.vocab_size
                                         for t in out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with demoted_bytes_limit(TP_DEMOTE_BYTES):
        eng = LLMEngine(cfg, params, device="cuda", mesh=build_mesh(
            MeshSpec(tp=n), devices=devices), **TP_ENGINE)
    sections_s = {}
    t_lap = [t_run]

    def lap(section):
        """Seconds since the last lap, under ``section``."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        sections_s[section] = now - t_lap[0]
        t_lap[0] = now
    lap("build")
    memory = tp_memory(eng._shards, range(n), eng.mesh, eng._pk + eng._pv,
                       params, flat)
    if eng.tp_degree != n or not memory["ok"]:
        fail("memory", memory)
    waves = keep_sampled_logits(eng)
    launches = {}

    def counted(section, full_prefills):
        launches[section] = dict(got=flash_attention_fwd.launches,
                                 want=full_prefills * L * n)
        flash_attention_fwd.launches = 0
        if launches[section]["got"] != launches[section]["want"]:
            fail("kernel 1 launches", launches)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0

    # The wave: the four prompts admitted in one step (4 full prefills,
    # and the step's decode); two decode steps of the four slots, the
    # second profiled; the rest timed.
    ids = [eng.add_request(p, sp) for p in prompts]
    eng.step()                  # admission, then one decode step
    firsts = {}
    for rid, tok, _ in eng.take_tick_events():
        firsts.setdefault(rid, tok)
    with named_ranges({"all_reduce": "tp:all_reduce"}):
        prof_decode = profiled(eng.step, ranges=("tp:all_reduce",))
    outs, _, step_ms = run_timed(eng)
    counted("wave", len(prompts))
    lap("wave")
    checks = []
    if [len(w) for w in waves] != [len(prompts)]:
        fail("admission waves", [len(w) for w in waves])
    else:
        for rid, p, logits, ref in zip(ids, prompts, waves[0], refs):
            checks.append(dict(sp_check(logits, firsts.get(rid, -1), *ref,
                                        what, failures, phase="serve_tp",
                                        base="unsharded"),
                               prompt_len=len(p)))
    for rid in ids:
        if not tokens_ok(outs.get(rid, [])) \
                or outs[rid][0] != firsts.get(rid):
            fail("tokens", (rid, outs.get(rid), firsts.get(rid)))

    # The prefix hit on the 1900-token prompt's 16 pages (suffix prefill),
    # then the same prompt again, a resident hit on all its 20 full pages.
    hits = []
    sp_hit = SamplingParams(max_tokens=TP_HIT_TOKENS)
    for run in ("hit", "resident"):
        before = eng.prefix_cache_stats()
        rid = eng.add_request(hit_prompt, sp_hit)
        req = eng._requests[rid]
        out = run_timed(eng)[0].get(rid, [])
        after = eng.prefix_cache_stats()
        hits.append(dict(run=run, out=out, prefix_len=req.prefix_len,
                         hits=after["hits"] - before["hits"],
                         hit_pages=after["hit_pages"] - before["hit_pages"]))
        if not tokens_ok(out, TP_HIT_TOKENS):
            fail(run, out)
    counted("hits", 0)
    lap("hits")
    usable = (len(hit_prompt) - 1) // eng.page
    if [(h["hits"], h["prefix_len"]) for h in hits] \
            != [(1, TP_HIT_PREFIX), (1, usable * eng.page)]:
        fail("hit counters", [{k: v for k, v in h.items() if k != "out"}
                              for h in hits])
    if len(waves) < 2:
        fail("hit logits", f"{len(waves)} waves sampled")
    else:
        with uncounted(), torch.no_grad():
            uncached = eng._run_prefill(hit_prompt)[0]
        checks.append(dict(sp_check(waves[1][0], hits[0]["out"][0],
                                    uncached, refs[-1][0], refs[-1][2],
                                    f"{what} hit against an uncached "
                                    f"prefill", failures, phase="serve_tp",
                                    base="unsharded"),
                           prompt_len=len(hit_prompt)))

    # P/D both ways with two 1000-token prompts: the wave's (a cache hit
    # on the tp engine: a suffix prefill and the resident pages joined
    # over the positions) and a fresh one (a full prefill: each position's
    # own kv heads joined). The tp engine's prefill_only into the
    # unsharded engine, and the unsharded engine's into the tp engine
    # (split over the positions).
    pd = {}
    for kind, pd_prompt, full in (
            ("cached", prompts[PROMPT_LENS.index(TP_PD_LEN)], 0),
            ("fresh", pd_fresh, 1)):
        with uncounted():
            flat_blob, flat_first = flat.prefill_only(pd_prompt, sp)
        tp_blob, tp_first = eng.prefill_only(pd_prompt, sp)
        with uncounted():
            to_flat = flat.decode_from(tp_blob, tp_first, sp)
        to_tp = eng.decode_from(flat_blob, flat_first, sp)
        counted(f"pd_{kind}", full)
        lap(f"pd_{kind}")
        pd[kind] = dict(blob_rel_err=max(rel_err(tp_blob[x].float(),
                                                 flat_blob[x].float())
                                         for x in ("k", "v")),
                        tp_first=tp_first, unsharded_first=flat_first,
                        blob_shape=list(tp_blob["k"].shape))
        if not (tokens_ok(to_flat) and tokens_ok(to_tp)
                and to_flat[0] == tp_first and to_tp[0] == flat_first
                and pd[kind]["blob_rel_err"] < LOGITS_REL_TOL
                and tp_blob["k"].shape == flat_blob["k"].shape):
            fail(f"P/D {kind}", dict(pd[kind], to_unsharded=to_flat,
                                     to_tp=to_tp))
        del flat_blob, tp_blob

    # Every cache entry demoted (each position's kv heads joined into one
    # host entry), then the prompt again: promoted (split back), with the
    # resident hit's tokens.
    while eng._cache.evict_lru(eng._decref, eng._demote_entry):
        pass
    demoted = eng.prefix_cache_stats()
    before = demoted
    lap("demote")
    rid = eng.add_request(hit_prompt, sp_hit)
    req = eng._requests[rid]
    promoted_out = run_timed(eng)[0].get(rid, [])
    after = eng.prefix_cache_stats()
    counted("promoted", 0)
    lap("promoted")
    promoted = dict(prefix_len=req.prefix_len,
                    promoted_pages=(after["promoted_pages"]
                                    - before["promoted_pages"]),
                    demoted_pages=demoted["demoted_pages"],
                    demoted_disk_entries=demoted["demoted_disk_entries"],
                    tokens_equal=promoted_out == hits[1]["out"])
    if not promoted["tokens_equal"] or promoted["promoted_pages"] != usable \
            or promoted["prefix_len"] != usable * eng.page:
        fail("promotion", dict(promoted, out=promoted_out,
                               resident=hits[1]["out"]))

    # The closed loop the replica is held to: one fresh prompt at a time.
    closed = None
    if closed_prompts:
        closed = [eng.generate([p], sp)[0] for p in closed_prompts]
        counted("closed_loop", len(closed_prompts))
        lap("closed_loop")

    timings = dict(decode_step_ms=step_ms, sections_s=sections_s,
                   decode_step_ms_median=float(np.median(step_ms)))
    with uncounted(), torch.no_grad():
        timings["prefill_1900_ms"] = host_ms(
            lambda: eng._run_prefill(prompts[-1]), iters=1)
        with named_ranges({"all_reduce": "tp:all_reduce"}):
            timings["profiled_prefill_1900"] = profiled(
                lambda: eng._run_prefill(prompts[-1]),
                ranges=("tp:all_reduce",))
    timings["profiled_decode_step"] = prof_decode
    lap("prefill_timing_and_profile")
    if len(set(devices)) > 1:
        for prof in (prof_decode, timings["profiled_prefill_1900"]):
            prof["idle_share"] = "not measured (several cards)"
    if torch.cuda.current_device() != 0:
        fail("current device", f"cuda:{torch.cuda.current_device()} after "
             f"the run, was cuda:0")
    res = dict(tp=n, devices=[str(d) for d in devices], memory=memory,
               launches=launches,
               flash_launches=sum(s["got"] for s in launches.values()),
               logits=checks, pd=pd,
               hits=[{k: v for k, v in h.items() if k != "out"}
                     for h in hits],
               promoted=promoted, timings=timings,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_run)
    del eng, waves
    gc.collect()
    torch.cuda.empty_cache()
    return res, closed


def serve_tp_replica(cfg, params, prompts, closed, failures) -> dict:
    """EngineReplica on a tp=2 mesh that names the card twice, on its
    own event loop thread: generate's tokens against the tp=2 closed-loop
    engine's."""
    t0 = time.perf_counter()
    bridge = Hosted()
    cuda0 = torch.device("cuda", 0)
    R = EngineReplica(cfg, params, device="cuda", mesh=build_mesh(
        MeshSpec(tp=2), devices=[cuda0] * 2), **REPLICA)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    got = [bridge.call(R.generate(p))["tokens"] for p in prompts]
    launches = flash_attention_fwd.launches
    want_launches = len(prompts) * cfg.num_layers * 2
    res = dict(tp=2, tokens_equal=got == closed, flash_launches=launches,
               expected_launches=want_launches,
               seconds=time.perf_counter() - t0)
    if got != closed or launches != want_launches:
        failures.append(f"serve_tp replica: {res}, got {got}, closed loop "
                        f"{closed}")
    bridge.shutdown()
    del R
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_tp_phase(card: str, failures: list, params) -> dict:
    """Tensor-parallel serving on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)              # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    rng = np.random.default_rng(5)
    hit_prompt = prompts[-1][:TP_HIT_PREFIX] + rng.integers(
        0, cfg.vocab_size, TP_HIT_SUFFIX).tolist()
    closed_prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                      for n in TP_REPLICA_LENS]
    pd_fresh = rng.integers(0, cfg.vocab_size, TP_PD_LEN).tolist()
    # Kernel 1 at the positions' head counts, before any engine runs.
    gen = torch.Generator("cuda").manual_seed(2)
    kernel = []
    for case in TP_KERNEL_CASES:
        *_, err_o, err_lse, _, ok = fwd_against_plain(gen, case)
        kernel.append(dict(Hq=case["Hq"], Hkv=case["Hkv"], S=case["S"],
                           max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                           ok=ok))
        if not ok:
            failures.append(f"serve_tp kernel 1 mismatch: {kernel[-1]}")
    # The unsharded engine of the serve shape: the P/D partner, the
    # prefill and decode step beside which the tp ones are printed, and the
    # kernel 1 prefill of each prompt beside the plain reference.
    flat = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    with uncounted(), torch.no_grad():
        pads = [flat._bucket(len(p)) for p in prompts] + [
            TP_HIT_PREFIX + flat._bucket(TP_HIT_SUFFIX)]
        refs = [(*plain_logits(params, cfg, p, pad), flat._run_prefill(p)[0])
                for p, pad in zip(prompts + [hit_prompt], pads)]
        flat_prefill_ms = host_ms(lambda: flat._run_prefill(prompts[-1]),
                                  iters=1)
        for p in prompts:
            flat.add_request(p, sp)
        flat.step()
        flat_steps = run_timed(flat)[2]
    cuda0 = torch.device("cuda", 0)
    runs, layouts, closed = [], [], None
    for n in TP_DEGREES:
        grids = [[cuda0] * n]
        if torch.cuda.device_count() >= n:
            grids.append([torch.device("cuda", i) for i in range(n)])
        for devices in grids:
            one_card = len(set(devices)) == 1
            layouts.append(dict(tp=n, distinct=not one_card))
            run, loop = serve_tp_run(
                cfg, params, devices, prompts, hit_prompt, pd_fresh, refs,
                flat, closed_prompts if n == 2 and one_card else None,
                failures)
            runs.append(run)
            closed = closed or loop
    del flat, refs
    gc.collect()
    torch.cuda.empty_cache()
    replica = serve_tp_replica(cfg, params, closed_prompts, closed, failures)
    res = dict(phase="serve_tp", preset="8b-gqa", engine=TP_ENGINE,
               prompt_lens=list(PROMPT_LENS),
               hit=dict(prefix=TP_HIT_PREFIX, suffix=TP_HIT_SUFFIX),
               device_count=torch.cuda.device_count(), ran=layouts,
               kernel=kernel,
               flash_launches=(sum(r["flash_launches"] for r in runs)
                               + replica["flash_launches"]),
               unsharded=dict(prefill_1900_ms=flat_prefill_ms,
                              decode_step_ms=flat_steps,
                              decode_step_ms_median=float(
                                  np.median(flat_steps))),
               runs=runs, replica=replica, logits_rel_tol=LOGITS_REL_TOL,
               seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


def mesh_memory(eng, params, flat) -> dict:
    """``tp_memory`` for each replica of a mesh engine (one, but under dp
    or fsdp on distinct cards or names), each held to the params' bytes
    and its pools to the unsharded pool; under sp on one card also the sp
    positions' tensors, which must be the first sp position's (no second
    copy)."""
    mesh = eng.mesh
    positions = [[i for i, c in zip(at, sub.coords()) if c[3] == 0]
                 for sub, at in llm_engine._replicas(mesh)]
    per = []
    for r, (rep, pos) in enumerate(zip(eng._reps, positions)):
        pk, pv = eng._rep_pools(r)
        per.append(tp_memory(rep, pos, mesh, pk + pv, params, flat))
    res = dict(ok=all(m["ok"] for m in per), replicas=len(per),
               per_replica=per)
    if eng._sp_params is not None and isinstance(eng._sp_params, list):
        devices = {t.device for tree in eng._sp_params
                   for _, t in _named_leaves(tree)}
        res["sp_positions_copy_nothing"] = (
            len(devices) > 1
            or _unique_bytes(eng._sp_params) == _unique_bytes(eng._shards))
        res["ok"] &= res["sp_positions_copy_nothing"]
    return res


def mesh_tokens(eng, flat, prompt, got, want) -> dict:
    """A mesh engine's greedy tokens against the unsharded engine's:
    equal, or parting at a step where the two are tied: where the two
    tokens' logits, as the unsharded engine scores them, differ by no
    more than the two engines' logits differ anywhere at that step (each
    engine's prefill of the prompt and the agreed tokens), so that two
    bf16 orderings of one model may pick either (the tie the first-token
    gate of sp_check allows)."""
    if got == want:
        return dict(equal=True, ok=True)
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    if i >= min(len(got), len(want)):
        return dict(equal=False, ok=False, step=i)
    ctx = prompt + want[:i]
    with uncounted(), torch.no_grad():
        mine = eng._run_prefill(ctx)[0].float()
        theirs = flat._run_prefill(ctx)[0].float()
    spread = (mine - theirs.to(mine.device)).abs().max().item()
    gap = (theirs[want[i]] - theirs[got[i]]).item()
    return dict(equal=False, ok=abs(gap) <= spread, step=i, got=got[i],
                want=want[i], unsharded_gap=gap, engines_spread=spread)


def serve_mesh_run(cfg, params, name, spec, strategy, devices, prompts,
                   hit_prompt, pd_prompt, refs, flat, flat_outs,
                   closed_prompts, failures) -> tuple:
    """One engine on the grid ``devices`` shaped by ``spec`` (a ``Mesh``
    of them as given: ``build_mesh`` would give "cuda" its index): the
    wave; on every layout but dp and fsdp alone the hit and P/D both
    ways; under dp and fsdp the replicas' prefill logits bit for bit; the
    closed loop the replica is held to; the checks and times of the
    module docstring."""
    t_run = time.perf_counter()
    # "cuda" without an index names the current card, cuda:0.
    cards = len({d.index or 0 for d in devices})
    what = f"{name} on {sorted(set(map(str, devices)))}"
    L = cfg.num_layers
    sp = SamplingParams(max_tokens=MAX_TOKENS)

    def fail(section, detail):
        failures.append(f"serve_mesh {what} {section}: {detail}")

    def tokens_ok(out, count=MAX_TOKENS):
        return len(out) == count and all(0 <= t < cfg.vocab_size
                                         for t in out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    current = torch.cuda.current_device()
    eng = LLMEngine(cfg, params, device="cuda", sp_strategy=strategy,
                    mesh=Mesh(np.array(devices, dtype=object).reshape(
                        [spec.get(a, 1) for a in AXES])),
                    **TP_ENGINE)
    memory = mesh_memory(eng, params, flat)
    replicated = "dp" in spec or "fsdp" in spec
    reps = len(llm_engine._replicas(eng.mesh))
    if not memory["ok"] or (replicated and len(eng._reps) != reps):
        fail("memory", memory)
    # Kernel 1 per full prefill: none under sp (ring or Ulysses, plain as
    # in the JAX package); every layer once per tp position (each stage
    # its own layers under pp); every layer once per replica under dp or
    # fsdp.
    per_prefill = (0 if eng.sp_degree > 1 else
                   L * eng.tp_degree * len(eng._reps))
    waves = keep_sampled_logits(eng)
    launches = {}

    def counted(section, full_prefills):
        launches[section] = dict(got=flash_attention_fwd.launches,
                                 want=full_prefills * per_prefill)
        flash_attention_fwd.launches = 0
        if launches[section]["got"] != launches[section]["want"]:
            fail("kernel 1 launches", launches)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0

    ids = [eng.add_request(p, sp) for p in prompts]
    outs, _, step_ms = run_timed(eng)
    counted("wave", len(prompts))
    checks, tokens = [], []
    if [len(w) for w in waves] != [len(prompts)]:
        fail("admission waves", [len(w) for w in waves])
    else:
        for rid, p, logits, ref, want in zip(ids, prompts, waves[0], refs,
                                             flat_outs):
            out = outs.get(rid, [])
            checks.append(dict(sp_check(logits, out[0] if out else -1,
                                        *ref, what, failures,
                                        phase="serve_mesh",
                                        base="unsharded"),
                               prompt_len=len(p)))
            tokens.append(dict(mesh_tokens(eng, flat, p, out, want),
                               prompt_len=len(p)))
            if not (tokens_ok(out) and tokens[-1]["ok"]):
                fail("tokens", (rid, out, tokens[-1]))

    hit = pd = replicas = closed = None
    if not replicated or len(spec) > 1:
        # The prefix hit on the 1900-token prompt's 16 pages (a suffix
        # prefill: sequence-parallel under sp, stage by stage under pp).
        before = eng.prefix_cache_stats()
        rid = eng.add_request(hit_prompt, SamplingParams(
            max_tokens=TP_HIT_TOKENS))
        req = eng._requests[rid]
        out = run_timed(eng)[0].get(rid, [])
        after = eng.prefix_cache_stats()
        hit = dict(prefix_len=req.prefix_len, hits=after["hits"]
                   - before["hits"], hit_pages=after["hit_pages"]
                   - before["hit_pages"], out=out)
        counted("hit", 0)
        if (hit["hits"], hit["prefix_len"]) != (1, TP_HIT_PREFIX) \
                or not tokens_ok(out, TP_HIT_TOKENS):
            fail("hit", hit)
        # P/D both ways with the unsharded engine on a fresh prompt.
        with uncounted():
            flat_blob, flat_first = flat.prefill_only(pd_prompt, sp)
        blob, first = eng.prefill_only(pd_prompt, sp)
        with uncounted():
            to_flat = flat.decode_from(blob, first, sp)
        to_mesh = eng.decode_from(flat_blob, flat_first, sp)
        counted("pd", 1)
        pd = dict(blob_rel_err=max(rel_err(blob[x].float(),
                                           flat_blob[x].float())
                                   for x in ("k", "v")),
                  first=first, unsharded_first=flat_first,
                  blob_shape=list(blob["k"].shape))
        if not (tokens_ok(to_flat) and tokens_ok(to_mesh)
                and to_flat[0] == first and to_mesh[0] == flat_first
                and pd["blob_rel_err"] < LOGITS_REL_TOL
                and blob["k"].shape == flat_blob["k"].shape):
            fail("P/D", dict(pd, to_unsharded=to_flat, to_mesh=to_mesh))
        del flat_blob, blob
    if replicated:
        # Each replica's prefill logits of the 1900-token prompt, on its
        # own weights and card, against the first's: bit for bit.
        toks = np.zeros((1, eng._bucket(len(prompts[-1]))), np.int64)
        toks[0, :len(prompts[-1])] = prompts[-1]
        with uncounted(), torch.no_grad():
            got = [llm_engine._prefill_fn(
                rep, torch.from_numpy(toks).to(
                    llm_engine._devices(rep)[0]),
                len(prompts[-1]), cfg)[0].cpu() for rep in eng._reps]
        replicas = dict(count=len(got),
                        bit_equal=all(torch.equal(g, got[0]) for g in got))
        if not replicas["bit_equal"]:
            fail("replicas", replicas)
    if closed_prompts:
        closed = [eng.generate([p], sp)[0] for p in closed_prompts]
        counted("closed_loop", len(closed_prompts))

    timings = dict(decode_step_ms=step_ms,
                   decode_step_ms_median=float(np.median(step_ms)))
    with uncounted(), torch.no_grad():
        timings["prefill_1900_ms"] = host_ms(
            lambda: eng._run_prefill(prompts[-1]), iters=1)
        timings["profiled_prefill_1900"] = prof = profiled(
            lambda: eng._run_prefill(prompts[-1]))
    if cards > 1:
        prof["idle_share"] = "not measured (several cards)"
    if torch.cuda.current_device() != current:
        fail("current device", f"cuda:{torch.cuda.current_device()} after "
             f"the run, was cuda:{current}")
    res = dict(name=name, mesh=spec, strategy=strategy,
               devices=[str(d) for d in devices], replicas=len(eng._reps),
               launches_per_full_prefill=per_prefill, memory=memory,
               launches=launches,
               flash_launches=sum(s["got"] for s in launches.values()),
               logits=checks, tokens=tokens,
               hit=hit and {k: v for k, v in hit.items() if k != "out"},
               pd=pd, replicas_equal=replicas, timings=timings,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_run)
    del eng, waves
    gc.collect()
    torch.cuda.empty_cache()
    return res, closed


def serve_mesh_replica(cfg, params, prompts, closed, failures) -> dict:
    """EngineReplica on a pp=2 mesh that names the card twice, on its own
    event loop thread: generate's tokens against the pp=2 engine's closed
    loop."""
    t0 = time.perf_counter()
    bridge = Hosted()
    cuda0 = torch.device("cuda", 0)
    R = EngineReplica(cfg, params, device="cuda", mesh=build_mesh(
        MeshSpec(pp=2), devices=[cuda0] * 2), **REPLICA)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    got = [bridge.call(R.generate(p))["tokens"] for p in prompts]
    launches = flash_attention_fwd.launches
    want_launches = len(prompts) * cfg.num_layers
    res = dict(pp=2, tokens_equal=got == closed, flash_launches=launches,
               expected_launches=want_launches,
               seconds=time.perf_counter() - t0)
    if got != closed or launches != want_launches:
        failures.append(f"serve_mesh replica: {res}, got {got}, closed "
                        f"loop {closed}")
    bridge.shutdown()
    del R
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_mesh_phase(card: str, failures: list, params) -> dict:
    """Serving on sp x tp (ring and Ulysses), pp, pp x tp, dp and fsdp
    meshes, then on the replicated split layouts dp x tp, fsdp x tp and
    dp x pp, and on pp x sp, on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)              # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    rng = np.random.default_rng(6)
    hit_prompt = prompts[-1][:TP_HIT_PREFIX] + rng.integers(
        0, cfg.vocab_size, TP_HIT_SUFFIX).tolist()
    pd_prompt = rng.integers(0, cfg.vocab_size, TP_PD_LEN).tolist()
    closed_prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                      for n in MESH_REPLICA_LENS]
    # The unsharded engine: the tokens each layout is held to, the P/D
    # partner, and the kernel 1 prefill of each prompt beside the plain
    # reference.
    flat = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    with uncounted(), torch.no_grad():
        refs = [(*plain_logits(params, cfg, p, flat._bucket(len(p))),
                 flat._run_prefill(p)[0]) for p in prompts]
        flat_outs = flat.generate(prompts, sp)
        flat_prefill_ms = host_ms(lambda: flat._run_prefill(prompts[-1]),
                                  iters=1)
    cuda0 = torch.device("cuda", 0)
    runs, layouts, closed = [], [], None
    for name, spec, strategy in MESH_RUNS:
        n = MeshSpec(**spec).n_devices
        grids = [[cuda0] * n]
        if len(spec) > 1 and ("dp" in spec or "fsdp" in spec):
            # Two replicas on the card: the second's positions name it
            # "cuda".
            grids = [[torch.device("cuda") if c[1] + c[2] else cuda0
                      for c in np.ndindex(*(spec.get(a, 1) for a in AXES))]]
        if torch.cuda.device_count() >= n:
            grids.append([torch.device("cuda", i) for i in range(n)])
        for devices in grids:
            one_card = all(d.index in (None, 0) for d in devices)
            layouts.append(dict(name=name, distinct=not one_card))
            run, loop = serve_mesh_run(
                cfg, params, name, spec, strategy, devices, prompts,
                hit_prompt, pd_prompt, refs, flat, flat_outs,
                closed_prompts if name == "pp2" and one_card else None,
                failures)
            runs.append(run)
            closed = closed or loop
    del flat, refs
    gc.collect()
    torch.cuda.empty_cache()
    replica = serve_mesh_replica(cfg, params, closed_prompts, closed,
                                 failures)
    res = dict(phase="serve_mesh", preset="8b-gqa", engine=TP_ENGINE,
               prompt_lens=list(PROMPT_LENS),
               hit=dict(prefix=TP_HIT_PREFIX, suffix=TP_HIT_SUFFIX),
               device_count=torch.cuda.device_count(), ran=layouts,
               flash_launches=(sum(r["flash_launches"] for r in runs)
                               + replica["flash_launches"]),
               unsharded=dict(prefill_1900_ms=flat_prefill_ms),
               runs=runs, replica=replica, logits_rel_tol=LOGITS_REL_TOL,
               seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


# --------------------------------------------------------- device plane ---

def _dp_bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, for bit-for-bit comparison (bf16 as int16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _dp_sha256(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes, read by a plain copy that the copy
    audit does not see."""
    return hashlib.sha256(
        _dp_bits(t.detach()).cpu().contiguous().numpy().tobytes()
    ).hexdigest()


def _dp_delta(before: dict) -> dict:
    after = device_plane.device_copy_stats()
    return {k: after[k] - before[k] for k in after}


def _device_plane_child(path: str, index: int, results) -> None:
    """A spawned process: the serialized P/D blob in ``path`` rebuilt on
    cuda:index; its k and v hashes and its own copy audit go to
    ``results``, or its traceback."""
    import traceback
    try:
        bad = [m for m in ("jax", "ray_tpu") if m in sys.modules]
        if bad:
            raise RuntimeError(f"device_plane child imported {bad}")
        torch.cuda.set_device(index)
        device_plane.set_landing_device(f"cuda:{index}")
        arena = np.fromfile(path, np.uint8)
        t0 = time.perf_counter()
        blob = serialization.get_context().deserialize(memoryview(arena))
        torch.cuda.synchronize(index)
        upload_s = time.perf_counter() - t0
        results.put(("ok", dict(
            device=str(blob["k"].device), len=blob["len"],
            sha256={n: _dp_sha256(blob[n]) for n in ("k", "v")},
            audit=device_plane.device_copy_stats(), upload_s=upload_s)))
    except BaseException:
        results.put(("error", traceback.format_exc()))
        raise


def device_plane_phase(card: str, failures: list, params) -> dict:
    """The device plane on the serve phase's params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    t_phase = time.perf_counter()
    ctx = serialization.get_context()
    device_plane.set_landing_device("cuda")
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, DEVICE_PLANE_LEN).tolist()
    a = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    b = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    res = dict(phase="device_plane", preset="8b-gqa", engine=SERVE_ENGINE,
               prompt_len=DEVICE_PLANE_LEN, blob_bytes=DEVICE_PLANE_BYTES)

    def check(ok: bool, what: str, detail) -> None:
        if not ok:
            failures.append(f"device_plane {what}: {detail}")

    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0

    # 1. Rung 0: the whole param tree through a local-token body.
    before = device_plane.device_copy_stats()
    t0 = time.perf_counter()
    parts, token = device_plane.dag_encode_body(ctx, b"\x00", params,
                                                True, 1)
    body = b"".join(bytes(p) for p in parts)
    back = device_plane.dag_decode_body(ctx, body)
    rung0_ms = (time.perf_counter() - t0) * 1e3
    _, leaves, specs = device_plane.split_device_leaves(params)
    _, got, _ = device_plane.split_device_leaves(back)
    delta = _dp_delta(before)
    same = [x.data_ptr() for x in got] == [x.data_ptr() for x in leaves]
    res["rung0"] = dict(leaves=len(leaves),
                        bytes=sum(s.nbytes for s in specs),
                        body_bytes=len(body), ms=rung0_ms, same_data_ptr=same,
                        audit=delta, registered=device_plane
                        .local_is_registered(token))
    check(parts[1] == device_plane.MAGIC_LOCAL and same
          and delta["device_to_host_bytes"] == 0
          and delta["host_to_device_bytes"] == 0
          and delta["device_arrays_local"] == len(leaves)
          and not res["rung0"]["registered"], "rung 0", res["rung0"])
    del back, got

    # 2 and 3. The 1900-token prompt's P/D blob (kernel 1, 32 launches)
    # through serialize -> one host buffer -> deserialize onto the card.
    t0 = time.perf_counter()
    blob, first = a.prefill_only(prompt, sp)
    torch.cuda.synchronize()
    prefill_only_ms = (time.perf_counter() - t0) * 1e3
    nbytes = blob["k"].nbytes + blob["v"].nbytes
    check(nbytes == DEVICE_PLANE_BYTES, "blob bytes", nbytes)
    runs, arena = [], None
    for _ in range(DEVICE_PLANE_ROUNDS):
        before = device_plane.device_copy_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = ctx.serialize(blob)
        t1 = time.perf_counter()
        if arena is None:
            # The destination stands for an arena: mapped once, its pages
            # touched (untimed), reused by every round.
            arena = np.empty(ctx.total_size(parts), np.uint8)
            arena.fill(0)
        t2 = time.perf_counter()
        serialization.write_parts_into(parts, memoryview(arena))
        t3 = time.perf_counter()
        rebuilt = ctx.deserialize(memoryview(arena))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        d2h_s = (t1 - t0) + (t3 - t2)
        delta = _dp_delta(before)
        equal = all(torch.equal(_dp_bits(rebuilt[n]), _dp_bits(blob[n]))
                    for n in ("k", "v"))
        runs.append(dict(
            serialize_ms=(t1 - t0) * 1e3, write_ms=(t3 - t2) * 1e3,
            deserialize_ms=(t4 - t3) * 1e3,
            d2h_gb_s=nbytes / d2h_s / 1e9, h2d_gb_s=nbytes / (t4 - t3) / 1e9,
            copied_part_bytes=serialization.copied_part_bytes(parts),
            audit=delta, bit_equal=equal,
            device=str(rebuilt["k"].device)))
        check(equal and delta["device_to_host_bytes"] == nbytes
              and delta["host_to_device_bytes"] == nbytes
              and delta["device_fallback_bytes"] == nbytes
              and delta["device_arrays_staged"] == 2
              and runs[-1]["copied_part_bytes"] == 0
              and rebuilt["k"].is_cuda, "rung 1", runs[-1])
        del parts
    res["rung1"] = runs

    # 3. P/D through the serializer against the in-process handoff and A's
    # own generation, after one decode_from that warms engine B.
    b.decode_from(blob, first, sp)
    decode_s = {}
    for name, shipped in (("serializer", rebuilt), ("in_process", blob)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = b.decode_from(shipped, first, sp)
        decode_s[name] = time.perf_counter() - t0
        if name == "serializer":
            via_bytes = out
        else:
            in_process = out
    own = a.generate([prompt], sp)[0]
    res["pd"] = dict(prefill_only_ms=prefill_only_ms,
                     serializer_handoff_ms=runs[-1]["serialize_ms"]
                     + runs[-1]["write_ms"] + runs[-1]["deserialize_ms"],
                     decode_from_s=decode_s,
                     first=first, tokens=via_bytes,
                     equal_in_process=via_bytes == in_process,
                     equal_own=via_bytes == own)
    check(via_bytes == in_process == own and len(via_bytes) == MAX_TOKENS
          and via_bytes[0] == first
          and all(0 <= t < cfg.vocab_size for t in via_bytes), "P/D",
          dict(res["pd"], in_process=in_process, own=own))
    del rebuilt, arena
    launches = flash_attention_fwd.launches
    want_launches = 2 * cfg.num_layers
    res.update(flash_launches=launches, expected_launches=want_launches)
    check(launches == want_launches, "kernel 1 launches", launches)

    # 4. prefill_paged with host_staged on the serve_paged engine's shape.
    pre = LLMEngine(cfg, params, device="cuda", max_batch=1, kv_pages=1,
                    kv_gather_window=PAGED_WINDOW, **PAGED_ENGINE)
    paged_prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, PAGED_LEN).tolist()
    staged_runs = {}
    for staged in (False, True):
        before = device_plane.device_copy_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handoff = pre.prefill_paged(paged_prompt, sp, span=PAGED_SPAN,
                                    host_staged=staged)
        torch.cuda.synchronize()
        staged_runs[staged] = (handoff, (time.perf_counter() - t0) * 1e3,
                               _dp_delta(before))
    (dev, dev_ms, dev_audit), (host, host_ms_, host_audit) = (
        staged_runs[False], staged_runs[True])
    part_bytes = sum(p["handle"][n].nbytes for p in dev["parts"]
                     for n in ("k", "v"))
    same_parts = all(
        torch.equal(_dp_bits(device_plane.from_host_array(
            h["handle"][n], h["handle"].get("dtype"), "cuda")),
            _dp_bits(d["handle"][n]))
        for h, d in zip(host["parts"], dev["parts"]) for n in ("k", "v"))
    res["host_staged"] = dict(
        parts=len(dev["parts"]), part_bytes=part_bytes,
        device_ms=dev_ms, staged_ms=host_ms_, first=(dev["first"],
                                                     host["first"]),
        same_parts=same_parts, device_audit=dev_audit,
        staged_audit=host_audit)
    # Each chunk uploads the part before it once: all parts but the last.
    n_parts = len(dev["parts"])
    check(dev["first"] == host["first"] and same_parts
          and host_audit["device_to_host_bytes"] == part_bytes
          and host_audit["host_to_device_bytes"]
          == part_bytes // n_parts * (n_parts - 1)
          and dev_audit["device_to_host_bytes"] == 0
          and dev_audit["host_to_device_bytes"] == 0
          and all(p["handle"]["dtype"] == "bfloat16"
                  for p in host["parts"]), "host_staged",
          res["host_staged"])
    del pre, dev, host, staged_runs
    gc.collect()

    # 5. Another process rebuilds the serialized blob on its own card.
    index = 1 if torch.cuda.device_count() >= 2 else 0
    want_sha = {n: _dp_sha256(blob[n]) for n in ("k", "v")}
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "blob.bin")
        parts = ctx.serialize(blob)
        with open(path, "wb") as f:
            for p in parts:
                f.write(p)
        del parts
        t0 = time.perf_counter()
        proc = mp.Process(target=_device_plane_child, name="device_plane",
                          args=(path, index, results))
        proc.start()
        try:
            status, value = results.get(timeout=DEVICE_PLANE_CHILD_S)
        except queue.Empty:
            status, value = "error", f"no result in {DEVICE_PLANE_CHILD_S} s"
        child_s = time.perf_counter() - t0
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
            value = f"{value}; still running, killed"
            status = "error"
        elif proc.exitcode != 0:
            status, value = "error", f"{value}; exited {proc.exitcode}"
    if status == "ok":
        res["child"] = dict(value, seconds=child_s,
                            upload_gb_s=nbytes / value["upload_s"] / 1e9)
        check(value["sha256"] == want_sha
              and value["audit"]["host_to_device_bytes"] == nbytes
              and value["device"] == f"cuda:{index}", "child", value)
    else:
        res["child"] = dict(error=value, seconds=child_s)
        check(False, "child", value)

    # 6. Device objects: put on an owner store, get from a second store
    # whose fetch calls the owner's serve_fetch, free.
    owner = experimental.DeviceObjectStore(("owner", 1), device="cuda")
    fetches = []

    def fetch(addr, oid, offset):
        fetches.append(offset)
        return experimental.serve_fetch(owner, oid, offset)
    consumer = experimental.DeviceObjectStore(
        ("consumer", 2), device="cuda", fetch=fetch,
        free=lambda addr, oid: experimental.serve_free(owner, oid))
    payload = torch.stack([blob["k"], blob["v"]])
    stats0 = experimental.device_transport_stats()
    before = device_plane.device_copy_stats()
    ref = experimental.device_put(payload, owner)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = experimental.device_get(ref, consumer)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    chunks = len(fetches)
    stats1 = experimental.device_transport_stats()
    delta = _dp_delta(before)
    equal = torch.equal(_dp_bits(got), _dp_bits(payload))
    experimental.device_free(ref, consumer)
    try:
        experimental.device_get(ref, consumer)
        freed = False
    except KeyError:
        freed = True
    objs = dict(
        bytes=payload.nbytes, chunks=chunks, get_ms=get_s * 1e3,
        gb_s=payload.nbytes / get_s / 1e9, bit_equal=equal, audit=delta,
        gets_remote=stats1["gets_remote"] - stats0["gets_remote"],
        bytes_staged=stats1["bytes_staged"] - stats0["bytes_staged"],
        staged_gib_s=stats1["staged_gib_s"], freed=freed,
        owner_objects=len(owner.device_objects))
    res["device_objects"] = objs
    want_chunks = -(-nbytes // experimental.DEVICE_CHUNK)
    check(equal and objs["gets_remote"] == 1
          and objs["bytes_staged"] == nbytes
          and chunks == want_chunks
          and delta["device_to_host_bytes"] == nbytes
          and delta["host_to_device_bytes"] == nbytes
          and freed and not owner.device_objects, "device objects", objs)
    del payload, got, blob, a, b
    gc.collect()
    torch.cuda.empty_cache()
    res.update(seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS on Hopper


def device_time_split(prof) -> tuple:
    """Device time (ms) of the kernels one profiled window ran, by class
    (the three attention kernels by name, dense matmuls, which cuBLAS runs
    as nvjet/GEMM kernels, and everything else: elementwise, reductions,
    copies), and the ten kernels that took the most."""
    split = {"fa_fwd": 0.0, "fa_dq": 0.0, "fa_dkv": 0.0, "matmul": 0.0,
             "other": 0.0}
    # One pass over the events, summed by name as key_averages() sums
    # them: key_averages() took most of train_sp's time over the events of
    # a profiled ring training step (PERF.md).
    by_name: dict = {}
    for evt in prof.events():
        # A record_function range also shows as a device event spanning its
        # kernels: skip it, its kernels are counted.
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        acc = by_name.setdefault(evt.key, [0.0, 0])
        acc[0] += evt.self_device_time_total / 1e3
        acc[1] += 1
    kernels = []
    for name, (ms, calls) in by_name.items():
        kernels.append(dict(name=name[:90], ms=ms, calls=calls))
        if "fa_dkv" in name:
            split["fa_dkv"] += ms
        elif "fa_dq" in name:
            split["fa_dq"] += ms
        elif "fa_fwd" in name:
            split["fa_fwd"] += ms
        elif any(w in name.lower() for w in MATMUL_KERNELS):
            split["matmul"] += ms
        else:
            split["other"] += ms
    return split, sorted(kernels, key=lambda k: -k["ms"])[:10]


def _named_leaves(tree, prefix=""):
    """(dotted path, tensor) for every tensor of a nested dict / list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def _is_attn(name: str) -> bool:
    parts = name.split(".")
    return len(parts) == 4 and parts[2] == "attn" and parts[3] in ATTN_WEIGHTS


def grad_pass(params, batch, cfg, impl: str):
    """One loss+grad pass with ``impl`` attention, reduced so that the 16 GB
    of grads need not outlive it: (loss, global norm, per-leaf norms, the
    attention weights' grads)."""
    loss, grads = value_and_grad(
        params, batch, dataclasses.replace(cfg, attention_impl=impl),
        device="cuda")
    named = dict(_named_leaves(grads))
    del grads
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in named.values()])
    gnorm = float(torch.linalg.vector_norm(norms))
    attn = {n: g for n, g in named.items() if _is_attn(n)}
    norms = dict(zip(named, norms.tolist()))
    del named
    gc.collect()
    torch.cuda.empty_cache()
    return float(loss), gnorm, norms, attn


def leaf_diffs(attn, ref_attn, norms, ref_norms) -> dict:
    """The worst attention weight by ||g - g_ref|| / ||g_ref||, and the
    worst leaf of all by |norm - ref norm| / ref norm."""
    errs = {n: (torch.linalg.vector_norm(g.float() - ref_attn[n].float())
                / torch.linalg.vector_norm(ref_attn[n], dtype=torch.float32)
                ).item() for n, g in attn.items()}
    nerrs = {n: abs(norms[n] - ref_norms[n]) / max(ref_norms[n], 1e-30)
             for n in ref_norms}
    worst, nworst = max(errs, key=errs.get), max(nerrs, key=nerrs.get)
    return dict(attn_grad_rel_err=errs[worst], attn_grad_worst=worst,
                attn_grad_rel_err_median=float(np.median(list(errs.values()))),
                leaf_norm_rel_err=nerrs[nworst], leaf_norm_worst=nworst,
                leaves=len(nerrs))


@torch.no_grad()
def relabel_mlp_(params, perm) -> None:
    """Permute every layer's MLP hidden units in place: w_gate and w_up
    columns, w_down rows. The model computes the same function; only the
    order of w_down's sums (and their rounding) changes."""
    mlp = params["layers"]["mlp"]
    for i in range(mlp["w_down"].shape[0]):
        for name in ("w_gate", "w_up"):
            mlp[name][i].copy_(mlp[name][i][:, perm])
        mlp["w_down"][i].copy_(mlp["w_down"][i][perm])


def _launch_counts():
    return (flash_attention_fwd.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches)


def train_phase(card: str, failures: list) -> dict:
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    bundle = make_train_step(cfg, optimizer=make_optimizer(warmup_steps=1),
                             device="cuda")
    t0 = time.perf_counter()
    state = bundle.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                               (1, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}

    # Plain attention on the initial params: what step 1 and the flash
    # pass must agree with.
    params = state["params"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref_loss, ref_gnorm, ref_norms, ref_attn = grad_pass(params, batch, cfg,
                                                         "xla")
    ref_s = time.perf_counter() - t0
    ref_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Control: the plain pass on the same model with relabelled MLP units,
    # then the labels put back (bit-exactly: a permutation moves bits).
    perm = torch.randperm(cfg.intermediate_size, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    relabel_mlp_(params, perm)
    ctl_loss, ctl_gnorm, ctl_norms, ctl_attn = grad_pass(params, batch, cfg,
                                                         "xla")
    relabel_mlp_(params, torch.argsort(perm))
    control = dict(loss_rel_err=abs(ctl_loss - ref_loss) / abs(ref_loss),
                   grad_norm_rel_err=abs(ctl_gnorm - ref_gnorm) / ref_gnorm,
                   **leaf_diffs(ctl_attn, ref_attn, ctl_norms, ref_norms))
    del ctl_attn
    fl_loss, fl_gnorm, fl_norms, fl_attn = grad_pass(params, batch, cfg,
                                                     "flash")
    flash = dict(loss_rel_err=abs(fl_loss - ref_loss) / abs(ref_loss),
                 grad_norm_rel_err=abs(fl_gnorm - ref_gnorm) / ref_gnorm,
                 **leaf_diffs(fl_attn, ref_attn, fl_norms, ref_norms))
    leaf_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del fl_attn, ref_attn
    gc.collect()
    torch.cuda.empty_cache()
    if not flash["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_REL_TOL:
        failures.append(f"attention weight grads, flash against plain: "
                        f"{flash}")

    # Under per-layer checkpointing each layer's forward runs twice per
    # step (the forward, then the recompute in the backward), its
    # backward once.
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    flash_attention_fwd.launches = 0
    flash_attention_dq.launches = 0
    flash_attention_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        # The last step runs under the profiler, for where its time goes.
        last = i == TRAIN_STEPS - 1
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if last
                else contextlib.nullcontext())
        before = _launch_counts()
        torch.cuda.synchronize()
        with prof:
            t0 = time.perf_counter()
            state, metrics = bundle.step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        steps.append(dict(metrics, step_ms=step_s * 1e3,
                          launches=dict(zip(("fwd", "dq", "dkv"),
                                            launches))))
        if launches != want:
            failures.append(f"train step {metrics['step']} launched "
                            f"(fwd, dq, dkv) {launches}, expected {want}")
        if not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"])):
            failures.append(f"train step not finite: {metrics}")
    totals = dict(zip(("fwd", "dq", "dkv"), _launch_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split, top = device_time_split(prof)
    busy_ms = sum(split.values())
    profiled = dict(step=steps[-1]["step"], wall_ms=steps[-1]["step_ms"],
                    device_ms=split if busy_ms else "not measured",
                    idle_share=(1 - busy_ms / steps[-1]["step_ms"]
                                if busy_ms else "not measured"),
                    top_kernels=top)

    first, last = steps[0], steps[-1]
    loss_rel = abs(first["loss"] - ref_loss) / abs(ref_loss)
    gnorm_rel = abs(first["grad_norm"] - ref_gnorm) / abs(ref_gnorm)
    if not last["loss"] < first["loss"]:
        failures.append(f"train loss did not fall: {first['loss']} -> "
                        f"{last['loss']}")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL
            and gnorm_rel <= TRAIN_GNORM_REL_TOL):
        failures.append(f"step 1 against plain attention: loss rel "
                        f"{loss_rel}, grad_norm rel {gnorm_rel}")
    # Steady state: the steps after the first (which also warms up the
    # allocator and cuBLAS) and before the profiled one.
    steady_s = np.mean([s["step_ms"] for s in steps[1:-1]]) / 1e3
    res = dict(
        phase="train", preset="8b-gqa", params=cfg.param_count(),
        layers=cfg.num_layers, seq_len=TRAIN_SEQ, batch=1, remat=cfg.remat,
        init_s=init_s, steps=steps, launches=totals,
        expected_launches_per_step=dict(zip(("fwd", "dq", "dkv"), want)),
        plain_attention=dict(loss=ref_loss, grad_norm=ref_gnorm,
                             seconds=ref_s, peak_memory_gb=ref_peak_gb),
        loss_rel_err=loss_rel, grad_norm_rel_err=gnorm_rel,
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        leaf_grads=dict(flash=flash, control=control,
                        attn_grad_rel_tol=TRAIN_ATTN_GRAD_REL_TOL,
                        peak_memory_gb=leaf_peak_gb),
        steady_step_ms=steady_s * 1e3, profiled_step=profiled,
        tokens_per_s=TRAIN_SEQ / steady_s,
        model_flops_utilization=(cfg.flops_per_token(TRAIN_SEQ) * TRAIN_SEQ
                                 / steady_s / PEAK_FLOPS[torch.bfloat16]),
        peak_memory_gb=peak_gb, card=card)
    emit(res)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _sample(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dict_leaves(tree, prefix="") -> dict:
    """{dotted path: leaf} of nested dicts (a leaf may be a tuple)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_dict_leaves(v, f"{prefix}.{k}" if prefix else k))
    return out


def _unique_bytes(trees) -> int:
    """The bytes of the distinct tensors of per-position trees."""
    return sum({id(t): t.nbytes for tree in trees
                for t in _dict_leaves(tree).values()}.values())


def mesh_layout_checks(cfg, mesh, state, specs, plan) -> dict:
    """The one-card mesh's state against the unsharded state's bytes
    (distinct tensors only: no second copy), each position's shard shapes
    against its specs, and the planner's per-position bytes against each
    position's own params, mu and nu."""
    shapes = _dict_leaves(transformer.param_shapes(cfg))
    specs = _dict_leaves(specs)
    whole = sum(math.prod(shape) * torch.tensor([], dtype=dt).element_size()
                for shape, dt in shapes.values())
    opt = state["opt_state"]
    held = {k: _unique_bytes(v) for k, v in (("params", state["params"]),
                                            ("mu", opt["mu"]),
                                            ("nu", opt["nu"]))}
    bad_shapes, bad_plan = [], []
    for i, coord in enumerate(mesh.coords()):
        for name, t in _dict_leaves(state["params"][i]).items():
            want = tuple(s.stop - s.start for s in shard_slices(
                specs[name], shapes[name][0], mesh, coord))
            if tuple(t.shape) != want:
                bad_shapes.append((i, name, tuple(t.shape), want))
        own = sum(t.nbytes for t in _dict_leaves(state["params"][i]).values())
        moments = sum(t.nbytes for k in ("mu", "nu")
                      for t in _dict_leaves(opt[k][i]).values())
        if (own, moments) != (plan.params_bytes, plan.opt_bytes):
            bad_plan.append((i, own, moments))
    return dict(ok=(all(v == whole for v in held.values())
                    and not bad_shapes and not bad_plan),
                unsharded_params_bytes=whole, held_bytes=held,
                shard_shape_mismatches=bad_shapes[:5],
                plan_mismatches=bad_plan[:5],
                position_params_bytes=plan.params_bytes,
                position_opt_bytes=plan.opt_bytes)


def shards_hold_their_slices(cfg, mesh, specs, shards, params) -> bool:
    """Whether each distinct shard equals its slice of the unsharded
    params (under pp: its stage's layers), bit for bit."""
    shapes = _dict_leaves(transformer.param_shapes(cfg))
    specs = _dict_leaves(specs)
    full = _dict_leaves(params)
    seen = set()
    for coord, tree in zip(mesh.coords(), shards):
        for name, t in _dict_leaves(tree).items():
            if id(t) in seen:
                continue
            seen.add(id(t))
            sl = shard_slices(specs[name], shapes[name][0], mesh, coord)
            if not torch.equal(t, full[name][sl].to(t.device)):
                return False
    return True


def gather_sample(grads, path, specs, mesh, cfg, device):
    """A sampled gradient of per-position grads, whole, on ``device``: a
    top-level leaf over the mesh, or one layer's (``path[1]``) over the
    positions of the stage that holds it (its index in that stage's own
    list of layers)."""
    spec = _sample(specs, [k for k in path if not isinstance(k, int)])
    if len(path) == 1:
        return gather_tensor([_sample(g, path) for g in grads], spec, mesh,
                             device=device)
    stage, li = divmod(path[1], cfg.num_layers // mesh.shape["pp"])
    sub = Mesh(mesh.devices[stage:stage + 1])
    local = ("layers", li) + tuple(path[2:])
    return gather_tensor([_sample(grads[i], local)
                          for i in mesh.stage_positions(stage)],
                         spec[1:], sub, device=device)


def train_mesh_run(cfg, devices, batch, ref, failures, one_card: bool,
                   plan, spec=TRAIN_MESH, microbatches=None,
                   ranges=TRAIN_MESH_RANGES, name="train_mesh",
                   steps=TRAIN_STEPS, rules=None,
                   profiled_step=True) -> dict:
    """Train on ``build_mesh(MeshSpec(**spec), devices=devices)`` with
    ``microbatches`` per batch group under pp, the params stored as
    ``rules`` say (default: the default table), from the seed-0 params
    (drawn again on the first device, as the unsharded pass drew them):
    the sharded value_and_grad's sampled gradients against ``ref``'s, then
    ``steps`` steps (the last profiled, with ``ranges`` named) with their
    launch counts (none under ring attention), step 1 against ``ref``'s
    loss and grad norm. ``profiled_step=False`` profiles no step."""
    what = f"{name} on {len(set(devices))} card(s)"

    def fail(msg):
        failures.append(f"{what}: {msg}")
    current = torch.cuda.current_device()
    mesh = build_mesh(MeshSpec(**spec), devices=devices)
    bundle = make_train_step(cfg, mesh,
                             optimizer=make_optimizer(warmup_steps=1),
                             rules=rules, num_microbatches=microbatches,
                             device="cuda")
    specs = bundle.state_specs["params"]
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(devices[0]).manual_seed(0),
                         devices[0])
    shards = shard_params(params, mesh, bundle.rules)
    slices_ok = shards_hold_their_slices(cfg, mesh, specs, shards, params)
    if not slices_ok:
        fail("a shard differs from its slice of the unsharded params")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = value_and_grad(shards, batch, cfg, device="cuda",
                                 mesh=mesh, rules=bundle.rules,
                                 num_microbatches=microbatches)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    sample_errs = {}
    for path in TRAIN_MESH_SAMPLE:
        got = gather_sample(grads, path, specs, mesh, cfg, devices[0])
        want = ref["grads"][path].to(devices[0])
        sample_errs[".".join(map(str, path))] = (
            torch.linalg.vector_norm(got.float() - want.float())
            / torch.linalg.vector_norm(want, dtype=torch.float32)).item()
        del got
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(sample_errs, key=sample_errs.get)
    if not sample_errs[worst] <= TRAIN_MESH_GRAD_REL_TOL:
        fail(f"sampled gradient {worst} against the unsharded pass: "
             f"{sample_errs[worst]}")
    vg_loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    state = {"params": shards,
             "opt_state": bundle.optimizer.init(shards), "step": 0}
    del shards
    layout = (mesh_layout_checks(cfg, mesh, state, specs, plan) if one_card
              else None)
    if layout is not None and not layout["ok"]:
        fail(f"layout {layout}")

    # Per layer, microbatch, batch group and tp position: kernel 1 in the
    # forward and in the recompute, dQ and dK/dV once.
    pp = mesh.shape["pp"]
    mb = (microbatches or pp) if pp > 1 else 1
    per = (cfg.num_layers * mb * len(mesh.batch_groups(bundle.rules))
           * mesh.shape["tp"])
    if cfg.attention_impl != "flash":
        per = 0
    want = (2 * per, per, per)
    flash_attention_fwd.launches = 0
    flash_attention_dq.launches = 0
    flash_attention_dkv.launches = 0
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    n_steps, steps = steps, []
    for i in range(n_steps):
        last = profiled_step and i == n_steps - 1
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if last
                else contextlib.nullcontext())
        names = named_ranges(ranges) if last else contextlib.nullcontext()
        before = _launch_counts()
        torch.cuda.synchronize()
        with prof, names:
            t0 = time.perf_counter()
            state, metrics = bundle.step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        steps.append(dict(metrics, step_ms=step_s * 1e3,
                          launches=dict(zip(("fwd", "dq", "dkv"),
                                            launches))))
        if launches != want:
            fail(f"step {metrics['step']} launched (fwd, dq, dkv) "
                 f"{launches}, expected {want}")
        if not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"])):
            fail(f"step not finite: {metrics}")
    totals = dict(zip(("fwd", "dq", "dkv"), _launch_counts()))
    peak = [torch.cuda.max_memory_allocated(i) / 1e9
            for i in range(torch.cuda.device_count())]
    split, top = (device_time_split(prof) if profiled_step
                  else ({}, []))
    busy = sum(split.values())
    if profiled_step:
        split_ranges(prof, split, ranges.values())
    first, last = steps[0], steps[-1]
    loss_rel = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
    gnorm_rel = abs(first["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    if not last["loss"] < first["loss"]:
        fail(f"loss did not fall: {first['loss']} -> {last['loss']}")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL
            and gnorm_rel <= TRAIN_GNORM_REL_TOL):
        fail(f"step 1 against the unsharded pass: loss rel {loss_rel}, "
             f"grad_norm rel {gnorm_rel}")
    if torch.cuda.current_device() != current:
        fail(f"left cuda:{torch.cuda.current_device()} current, not "
             f"cuda:{current}")
    steady_s = np.mean([st["step_ms"] for st in steps[1:-1]]) / 1e3
    tokens = TRAIN_MESH_BATCH * TRAIN_SEQ
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        cards=len(set(devices)), devices=[str(d) for d in devices],
        shard_s=shard_s, shards_hold_their_slices=slices_ok,
        value_and_grad_s=vg_s,
        value_and_grad_loss_rel_err=vg_loss_rel,
        sampled_grad_rel_err=sample_errs,
        sampled_grad_rel_tol=TRAIN_MESH_GRAD_REL_TOL, layout=layout,
        steps=steps, launches=totals,
        expected_launches_per_step=dict(zip(("fwd", "dq", "dkv"), want)),
        loss_rel_err=loss_rel, grad_norm_rel_err=gnorm_rel,
        steady_step_ms=steady_s * 1e3, tokens_per_s=tokens / steady_s,
        model_flops_utilization=(cfg.flops_per_token(TRAIN_SEQ) * tokens
                                 / steady_s / PEAK_FLOPS[torch.bfloat16]),
        # Device time summed over the cards; the idle share is the cards'
        # mean.
        profiled_step=dict(
            step=last["step"], wall_ms=last["step_ms"],
            device_ms=split if busy else "not measured",
            idle_share=(1 - busy / (last["step_ms"] * len(set(devices)))
                        if busy else "not measured"),
            top_kernels=top),
        peak_memory_gb=peak,
        current_device_kept=torch.cuda.current_device() == current)


def plan_summary(plan, runs) -> dict:
    """The planner's per-position figures in GB, and what one card holds
    when every position shares it: the state once plus one position's
    activations, logits and workspace."""
    extra = plan.activation_bytes + plan.logits_bytes + plan.workspace_bytes
    return dict(position_state_gb=plan.state_bytes / 1e9,
                position_activations_gb=plan.activation_bytes / 1e9,
                position_logits_gb=plan.logits_bytes / 1e9,
                position_workspace_gb=plan.workspace_bytes / 1e9,
                position_total_gb=plan.total_bytes / 1e9,
                one_card_gb=(4 * runs[0]["layout"]["unsharded_params_bytes"]
                             + extra) / 1e9,
                card_gb=plan.hbm_bytes / 1e9)


def unsharded_reference(cfg, batch) -> tuple:
    """The unsharded pass of the seed-0 params on ``batch``: params, grads
    and the whole batch's logits, no optimizer state. (ref: the loss, the
    grad norm and the sampled gradients, kept; a summary.)"""
    cuda0 = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(cuda0).manual_seed(0), cuda0)
    loss, grads = value_and_grad(params, batch, cfg, device="cuda")
    ref = dict(loss=float(loss), grad_norm=float(global_norm(grads)),
               grads={path: _sample(grads, path)
                      for path in TRAIN_MESH_SAMPLE},
               wk_sha256=_leaf_sha256(params["layers"]["attn"]["wk"]))
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return ref, dict(loss=ref["loss"], grad_norm=ref["grad_norm"],
                     seconds=time.perf_counter() - t0,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def train_mesh_phase(card: str, failures: list, train: dict) -> tuple:
    """Training on a dp x fsdp x tp mesh (see the module docstring)."""
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    t_phase = time.perf_counter()
    tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    cuda0 = torch.device("cuda", 0)
    ref, unsharded = unsharded_reference(cfg, batch)
    plan = plan_train_memory(cfg, MeshSpec(**TRAIN_MESH),
                             global_batch=TRAIN_MESH_BATCH,
                             seq_len=TRAIN_SEQ)
    runs = [train_mesh_run(cfg, [cuda0] * 8, batch, ref, failures, True,
                           plan)]
    count = torch.cuda.device_count()
    if count >= 2:
        n = max(k for k in (2, 4, 8) if k <= count)
        devices = [torch.device("cuda", i) for i in range(n)
                   for _ in range(8 // n)]
        runs.append(train_mesh_run(cfg, devices, batch, ref, failures,
                                   False, plan))
    res = dict(
        phase="train_mesh", preset="8b-gqa", mesh=TRAIN_MESH,
        batch=TRAIN_MESH_BATCH, seq_len=TRAIN_SEQ, remat=cfg.remat,
        device_count=count,
        ran=[dict(cards=r["cards"]) for r in runs], unsharded=unsharded,
        runs=runs,
        launches=runs[0]["launches"], plan=plan_summary(plan, runs),
        train=dict(steady_step_ms=train["steady_step_ms"],
                   tokens_per_s=train["tokens_per_s"],
                   model_flops_utilization=train["model_flops_utilization"]),
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res, ref


def train_rules_phase(card: str, failures: list, ref: dict) -> dict:
    """train_mesh's training under other rule tables (see the module
    docstring): one train_mesh_run a table, held to train_mesh's
    unsharded pass ``ref``."""
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    t_phase = time.perf_counter()
    tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    cuda0 = torch.device("cuda", 0)
    state_bytes = 4 * plan_train_memory(
        cfg, MeshSpec(), global_batch=TRAIN_MESH_BATCH, seq_len=TRAIN_SEQ,
        hbm_gib=0.0).params_bytes

    def plan_of(over):
        return plan_train_memory(
            cfg, MeshSpec(**TRAIN_MESH), global_batch=TRAIN_MESH_BATCH,
            seq_len=TRAIN_SEQ,
            rules=LogicalAxisRules.default().with_overrides(*over))

    def one_card(plan):
        """The planner's figure for the mesh on one card: the state once
        and one position's activations, logits and workspace."""
        return (state_bytes + plan.activation_bytes + plan.logits_bytes
                + plan.workspace_bytes)

    def run(name, over):
        plan = plan_of(over)
        out = train_mesh_run(
            cfg, [cuda0] * 8, batch, ref, failures, True, plan,
            name=f"train_rules {name}", steps=TRAIN_RULES_STEPS,
            rules=LogicalAxisRules.default().with_overrides(*over),
            profiled_step=name == TRAIN_RULES[0][0])
        out.update(table=name, overrides=[list(o) for o in over],
                   batch_groups=len(build_mesh(
                       MeshSpec(**TRAIN_MESH), devices=[cuda0] * 8
                   ).batch_groups(LogicalAxisRules.default().with_overrides(
                       *over))),
                   plan=plan_summary(plan, [out]))
        return out
    runs = [run(name, over) for name, over in TRAIN_RULES]
    name, over = TRAIN_RULES_IF_IT_FITS
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    first = TRAIN_RULES[0][1]
    expected = (max(runs[0]["peak_memory_gb"]) * 1e9
                + one_card(plan_of(over)) - one_card(plan_of(first)))
    fits = expected <= (1 - TRAIN_RULES_HEADROOM) * card_bytes
    if fits:
        runs.append(run(name, over))
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in ("fwd", "dq", "dkv")}
    res = dict(phase="train_rules", preset="8b-gqa", mesh=TRAIN_MESH,
               batch=TRAIN_MESH_BATCH, seq_len=TRAIN_SEQ,
               steps=TRAIN_RULES_STEPS,
               if_it_fits=dict(table=name, ran=fits,
                               expected_peak_gb=expected / 1e9,
                               card_gb=card_bytes / 1e9,
                               headroom=TRAIN_RULES_HEADROOM),
               runs=runs, launches=launches,
               loss_rel_tol=TRAIN_LOSS_REL_TOL,
               grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
               seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


def rules_memory(eng, params, rules) -> dict:
    """Where a serving engine under ``rules`` keeps the weights: each
    position's stored tensors (``eng._stored``) of the shapes the table's
    specs give, on the card; the distinct tensors' bytes the params' (one
    card: each slice once), a whole tensor the params' own (same
    data_ptr); its pools against the unsharded pool's bytes."""
    mesh = eng.mesh
    whole = dict(_named_leaves(params))
    specs = _dict_leaves(tree_specs(transformer.param_logical_axes(None),
                                    mesh, rules))
    distinct, bad, own = {}, [], True
    for coord, tree in zip(mesh.coords(), eng._stored):
        for name, t in _named_leaves(tree):
            distinct[id(t)] = t
            want = tuple(x.stop - x.start for x in shard_slices(
                specs[name], whole[name].shape, mesh, coord))
            if tuple(t.shape) != want:
                bad.append((name, tuple(t.shape), want))
            if t.shape == whole[name].shape:
                own &= t.data_ptr() == whole[name].data_ptr()
    held = sum(t.nbytes for t in distinct.values())
    total = sum(t.nbytes for t in whole.values())
    on_card = all(t.is_cuda for t in distinct.values())
    return dict(ok=not bad and own and on_card and held == total,
                shape_mismatches=bad[:5], whole_tensors_not_copied=own,
                on_card=on_card, held_gb=held / 1e9, params_gb=total / 1e9,
                pools_gb=sum(t.nbytes for t in eng._pk + eng._pv) / 1e9,
                compute=[type(p).__name__ for p in eng._shards])


def serve_rules_phase(card: str, failures: list, params) -> dict:
    """Serving under the reference's default table (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    L = cfg.num_layers
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)              # the serve phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    flat = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    with uncounted(), torch.no_grad():
        refs = [(*plain_logits(params, cfg, p, flat._bucket(len(p))),
                 flat._run_prefill(p)[0]) for p in prompts]
        flat_outs = flat.generate(prompts, sp)
    cuda0 = torch.device("cuda", 0)
    rules = LogicalAxisRules.default()
    runs = []
    for name, spec in SERVE_RULES:
        t_run = time.perf_counter()
        what = f"{name} under LogicalAxisRules.default()"
        n, tp = MeshSpec(**spec).n_devices, spec["tp"]

        def fail(section, detail):
            failures.append(f"serve_rules {what} {section}: {detail}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = LLMEngine(cfg, params, device="cuda", mesh=build_mesh(
            MeshSpec(**spec), devices=[cuda0] * n), rules=rules,
            **SERVE_RULES_ENGINE)
        memory = rules_memory(eng, params, rules)
        if not memory["ok"]:
            fail("memory", memory)
        waves = keep_sampled_logits(eng)
        torch.cuda.synchronize()
        flash_attention_fwd.launches = 0
        ids = [eng.add_request(p, sp) for p in prompts]
        eng.step()                  # admission, then one decode step
        firsts = {}
        for rid, tok, _ in eng.take_tick_events():
            firsts.setdefault(rid, tok)
        outs, _, step_ms = run_timed(eng)
        launches = {"wave": dict(got=flash_attention_fwd.launches,
                                 want=len(prompts) * L * tp)}
        checks, tokens = [], []
        if [len(w) for w in waves] != [len(prompts)]:
            fail("admission waves", [len(w) for w in waves])
        else:
            for rid, p, logits, ref in zip(ids, prompts, waves[0], refs):
                checks.append(dict(sp_check(logits, firsts.get(rid, -1),
                                            *ref, what, failures,
                                            phase="serve_rules",
                                            base="unsharded"),
                                   prompt_len=len(p)))
        for rid, p, want in zip(ids, prompts, flat_outs):
            tokens.append(mesh_tokens(eng, flat, p, outs.get(rid, []),
                                      want))
            if not tokens[-1]["ok"]:
                fail("tokens", (rid, tokens[-1]))
        # The longest prompt again: a resident prefix hit, no launch.
        flash_attention_fwd.launches = 0
        rid = eng.add_request(prompts[-1], sp)
        req = eng._requests[rid]
        hit_out = run_timed(eng)[0].get(rid, [])
        launches["hit"] = dict(got=flash_attention_fwd.launches, want=0)
        hit = dict(prefix_len=req.prefix_len,
                   tokens=mesh_tokens(eng, flat, prompts[-1], hit_out,
                                      flat_outs[-1]))
        if not (req.prefix_len > 0 and hit["tokens"]["ok"]):
            fail("prefix hit", hit)
        if any(v["got"] != v["want"] for v in launches.values()):
            fail("kernel 1 launches", launches)
        with uncounted(), torch.no_grad():
            prefill_ms = host_ms(lambda: eng._run_prefill(prompts[-1]),
                                 iters=1)
        runs.append(dict(
            layout=name, mesh=spec, devices=[str(cuda0)] * n,
            memory=memory, launches=launches,
            flash_launches=sum(v["got"] for v in launches.values()),
            logits=checks, tokens=tokens, hit=hit,
            decode_step_ms=step_ms,
            decode_step_ms_median=float(np.median(step_ms)),
            prefill_1900_ms=prefill_ms,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            seconds=time.perf_counter() - t_run))
        del eng, waves
        gc.collect()
        torch.cuda.empty_cache()
    del flat, refs
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(phase="serve_rules", preset="8b-gqa",
               engine=SERVE_RULES_ENGINE, prompt_lens=list(PROMPT_LENS),
               rules="LogicalAxisRules.default()", runs=runs,
               flash_launches=sum(r["flash_launches"] for r in runs),
               logits_rel_tol=LOGITS_REL_TOL,
               seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


@contextlib.contextmanager
def launches_per_call(owner, name: str, key=lambda out, *a, **k: None):
    """Wrap ``owner.name`` so that each call's kernel 1 launches are kept,
    as (key(its result, *its args), launches) in call order; restore it
    after."""
    calls = []
    orig = getattr(owner, name)

    def counted(*a, **k):
        before = flash_attention_fwd.launches
        out = orig(*a, **k)
        calls.append((key(out, *a, **k),
                      flash_attention_fwd.launches - before))
        return out
    setattr(owner, name, counted)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def perf_payload_checks(failures: list) -> dict:
    """The device channel's and the KV handoff's payloads on the card, after
    the timed run: the device payload back as the same tensor, the host
    one and the 64 MiB blob bit-equal, with the copy audit's deltas; the
    rung-0 registry empty."""
    dev = torch.device("cuda", 0)
    ctx = serialization.get_context()
    n = perf._DEV_PAYLOAD_ELEMS
    buf = perf._host_buffer(n * 4 + (1 << 16), dev)
    out = {}
    for kind, payload in (("dev", torch.arange(n, dtype=torch.float32,
                                               device=dev)),
                          ("host", np.arange(n, dtype=np.float32))):
        before = device_plane.device_copy_stats()
        got = perf._channel_step(ctx, payload, buf)
        same = (got.data_ptr() == payload.data_ptr() if kind == "dev"
                else bool(np.array_equal(got, payload)))
        out[kind] = dict(bit_equal=same, audit=_dp_delta(before))
        if not same:
            failures.append(f"perf device channel ({kind}): the payload "
                            f"came back changed")
    blob = perf._kv_blob(64, dev)
    hbuf = perf._host_buffer((64 << 20) + (1 << 16), dev)
    before = device_plane.device_copy_stats()
    got = perf._kv_handoff_round(ctx, blob, hbuf, dev)
    audit = _dp_delta(before)
    equal = all(got[k].device == dev and torch.equal(got[k], blob[k])
                for k in ("k", "v")) and got["len"] == blob["len"]
    want = 64 << 20
    out["kv_handoff"] = dict(bit_equal=equal, audit=audit)
    if not equal or audit["device_to_host_bytes"] != want \
            or audit["host_to_device_bytes"] != want:
        failures.append(f"perf kv handoff: bit_equal {equal}, audit {audit}")
    out["local_registry_size"] = device_plane.local_registry_size()
    if out["local_registry_size"]:
        failures.append(f"perf: {out['local_registry_size']} rung-0 tokens "
                        f"left registered")
    return out


def perf_phase(card: str, failures: list, params) -> dict:
    """The port's engine and device-plane rows on the card (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    L = cfg.num_layers
    t_phase = time.perf_counter()
    results, details, launches, groups = {}, {}, {}, {}

    def fail(what, detail):
        failures.append(f"perf {what}: {detail}")
    for name, rows in PERF_GROUPS:
        t_group = time.perf_counter()
        with contextlib.ExitStack() as stack:
            prefills = stack.enter_context(launches_per_call(
                LLMEngine, "_run_prefill",
                lambda out, eng, *a: eng.max_batch))
            flat = stack.enter_context(launches_per_call(
                llm_engine, "_prefill_fn"))
            sp = stack.enter_context(launches_per_call(
                llm_sp, "sp_prefill_fn"))
            paged = stack.enter_context(launches_per_call(
                LLMEngine, "prefill_paged"))
            firsts = stack.enter_context(launches_per_call(
                llm_sp, "_long_context_first",
                lambda out, pre, dec, prompt, spp, kw: (kw["host_staged"],
                                                        out[1])))
            torch.cuda.synchronize()
            flash_attention_fwd.launches = 0
            try:
                results.update(perf.run_microbenchmarks(
                    PERF_MIN_TIME_S, only=rows, cfg=cfg, params=params,
                    device="cuda", details=details))
            except Exception as e:  # noqa: BLE001 — a failed row fails
                fail(name, repr(e))
            got = flash_attention_fwd.launches
        launches[name] = got
        tokens = [k for k, _ in firsts]
        groups[name] = dict(
            seconds=time.perf_counter() - t_group, launches=got,
            full_prefills=collections.Counter(k for k, _ in prefills),
            launches_per_prefill=sorted({n for _, n in prefills}))
        want = 0                        # no kernel 1 on the device rows
        if name in ("serving", "pd_serving"):
            # Every request is a full prefill (3 tokens < a page), run by
            # the serving replica or by the P/D pair's prefill replica
            # (max_batch 1) only.
            on = 1 if name == "pd_serving" else 4
            want = PERF_OPEN_LOOP_REQUESTS * L
            if dict(groups[name]["full_prefills"]) \
                    != {on: PERF_OPEN_LOOP_REQUESTS} \
                    or any(n != L for _, n in prefills):
                fail(f"{name} prefills", groups[name])
            ol = details.get(name, {}).get("open_loop", {})
            groups[name]["open_loop"] = {
                k: ol.get(k) for k in ("offered", "completed", "shed",
                                       "broken", "errors", "unfinished",
                                       "tokens_total", "max_inflight",
                                       "ttft_p99_ms", "itl_p50_ms",
                                       "itl_p99_ms", "duration_s")}
            if not ol or ol["shed"] or ol["broken"] or ol["errors"] \
                    or ol["unfinished"] or ol["tokens_total"] \
                    != ol["completed"] * 16:
                fail(f"{name} open loop", groups[name]["open_loop"])
        elif name == "long_context":
            # Degree 1 runs kernel 1 (32 a prefill); the degree-4 SP
            # prefill and the paged path run plain attention.
            want = len(flat) * L
            groups[name].update(
                flat_prefill=dict(calls=len(flat),
                                  launches=[n for _, n in flat]),
                sp_prefill=dict(calls=len(sp), launches=[n for _, n in sp]),
                prefill_paged=dict(calls=len(paged),
                                   launches=[n for _, n in paged]),
                first_tokens=tokens)
            if not flat or any(n != L for _, n in flat) or not sp \
                    or any(n for _, n in sp) or not paged \
                    or any(n for _, n in paged):
                fail("long-context launches", groups[name])
            if len({t for _, t in tokens}) != 1 \
                    or {s for s, _ in tokens} != {False, True}:
                fail("long-context first tokens (staged and direct)",
                     tokens)
        elif name == "kv_pressure":
            kv = details.get(name, {})
            counts = {k: (kv[k]["hits"], kv[k]["misses"]) for k in
                      PERF_KV_COUNTS if k in kv}
            groups[name]["hits_misses"] = counts
            if counts != PERF_KV_COUNTS:
                fail("prefix-cache hits and misses", counts)
            groups[name]["stats"] = kv
            want = None         # the misses' prefills: printed, no gate
        if want is not None and got != want:
            fail(f"{name} kernel 1 launches", dict(got=got, want=want))
    groups["long_context"]["row"] = {
        k: details.get("long_context", {}).get(k)
        for k in ("sp_degree", "sp_speedup")}
    payload = perf_payload_checks(failures)
    seconds = time.perf_counter() - t_phase
    if seconds > PERF_PHASE_S:
        fail("phase time", f"{seconds:.1f} s > {PERF_PHASE_S} s")
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(phase="perf", preset="8b-gqa", min_time_s=PERF_MIN_TIME_S,
               rows=results, groups=groups, payload=payload,
               flash_launches=sum(launches.values()),
               seconds=seconds, card=card)
    emit(res)
    return res


class IdTokenizer:
    """Text of token ids ("12 7 31 ") and back, so that a completion's text
    gives its tokens exactly (the byte-level default folds every id above
    258 into one byte). A word that is not a number takes an id from its
    bytes."""

    def encode(self, text: str) -> list:
        return [int(w) if w.isdigit() else 1 + sum(w.encode()) % 1000
                for w in text.split()]

    def decode(self, tokens) -> str:
        return "".join(f"{t} " for t in tokens)


def http(method: str, path: str, body=None, raw: bytes = None):
    return serve.Request(method, path, {}, {},
                         raw if raw is not None else json.dumps(body).encode())


def sse_frames(host: Hosted, server, resp, limit=None) -> dict:
    """Consume a StreamingResponse of ``server`` on its host's loop:
    the parsed frames, the text of the deltas, the final finish reason and
    the host-clock arrival of each frame; ``limit`` leaves after that many
    frames (a client that goes away)."""
    t0 = time.perf_counter()
    it = host.stream(getattr(server, resp.method)(*resp.args, **resp.kwargs))
    frames, stamps = [], []
    try:
        for frame in it:
            stamps.append((time.perf_counter() - t0) * 1e3)
            body = frame[len("data: "):].strip()
            frames.append(body if body == "[DONE]" else json.loads(body))
            if limit and len(frames) >= limit:
                break
    finally:
        it.close()
    chunks = [f["choices"][0] for f in frames if isinstance(f, dict)]
    text = "".join(c.get("text") or c.get("delta", {}).get("content", "")
                   for c in chunks if c["finish_reason"] is None)
    return dict(frames=frames, text=text,
                finish=[c["finish_reason"] for c in chunks
                        if c["finish_reason"]],
                done=frames[-1:] == ["[DONE]"], stamps_ms=stamps)


# The reference's error requests: (method, path, body or raw bytes, status,
# message).
APPS_ERRORS = (
    ("POST", "/v1/chat/completions", {"messages": []}, 400,
     "messages is required"),
    ("POST", "/v1/completions", {"max_tokens": 4}, 400,
     "prompt is required"),
    ("POST", "/v1/completions", {"prompt": "1", "max_tokens": "many"}, 400,
     "max_tokens/temperature must be numbers"),
    ("POST", "/v1/completions", b"{not json", 400, "invalid JSON body"),
    ("GET", "/v1/completions", b"", 405, "method GET not allowed"),
    ("POST", "/v1/embeddings", {"input": "1"}, 404,
     "no route for /v1/embeddings"),
    ("POST", "/v1/completions", {"prompt": ["1", "2"], "stream": True}, 400,
     "stream=true supports a single prompt"),
)


def shard_buffers_released(shards, wait_s: float = 5.0) -> list:
    """Each shard's live buffer count, once it reaches 0 or ``wait_s``
    passes: a thread that carried the last step may still be returning."""
    end = time.monotonic() + wait_s
    while True:
        n = [len(s.buffers) for s in shards]
        if not any(n) or time.monotonic() > end:
            return n
        time.sleep(0.01)


def serve_apps_phase(card: str, failures: list, params) -> dict:
    """The serving apps over the serve params (see the module
    docstring)."""
    cfg = PRESETS["8b-gqa"]
    L = cfg.num_layers
    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def words(p):
        return " ".join(map(str, p))

    def fail(what, detail):
        failures.append(f"serve_apps {what}: {detail}")
    # With several cards the prefill side and the decode side sit on two.
    pre_dev = torch.device("cuda", 0)
    dec_dev = torch.device("cuda", 1 if torch.cuda.device_count() > 1
                           else 0)
    ref = LLMEngine(cfg, params, device="cuda", **APPS_SERVER)
    launches, seconds = {}, {}

    def closed(prompts, n=MAX_TOKENS):
        with uncounted():
            return ref.generate(prompts, SamplingParams(max_tokens=n))

    def counted(section, full_prefills, t0):
        torch.cuda.synchronize()
        seconds[section] = time.perf_counter() - t0
        launches[section] = dict(got=flash_attention_fwd.launches,
                                 want=full_prefills * L)
        flash_attention_fwd.launches = 0

    # OpenAIServer, on the loop of its replica's host.
    tk = IdTokenizer()
    server = OpenAIServer(cfg, params, tokenizer=tk, device=pre_dev,
                          **APPS_SERVER)
    host = Hosted(server.serving)
    ms = {}

    def ask(name, method, path, body=None):
        t = time.perf_counter()
        req = http(method, path, None if isinstance(body, bytes) else body,
                   body if isinstance(body, bytes) else None)
        resp = host.call(server(req), 300)
        ms[name] = (time.perf_counter() - t) * 1e3
        return resp

    def ids(text):
        return [int(w) for w in text.split()]

    def chat_prompt(msgs):
        return tk.encode("\n".join(f"{m['role']}: {m['content']}"
                                   for m in msgs) + "\nassistant:")
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    models = ask("models", "GET", "/v1/models")
    single = toks(APPS_PROMPT_LENS[1])
    one = ask("completion", "POST", "/v1/completions",
              {"prompt": words(single), "max_tokens": MAX_TOKENS})
    wave = [toks(n) for n in APPS_PROMPT_LENS]
    three = ask("completions_x3", "POST", "/v1/completions",
                {"prompt": [words(p) for p in wave],
                 "max_tokens": MAX_TOKENS})
    max_active = host.debug_stats()["max_active"]
    msgs = [{"role": "system", "content": words(toks(20))},
            {"role": "user", "content": words(toks(200))}]
    chat = ask("chat", "POST", "/v1/chat/completions",
               {"messages": msgs, "max_tokens": MAX_TOKENS})
    sse_prompt = toks(APPS_PROMPT_LENS[0])
    sse_text = sse_frames(host, server, ask(
        "sse_completion", "POST", "/v1/completions",
        {"prompt": words(sse_prompt), "max_tokens": MAX_TOKENS,
         "stream": True}))
    sse_msgs = [{"role": "user", "content": words(toks(100))}]
    sse_chat = sse_frames(host, server, ask(
        "sse_chat", "POST", "/v1/chat/completions",
        {"messages": sse_msgs, "max_tokens": MAX_TOKENS, "stream": True}))
    left = sse_frames(host, server, ask(
        "sse_cancelled", "POST", "/v1/chat/completions",
        {"messages": [{"role": "user", "content": words(toks(64))}],
         "max_tokens": MAX_TOKENS, "stream": True}),
        limit=APPS_CANCEL_AFTER)
    for _ in range(1000):
        st = host.debug_stats()
        if st["active"] == st["queue_depth"] == 0:
            break
        time.sleep(0.01)
    errors = []
    for method, path, body, status, message in APPS_ERRORS:
        r = ask("error", method, path, body)
        errors.append(dict(path=path, method=method,
                           status=getattr(r, "status", None),
                           message=getattr(r, "body", {}).get(
                               "error", {}).get("message")))
        if errors[-1]["status"] != status or errors[-1]["message"] != message:
            fail("error response", errors[-1])
    counted("openai", 8, t0)
    got = {"completion": (single, ids(one["choices"][0]["text"])),
           "chat": (chat_prompt(msgs),
                    ids(chat["choices"][0]["message"]["content"])),
           "sse_completion": (sse_prompt, ids(sse_text["text"])),
           "sse_chat": (chat_prompt(sse_msgs), ids(sse_chat["text"]))}
    got.update({f"completions_x3[{i}]": (p, ids(c["text"]))
                for i, (p, c) in enumerate(zip(wave, three["choices"]))})
    # Each request alone, as the server ran it; the three of one request
    # in one wave, as the server admitted them.
    want = {name: closed([p])[0] for name, (p, _) in got.items()
            if not name.startswith("completions_x3")}
    want.update({f"completions_x3[{i}]": w
                 for i, w in enumerate(closed(wave))})
    for name, (prompt, tokens) in got.items():
        if tokens != want[name]:
            fail("OpenAI tokens", dict(request=name, **divergence(
                params, cfg, prompt, tokens, want[name])))
    finishes = ([c["finish_reason"] for c in one["choices"]
                 + three["choices"] + chat["choices"]]
                + sse_text["finish"] + sse_chat["finish"])
    usage_ok = (one["usage"] == {"prompt_tokens": len(single),
                                 "completion_tokens": MAX_TOKENS,
                                 "total_tokens": len(single) + MAX_TOKENS}
                and three["usage"]["completion_tokens"] == 3 * MAX_TOKENS
                and three["usage"]["prompt_tokens"] == sum(APPS_PROMPT_LENS))
    openai = dict(
        ms=ms, max_active=max_active, finishes=finishes,
        usage_ok=usage_ok, sse_frames=[len(sse_text["frames"]),
                                       len(sse_chat["frames"])],
        sse_first_frame_ms=[sse_text["stamps_ms"][0],
                            sse_chat["stamps_ms"][1]],
        cancelled_frames=len(left["frames"]), cancelled=st["cancelled"],
        completed=st["completed"],
        request_held_pages=request_held_pages(server.serving.engine),
        errors=errors,
        tokens_equal={k: v[1] == want[k] for k, v in got.items()})
    if not (models["data"][0]["id"] == server.model_name
            and max_active == 3 and usage_ok
            and finishes == ["length"] * 7
            and sse_text["done"] and sse_chat["done"]
            and sse_chat["frames"][0]["choices"][0]["delta"]
            == {"role": "assistant"}
            and len(sse_text["frames"]) == MAX_TOKENS + 2
            and len(sse_chat["frames"]) == MAX_TOKENS + 3
            and len(left["frames"]) == APPS_CANCEL_AFTER
            and st["cancelled"] == 1 and st["completed"] == 7
            and st["active"] == st["queue_depth"] == 0
            and openai["request_held_pages"] == 0):
        fail("OpenAI server", openai)
    host.shutdown()
    del server, host

    # CompiledPDApp: one lane, the blob through the lane's edge.
    t0 = time.perf_counter()
    pd = CompiledPDApp(cfg, params, seed=0, prefix_cache=True,
                       prefill_options={"device": pre_dev},
                       decode_options={"device": dec_dev}, device="cuda",
                       **APPS_PD)
    a, b = toks(APPS_PD_LEN), toks(APPS_PD_LEN)
    before = device_plane.device_copy_stats()
    t = time.perf_counter()
    gen = pd.generate(a, {"max_tokens": MAX_TOKENS}, timeout=300)
    gen_ms = (time.perf_counter() - t) * 1e3
    audit = _dp_delta(before)
    t, stamps, items = time.perf_counter(), [], []
    for item in pd.stream(b, {"max_tokens": MAX_TOKENS}, timeout=300):
        stamps.append((time.perf_counter() - t) * 1e3)
        items.append(item)
    dstats = pd.decodes[0].debug_stats()
    placed = dict(prefill=str(pd.prefills[0].replica.engine.device),
                  decode=str(pd.decodes[0].replica.engine.device),
                  decode_shares_params=pd.decodes[0].replica.engine.params
                  is params)
    held = [request_held_pages(h.replica.engine)
            for h in pd.prefills + pd.decodes]
    pd.shutdown()
    counted("compiled_pd", 2, t0)
    pd_want = closed([a]) + closed([b])
    blob_bytes = (2 * L * APPS_PD_LEN * cfg.num_kv_heads * cfg.head_dim_
                  * torch.finfo(cfg.dtype).bits // 8)
    compiled_pd = dict(
        generate_ms=gen_ms, stream_ttft_ms=stamps[0],
        stream_ms=stamps[-1], tokens_equal=[gen["tokens"] == pd_want[0],
                                            items[:-1] == pd_want[1]],
        terminal=items[-1], completed=dstats["completed"],
        audit=audit, blob_bytes=blob_bytes, placed=placed,
        request_held_pages=held)
    for name, got_t, w, p in (("generate", gen["tokens"], pd_want[0], a),
                              ("stream", items[:-1], pd_want[1], b)):
        if got_t != w:
            fail(f"compiled P/D {name} tokens",
                 divergence(params, cfg, p, got_t, w))
    if not (gen["finish_reason"] == "length"
            and items[-1] == {"finish_reason": "length",
                              "n_tokens": MAX_TOKENS}
            and dstats["completed"] == 2
            and audit["device_to_host_bytes"] == blob_bytes
            and audit["host_to_device_bytes"] == blob_bytes
            and placed["prefill"] == str(pre_dev)
            and placed["decode"] == str(dec_dev)
            and placed["decode_shares_params"] == (dec_dev == pre_dev)
            and held == [0, 0]):
        fail("compiled P/D", compiled_pd)
    del pd

    # LongContextApp: 2 shards' stripes, one decode replica.
    t0 = time.perf_counter()
    lc = LongContextApp(cfg, params, max_tokens=APPS_LC_TOKENS, seed=0,
                        prefill_options={"device": pre_dev},
                        decode_options={"device": dec_dev}, device="cuda",
                        **APPS_LC)
    prompt = toks(APPS_LC_LEN)
    opts = {"max_tokens": APPS_LC_TOKENS}
    t = time.perf_counter()
    handoff = lc.prefill(prompt, opts, timeout=300)
    torch.cuda.synchronize()
    lc_prefill_ms = (time.perf_counter() - t) * 1e3
    parts = handoff["parts"]
    stores = [p["handle"].store if isinstance(p["handle"], HostRef)
              else None for p in parts]
    shard_parts = [len(s.buffers) for s in lc.shards]
    dec = lc.decodes[0]
    t = time.perf_counter()
    rid = dec.call(dec.replica.admit_paged(handoff), 300)
    lc_items = list(dec.stream(dec.replica.collect_stream(rid), 300))
    lc_decode_ms = (time.perf_counter() - t) * 1e3
    lstats = lc.debug_stats()
    pool_tokens = dec.replica.engine.kv_pages_total * APPS_LC["page_size"]
    spans, lc_first, lc_len = ([p["span"] for p in parts], handoff["first"],
                               handoff["len"])
    # A stripe lives as long as its handle: with the request done and the
    # handoff dropped, every shard's buffers are free before shutdown.
    buffers_held = [len(s.buffers) for s in lc.shards]
    del handoff, parts
    buffers_released = shard_buffers_released(lc.shards)
    lc.shutdown()
    counted("long_context", 0, t0)
    with uncounted():
        eng = LLMEngine(cfg, params, device="cuda", max_batch=1,
                        max_len=APPS_LC["max_len"],
                        page_size=APPS_LC["page_size"],
                        kv_gather_window=APPS_LC["kv_gather_window"])
        lsp = SamplingParams(max_tokens=APPS_LC_TOKENS)
        eh = eng.prefill_paged(prompt, lsp, span=APPS_LC["span"])
        lc_want = eng.decode_paged(eh, lsp)
        del eng, eh
    gather = lstats["decodes"][0]["kv_gather"]
    long_context = dict(
        parts=spans, shard_parts=shard_parts,
        first_equal=lc_first == lc_want[0] if lc_want else None,
        tokens_equal=lc_items[:-1] == lc_want, terminal=lc_items[-1],
        prefill_ms=lc_prefill_ms, decode_ms=lc_decode_ms, gather=gather,
        decode_pool_tokens=pool_tokens,
        pools_free=[(s["kv_pages_free"], s["kv_pages_total"])
                    for s in lstats["shards"] + lstats["decodes"]],
        buffers_held_after_decode=buffers_held,
        buffers_released=buffers_released,
        buffers_after=[len(s.buffers) for s in lc.shards])
    n_parts = math.ceil(APPS_LC_LEN / APPS_LC["span"])
    if lc_items[:-1] != lc_want:
        fail("long-context tokens", divergence(params, cfg, prompt,
                                               lc_items[:-1], lc_want))
    if not (len(spans) == n_parts and lc_len == APPS_LC_LEN
            and stores == [lc.shards[c % 2].buffers for c in range(n_parts)]
            and shard_parts == [3, 3]
            and lc_items[-1] == {"finish_reason": "length",
                                 "n_tokens": APPS_LC_TOKENS}
            and pool_tokens < APPS_LC_LEN
            and gather["fetches"] == n_parts and gather["refetches"] == 0
            and gather["bytes"] > 0 and gather["resident"] == 0
            and all(f == t for f, t in long_context["pools_free"])
            and buffers_held == [3, 3] and buffers_released == [0, 0]
            and long_context["buffers_after"] == [0, 0]):
        fail("long context", long_context)
    del lc, stores

    for section, n in launches.items():
        if n["got"] != n["want"]:
            fail("kernel 1 launches", f"{section}: {n}")
    total = time.perf_counter() - t_phase
    if total > SERVE_APPS_PHASE_S:
        fail("phase time", f"{total:.1f} s > {SERVE_APPS_PHASE_S} s")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(phase="serve_apps", preset="8b-gqa", server=APPS_SERVER,
               openai=openai, compiled_pd=compiled_pd,
               long_context=long_context, launches_by_section=launches,
               flash_launches=sum(n["got"] for n in launches.values()),
               section_seconds=seconds, seconds=total, card=card)
    emit(res)
    return res


def train_pp_phase(card: str, failures: list, train: dict,
                   train_mesh: dict, ref: dict) -> dict:
    """Training on a pp x dp x tp mesh (see the module docstring), held
    against train_mesh's unsharded pass ``ref`` on the same params and
    batch."""
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    t_phase = time.perf_counter()
    tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    cuda0 = torch.device("cuda", 0)
    # The kept reference samples (2.6 GB) wait in pinned host memory: a
    # group's two microbatches hold twice train_mesh's logits, and the
    # steps came within 6 GB of the card's memory with them on it.
    ref["grads"] = {path: torch.empty(g.shape, dtype=g.dtype,
                                      pin_memory=True).copy_(g)
                    for path, g in ref["grads"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    plan = plan_train_memory(cfg, MeshSpec(**TRAIN_PP),
                             global_batch=TRAIN_MESH_BATCH,
                             seq_len=TRAIN_SEQ,
                             num_microbatches=TRAIN_PP_MICROBATCHES)
    run = functools.partial(train_mesh_run, spec=TRAIN_PP,
                            microbatches=TRAIN_PP_MICROBATCHES,
                            ranges=TRAIN_PP_RANGES, name="train_pp")
    runs = [run(cfg, [cuda0] * 8, batch, ref, failures, True, plan)]
    count = torch.cuda.device_count()
    if count >= 2:
        # The grid in order, each card named 8/n times: the stage boundary
        # falls between cards, as do the dp replicas.
        n = max(k for k in (2, 4, 8) if k <= count)
        devices = [torch.device("cuda", i) for i in range(n)
                   for _ in range(8 // n)]
        runs.append(run(cfg, devices, batch, ref, failures, False, plan))
    res = dict(
        phase="train_pp", preset="8b-gqa", mesh=TRAIN_PP,
        num_microbatches=TRAIN_PP_MICROBATCHES, batch=TRAIN_MESH_BATCH,
        seq_len=TRAIN_SEQ, remat=cfg.remat, device_count=count,
        ran=[dict(cards=r["cards"]) for r in runs], runs=runs,
        launches=runs[0]["launches"], plan=plan_summary(plan, runs),
        train=dict(steady_step_ms=train["steady_step_ms"],
                   tokens_per_s=train["tokens_per_s"],
                   model_flops_utilization=train["model_flops_utilization"]),
        train_mesh=dict(
            steady_step_ms=train_mesh["runs"][0]["steady_step_ms"],
            tokens_per_s=train_mesh["runs"][0]["tokens_per_s"],
            model_flops_utilization=train_mesh["runs"][0][
                "model_flops_utilization"]),
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


def train_sp_flash(cfg, devices, batch, ref, failures) -> dict:
    """One value_and_grad with the flash kernels on the train_sp mesh over
    ``devices``: kernels 1-3 launched per layer, batch group and tp
    position (kernel 1 in the forward and in the recompute), the loss and
    the sampled gradients against ``ref``'s."""
    what = f"train_sp flash on {len(set(devices))} card(s)"
    mesh = build_mesh(MeshSpec(**TRAIN_SP), devices=devices)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(devices[0]).manual_seed(0),
                         devices[0])
    shards = shard_params(params, mesh)
    specs = tree_specs(transformer.param_logical_axes(cfg), mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    per = cfg.num_layers * len(mesh.batch_groups()) * mesh.shape["tp"]
    want = (2 * per, per, per)
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    before = _launch_counts()
    loss, grads = value_and_grad(shards, batch, cfg, device="cuda",
                                 mesh=mesh)
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(_launch_counts(), before))
    vg_s = time.perf_counter() - t0
    errs = {}
    for path in TRAIN_MESH_SAMPLE:
        got = gather_sample(grads, path, specs, mesh, cfg, devices[0])
        want_g = ref["grads"][path].to(devices[0])
        errs[".".join(map(str, path))] = (
            torch.linalg.vector_norm(got.float() - want_g.float())
            / torch.linalg.vector_norm(want_g, dtype=torch.float32)).item()
        del got, want_g
    loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    peak = [torch.cuda.max_memory_allocated(i) / 1e9
            for i in range(torch.cuda.device_count())]
    del shards, grads
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(errs, key=errs.get)
    if launches != want:
        failures.append(f"{what}: launched (fwd, dq, dkv) {launches}, "
                        f"expected {want}")
    if not (errs[worst] <= TRAIN_MESH_GRAD_REL_TOL
            and loss_rel <= TRAIN_LOSS_REL_TOL):
        failures.append(f"{what}: loss rel {loss_rel}, sampled gradient "
                        f"{worst} {errs[worst]}")
    return dict(cards=len(set(devices)),
                launches=dict(zip(("fwd", "dq", "dkv"), launches)),
                expected_launches=dict(zip(("fwd", "dq", "dkv"), want)),
                loss_rel_err=loss_rel, sampled_grad_rel_err=errs,
                value_and_grad_s=vg_s, peak_memory_gb=peak)


def train_sp_phase(card: str, failures: list, train: dict,
                   train_mesh: dict, ref: dict) -> dict:
    """Training on a dp x sp x tp mesh with ring attention, then one flash
    value_and_grad on it (see the module docstring), held against
    train_mesh's unsharded pass ``ref``, whose sampled gradients
    train_pp left in pinned host memory."""
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="ring")
    t_phase = time.perf_counter()
    tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    cuda0 = torch.device("cuda", 0)
    plan = plan_train_memory(cfg, MeshSpec(**TRAIN_SP),
                             global_batch=TRAIN_MESH_BATCH,
                             seq_len=TRAIN_SEQ)
    run = functools.partial(train_mesh_run, spec=TRAIN_SP,
                            name="train_sp", steps=TRAIN_SP_STEPS)
    flash_cfg = dataclasses.replace(cfg, attention_impl="flash")
    grids = [[cuda0] * 8]
    count = torch.cuda.device_count()
    if count >= 2:
        # The grid in order, each card named 8/n times: the dp replicas
        # and the sp positions of a slice fall on different cards.
        n = max(k for k in (2, 4, 8) if k <= count)
        grids.append([torch.device("cuda", i) for i in range(n)
                      for _ in range(8 // n)])
    runs, flash = [], []
    for devices in grids:
        one_card = len(set(devices)) == 1
        runs.append(run(cfg, devices, batch, ref, failures, one_card, plan))
        flash.append(train_sp_flash(flash_cfg, devices, batch, ref,
                                    failures))
    res = dict(
        phase="train_sp", preset="8b-gqa", mesh=TRAIN_SP,
        attention_impl=cfg.attention_impl, batch=TRAIN_MESH_BATCH,
        seq_len=TRAIN_SEQ, steps=TRAIN_SP_STEPS, remat=cfg.remat,
        device_count=count, ran=[dict(cards=r["cards"]) for r in runs],
        runs=runs, flash=flash,
        launches=flash[0]["launches"], plan=plan_summary(plan, runs),
        train_mesh=dict(
            steady_step_ms=train_mesh["runs"][0]["steady_step_ms"],
            tokens_per_s=train_mesh["runs"][0]["tokens_per_s"]),
        train=dict(steady_step_ms=train["steady_step_ms"]),
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        sampled_grad_rel_tol=TRAIN_MESH_GRAD_REL_TOL,
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# One process per GPU: the collective group and the per-rank train step
# ---------------------------------------------------------------------------

def _free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_start(rank: int, world: int, port: int):
    """A spawned rank's start: it must not have imported JAX or the JAX
    package, then it pins cuda:rank and joins the NCCL world through the
    Train backend."""
    bad = [m for m in ("jax", "ray_tpu") if m in sys.modules]
    if bad:
        raise RuntimeError(f"rank {rank} imported {bad}")
    backend = _TorchBackend(TorchConfig("nccl"))
    backend.on_start(dict(world_rank=rank, world_size=world,
                          local_rank=rank, master_addr="localhost",
                          master_port=port))
    return backend


def _rank_main(target, rank: int, world: int, port: int, args, results):
    """A spawned rank: ``target(rank, world, *args)`` inside the backend's
    world; its result, or its traceback, goes to ``results``. A rank that
    raises also exits non-zero, its traceback on stderr."""
    import traceback
    backend = None
    try:
        backend = _rank_start(rank, world, port)
        results.put((rank, "ok", target(rank, world, *args)))
    except BaseException:
        tb = traceback.format_exc()
        print(f"rank {rank}:\n{tb}", file=sys.stderr, flush=True)
        results.put((rank, "error", tb))
        raise
    finally:
        if backend is not None:
            backend.on_shutdown()


def run_ranks(name: str, target, args, failures: list,
              timeout_s: float, world=None) -> list:
    """``target`` in ``world`` (default ``torch.cuda.device_count()``)
    spawned ranks, one a card (NCCL refuses two ranks on one GPU), each
    bounded by ``timeout_s``: their results in rank order, or None for a
    rank that raised, hung or exited non-zero (a failure each; the others
    are then killed). The parent frees its cached CUDA memory first."""
    gc.collect()
    torch.cuda.empty_cache()
    world = world or torch.cuda.device_count()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"{name}-rank{r}",
                         args=(target, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = [None] * world
    deadline = time.monotonic() + timeout_s
    try:
        for _ in range(world):
            try:
                rank, status, value = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                missing = [r for r in range(world) if out[r] is None]
                failures.append(f"{name}: no result from ranks {missing} "
                                f"within {timeout_s} s")
                break
            if status == "ok":
                out[rank] = value
            else:
                failures.append(f"{name}: rank {rank} raised:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                failures.append(f"{name}: {p.name} still running, killed")
                p.kill()
                p.join(timeout=10)
            elif p.exitcode != 0:
                failures.append(f"{name}: {p.name} exited {p.exitcode}")
    return out


def _collective_rank(rank: int, world: int) -> dict:
    """Every op of an NCCL TorchCollectiveGroup on CUDA tensors against
    numpy: all four allreduce ops, allgather, broadcast, barrier,
    reducescatter at an even and an uneven length, reduce, and send/recv
    where world >= 2; then, where world >= 2, the bus bandwidth of a
    256 MiB bf16 all-reduce."""
    g = collective.init_collective_group(world, rank, backend="nccl",
                                         group_name="chip_smoke")
    mine = [np.arange(6, dtype=np.float32) + 1.5 * r + 1
            for r in range(world)]
    checks = {}

    def check(what, got, want):
        got = got.cpu().numpy() if torch.is_tensor(got) else got
        checks[what] = bool(np.array_equal(got, want))
    for op, fn in (("sum", np.sum), ("product", np.prod), ("min", np.min),
                   ("max", np.max)):
        got = g.allreduce(mine[rank], op)
        checks[f"allreduce_{op}_on_card"] = got.device.type == "cuda"
        check(f"allreduce_{op}", got, fn(np.stack(mine), axis=0))
    check("allgather", g.allgather(mine[rank]), np.stack(mine))
    check("broadcast", g.broadcast(mine[rank], src_rank=world - 1),
          mine[world - 1])
    g.barrier()
    for n in (3 * world, 3 * world + 1):
        parts = [np.arange(n, dtype=np.float32) * (r + 1)
                 for r in range(world)]
        check(f"reducescatter_{n}", g.reducescatter(parts[rank]),
              np.array_split(np.sum(parts, axis=0), world)[rank])
    got = g.reduce(mine[rank], dst_rank=0)
    check("reduce", got, np.sum(mine, axis=0) if rank == 0 else mine[rank])
    p2p = "not run: one rank"
    if world >= 2:
        if rank == 0:
            g.send(torch.full((3,), 42.0), dst_rank=1)
        elif rank == 1:
            check("send_recv", g.recv(src_rank=0),
                  np.full((3,), 42.0, np.float32))
        p2p = "run"
    bus = "not run: one rank"
    if world >= 2:
        x = torch.ones(COLLECTIVE_BYTES // 2, dtype=torch.bfloat16,
                       device="cuda")
        for _ in range(2):
            torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(COLLECTIVE_ITERS):
            torch.distributed.all_reduce(x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / COLLECTIVE_ITERS
        algbw = COLLECTIVE_BYTES / (ms / 1e3) / 1e9
        bus = dict(ms=ms, algbw_gb_s=algbw,
                   busbw_gb_s=algbw * 2 * (world - 1) / world)
    collective.destroy_collective_group("chip_smoke")
    return dict(rank=rank, checks=checks, send_recv=p2p,
                all_reduce_256mib_bf16=bus,
                device=str(torch.device("cuda", torch.cuda.current_device())))


def collective_phase(card: str, failures: list) -> dict:
    """The NCCL TorchCollectiveGroup in one spawned rank per card (see the
    module docstring)."""
    t0 = time.perf_counter()
    ranks = run_ranks("collective", _collective_rank, (), failures,
                      COLLECTIVE_TIMEOUT_S)
    for r in ranks:
        if r is not None:
            bad = [k for k, ok in r["checks"].items() if not ok]
            if bad:
                failures.append(f"collective: rank {r['rank']} {bad}")
    res = dict(phase="collective", world=len(ranks), backend="nccl",
               ranks=ranks, seconds=time.perf_counter() - t0, card=card)
    emit(res)
    return res


def _held_bytes(trees) -> int:
    """The bytes of the distinct tensors of per-position trees (None at
    other ranks' positions)."""
    return sum({id(t): t.nbytes for tree in trees if tree is not None
                for t in _dict_leaves(tree).values()}.values())


def _replicas_bit_equal(trees, specs, mesh, cfg) -> dict:
    """For each leaf whose slice other ranks also hold (dp replicas), this
    rank's tensor against theirs, bit for bit: the elementwise max and
    min of the bf16 pairs' int32 views over the replicas' ranks equal
    the tensor itself. {leaf: equal} (empty on one rank)."""
    shapes = _dict_leaves(transformer.param_shapes(cfg))
    specs = _dict_leaves(specs)
    first = mesh.local_positions()[0]
    mine = _dict_leaves(trees[first])
    out = {}
    for name in sorted(mine):
        sl = shard_slices(specs[name], shapes[name][0], mesh,
                          mesh.coords()[first])
        holders = [i for i, c in enumerate(mesh.coords())
                   if shard_slices(specs[name], shapes[name][0], mesh,
                                   c) == sl]
        group = mesh.group(mesh.ranks(holders))
        if group is None:
            continue
        bits = mine[name].view(torch.int32)
        hi, lo = bits.clone(), bits.clone()
        torch.distributed.all_reduce(hi, torch.distributed.ReduceOp.MAX,
                                     group=group)
        torch.distributed.all_reduce(lo, torch.distributed.ReduceOp.MIN,
                                     group=group)
        out[name] = bool(torch.equal(hi, bits) and torch.equal(lo, bits))
    return out


def _leaf_sha256(t: torch.Tensor) -> str:
    """The sha256 of a bf16 tensor's bytes."""
    return hashlib.sha256(t.view(torch.int16).cpu().numpy()).hexdigest()


def _gathered_sample(grads, path, specs, mesh, cfg, device):
    """A sampled gradient of a rank's per-position grads, whole, on every
    rank (a collective): a top-level leaf over the mesh, or one layer's
    over the positions of the stage that holds it (each position gives its
    own layer at that index; only that stage's are kept)."""
    spec = _sample(specs, [k for k in path if not isinstance(k, int)])
    if len(path) == 1:
        parts = [None if g is None else _sample(g, path) for g in grads]
        return gather_tensor(all_gather_parts(parts, mesh), spec, mesh,
                             device=device)
    stage, li = divmod(path[1], cfg.num_layers // mesh.shape["pp"])
    local = ("layers", li) + tuple(path[2:])
    parts = all_gather_parts([None if g is None else _sample(g, local)
                              for g in grads], mesh)
    return gather_tensor([parts[i] for i in mesh.stage_positions(stage)],
                         spec[1:], Mesh(mesh.devices[stage:stage + 1]),
                         device=device)


def device_busy_ms(prof) -> float:
    """The union of the device's kernel intervals in a profile (ms): NCCL
    runs on streams of its own, beside the compute."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _rank_profile():
    """(context, profiler): a device profile with ``TRAIN_RANKS_RANGES``
    named while the context is open."""
    ctx = contextlib.ExitStack()
    prof = ctx.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]))
    owners = {"transformer": transformer, "handoffs": pipeline.Handoffs,
              "exchange": sharding_ops._Exchange, "ring": ring_ops,
              "moe": moe_ops}
    for owner, names in TRAIN_RANKS_RANGES:
        ctx.enter_context(named_ranges(names, owners[owner]))
    return ctx, prof


def _rank_summary(prof, step: int, wall_ms: float) -> dict:
    """One profiled step's device time by class, the named ranges apart,
    and the idle share of its wall time (the union of the kernels'
    intervals)."""
    split, top = device_time_split(prof)
    busy = device_busy_ms(prof)
    split_ranges(prof, split, [r for _, names in TRAIN_RANKS_RANGES
                               for r in names.values()])
    return dict(step=step, wall_ms=wall_ms,
                device_ms=split if busy else "not measured",
                busy_ms=busy if busy else "not measured",
                idle_share=1 - busy / wall_ms if busy else "not measured",
                top_kernels=top[:6])


def _rank_run(name, spec, microbatches, rank, world, tokens, ref_grads,
              ref_scalars, fails, overrides=None) -> dict:
    """One layout of the train_ranks phase on this rank (see the module
    docstring), under the default table or its ``overrides``."""
    if name in FREE_LAYOUTS:
        return _free_run(name, spec, microbatches, rank, fails)
    rules = (LogicalAxisRules.default().with_overrides(*overrides)
             if overrides else None)
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    dev = torch.device("cuda", torch.cuda.current_device())

    def fail(msg):
        fails.append(f"{name}: {msg}")
    mesh = build_mesh(MeshSpec(**spec))
    bundle = make_train_step(cfg, mesh,
                             optimizer=make_optimizer(warmup_steps=1),
                             rules=rules, num_microbatches=microbatches,
                             device=dev)
    specs = bundle.state_specs["params"]
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}

    def seeded_shards():
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        if _leaf_sha256(params["layers"]["attn"]["wk"]) \
                != ref_scalars["wk_sha256"]:
            fail("the seed-0 params differ from the unsharded pass's "
                 "(layers.attn.wk's hash)")
        shards = shard_params(params, mesh, bundle.rules)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return shards

    def kept_device(what):
        if torch.cuda.current_device() != dev.index:
            fail(f"{what} left cuda:{torch.cuda.current_device()} current, "
                 f"not {dev}")
    t0 = time.perf_counter()
    shards = seeded_shards()
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = value_and_grad(shards, batch, cfg, device=dev, mesh=mesh,
                                 rules=rules, num_microbatches=microbatches)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    kept_device("value_and_grad")
    sample_errs = {}
    for path in TRAIN_MESH_SAMPLE:
        got = _gathered_sample(grads, path, specs, mesh, cfg, dev)
        if ref_grads is not None:
            sample_errs[".".join(map(str, path))] = _rel(
                got, ref_grads[path].to(dev))
        del got
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    if sample_errs:
        worst = max(sample_errs, key=sample_errs.get)
        if not sample_errs[worst] <= TRAIN_MESH_GRAD_REL_TOL:
            fail(f"sampled gradient {worst} against the unsharded pass: "
                 f"{sample_errs[worst]}")
    state = {"params": shards,
             "opt_state": bundle.optimizer.init(shards), "step": 0}
    del shards
    plan = plan_train_memory(cfg, MeshSpec(**spec),
                             global_batch=TRAIN_MESH_BATCH,
                             seq_len=TRAIN_SEQ, rules=rules,
                             num_microbatches=microbatches, world=world)
    opt = state["opt_state"]
    held = dict(params=_held_bytes(state["params"]),
                opt=_held_bytes(opt["mu"]) + _held_bytes(opt["nu"]))
    planned = dict(params=plan.rank_params_bytes, opt=plan.rank_opt_bytes)
    if held != planned:
        fail(f"distinct state bytes {held}, the planner's per-rank figure "
             f"{planned}")

    # Per layer of its stage and microbatch, each of this rank's positions
    # that attends (every position of a batch group; under sp the first
    # shard's, where the sequence is gathered): kernel 1 in the forward
    # and the recompute, dQ and dK/dV once.
    pp = mesh.shape["pp"]
    mb = (microbatches or pp) if pp > 1 else 1
    groups = set(mesh.batch_groups(bundle.rules))
    homes = sum(1 for i in mesh.local_positions()
                if mesh.coords()[i][3] == 0
                and mesh.coords()[i][1:3] in groups)
    per = cfg.num_layers // pp * mb * homes
    want = (2 * per, per, per)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    flash_attention_dq.launches = 0
    flash_attention_dkv.launches = 0
    steps = []
    for i in range(TRAIN_RANKS_STEPS):
        last = i == TRAIN_RANKS_STEPS - 1
        ctx, prof = (_rank_profile() if last
                     else (contextlib.nullcontext(), None))
        before = _launch_counts()
        torch.cuda.synchronize()
        with ctx:
            t0 = time.perf_counter()
            state, metrics = bundle.step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        kept_device(f"step {metrics['step']}")
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        steps.append(dict(metrics, step_ms=step_s * 1e3,
                          launches=dict(zip(("fwd", "dq", "dkv"),
                                            launches))))
        if launches != want:
            fail(f"step {metrics['step']} launched (fwd, dq, dkv) "
                 f"{launches}, expected {want}")
        if not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"])):
            fail(f"step not finite: {metrics}")
    totals = dict(zip(("fwd", "dq", "dkv"), _launch_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = steps[0], steps[-1]
    loss_rel = abs(first["loss"] - ref_scalars["loss"]) / abs(
        ref_scalars["loss"])
    gnorm_rel = (abs(first["grad_norm"] - ref_scalars["grad_norm"])
                 / ref_scalars["grad_norm"])
    if not last["loss"] < first["loss"]:
        fail(f"loss did not fall: {first['loss']} -> {last['loss']}")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL
            and gnorm_rel <= TRAIN_GNORM_REL_TOL):
        fail(f"step 1 against the unsharded pass: loss rel {loss_rel}, "
             f"grad_norm rel {gnorm_rel}")
    replicas = {}
    for kind, trees in (("params", state["params"]), ("mu", opt["mu"]),
                        ("nu", opt["nu"])):
        for leaf, ok in _replicas_bit_equal(trees, specs, mesh,
                                            cfg).items():
            replicas[f"{kind}.{leaf}"] = ok
    if not all(replicas.values()):
        fail(f"replicas differ across ranks: "
             f"{[k for k, ok in replicas.items() if not ok][:5]}")
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()
    # The steps after the first, but the profiled last one.
    steady_ms = float(np.mean([st["step_ms"] for st in steps[1:-1]]))
    tokens_n = TRAIN_MESH_BATCH * TRAIN_SEQ
    out = dict(
        layout=name, mesh=spec, num_microbatches=microbatches,
        overrides=[list(o) for o in overrides or ()],
        batch_groups=len(groups),
        positions=mesh.local_positions(), shard_s=shard_s,
        value_and_grad_s=vg_s, value_and_grad_loss=float(loss),
        sampled_grad_rel_err=sample_errs or "on rank 0",
        held_state_bytes=held, planned_state_bytes=planned,
        steps=steps, launches=totals, expected_launches_per_step=dict(
            zip(("fwd", "dq", "dkv"), want)),
        loss_rel_err=loss_rel, grad_norm_rel_err=gnorm_rel,
        steady_step_ms=steady_ms,
        tokens_per_s=tokens_n / (steady_ms / 1e3),
        model_flops_utilization=(cfg.flops_per_token(TRAIN_SEQ) * tokens_n
                                 / (steady_ms / 1e3) / world
                                 / PEAK_FLOPS[torch.bfloat16]),
        profiled_step=_rank_summary(prof, last["step"], last["step_ms"]),
        peak_memory_gb=peak_gb,
        replicas_bit_equal=(dict(checked=len(replicas),
                                 equal=sum(replicas.values()))
                            if replicas else "not run: one rank"))
    if mesh.shape["sp"] > 1:
        # Step 1 again from the seed-0 state, under ring attention: the
        # P2P ring between the sp ranks, no kernel launched.
        ring_cfg = dataclasses.replace(cfg, attention_impl="ring")
        ring = make_train_step(ring_cfg, mesh,
                               optimizer=make_optimizer(warmup_steps=1),
                               device=dev)
        shards = seeded_shards()
        state = {"params": shards,
                 "opt_state": ring.optimizer.init(shards), "step": 0}
        del shards
        before = _launch_counts()
        torch.cuda.synchronize()
        ctx, prof = _rank_profile()
        with ctx:
            t0 = time.perf_counter()
            state, metrics = ring.step(state, batch)
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) * 1e3
        kept_device("the ring step")
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        r_loss = abs(metrics["loss"] - ref_scalars["loss"]) / abs(
            ref_scalars["loss"])
        r_gnorm = (abs(metrics["grad_norm"] - ref_scalars["grad_norm"])
                   / ref_scalars["grad_norm"])
        if launches != (0, 0, 0):
            fail(f"the ring step launched (fwd, dq, dkv) {launches}")
        if not (r_loss <= TRAIN_LOSS_REL_TOL
                and r_gnorm <= TRAIN_GNORM_REL_TOL):
            fail(f"the ring's step 1 against the unsharded pass: loss rel "
                 f"{r_loss}, grad_norm rel {r_gnorm}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["ring_step"] = dict(metrics, step_ms=ring_ms,
                                launches=dict(zip(("fwd", "dq", "dkv"),
                                                  launches)),
                                loss_rel_err=r_loss, grad_norm_rel_err=r_gnorm,
                                profiled=_rank_summary(prof, 1, ring_ms))
    return out


def _free_run(name, spec, microbatches, rank, fails) -> dict:
    """A free-standing layer across the ranks (``FREE_LAYOUTS``) on this
    rank, held on rank 0 against the same function in one process: its
    outputs and gradients, its host ms, one profiled pass with the
    exchanges' ranges apart, no kernel launched (the layers attend and
    multiply in plain code, as in the JAX package)."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def fail(msg):
        fails.append(f"{name}: {msg}")
    mesh = build_mesh(MeshSpec(**spec))
    one = Mesh(np.array([dev] * mesh.devices.size, dtype=object).reshape(
        mesh.devices.shape))
    kind = FREE_LAYOUTS[name]
    run = {"ring": _free_attention, "ulysses": _free_attention,
           "pipeline": _free_pipeline,
           "moe": functools.partial(_free_moe, overrides=FREE_RULES.get(
               name))}[kind]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts()
    out = run(kind, mesh, one, rank, dev, fail, microbatches)
    launches = tuple(a - b for a, b in zip(_launch_counts(), before))
    if launches != (0, 0, 0):
        fail(f"launched (fwd, dq, dkv) {launches}, expected none")
    if torch.cuda.current_device() != dev.index:
        fail(f"left cuda:{torch.cuda.current_device()} current")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, layout=name, mesh=spec, positions=mesh.local_positions(),
                launches=dict(zip(("fwd", "dq", "dkv"), launches)),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _timed_pass(fn) -> tuple:
    """``fn()`` once on the host clock, synchronised, then once profiled
    with the phase's named ranges: (its result, the first call's host ms,
    which holds the exchanges' first-use set-up, the profile's summary,
    whose ``wall_ms`` is the warm pass's)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ctx, prof = _rank_profile()
    with ctx:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    return got, ms, _rank_summary(prof, 1, prof_ms)


def _gate(errs: dict, tol: float, fail) -> dict:
    if not all(e <= tol for e in errs.values()):
        fail(f"against one process: {errs} (limit {tol})")
    return dict(errs, limit=tol)


def _free_attention(kind, mesh, one, rank, dev, fail, _mb) -> dict:
    """Ring or Ulysses attention over the sp ranks: each rank's sequence
    shard of the output and its share of the gradients of sum(out * w),
    summed over the ranks (their boxes are disjoint) and held against
    one process."""
    B, S, Hq, Hkv, D = (FREE_ATTN[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v, w = (torch.randn((B, S, h, D), generator=gen, device=dev
                              ).to(torch.bfloat16)
                  for h in (Hq, Hkv, Hkv, Hq))
    fn = (ring_ops.ring_attention if kind == "ring"
          else ring_ops.ulysses_attention)
    n = mesh.shape["sp"]
    j = mesh.coords()[mesh.local_positions()[0]][3]
    seq = slice(j * S // n, (j + 1) * S // n)

    def attend(on, cot):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, on)
        (o.float() * cot.float()).sum().backward()
        return o.detach(), [t.grad for t in ts]
    (o, grads), ms, summary = _timed_pass(lambda: attend(mesh, w[:, seq]))
    whole = torch.zeros_like(q)
    whole[:, seq] = o
    for t in [whole] + grads:
        torch.distributed.all_reduce(t)
    res = dict(shape=dict(FREE_ATTN, dtype="bfloat16", causal=True),
               piece=list(o.shape), first_call_ms=ms, profiled=summary)
    if rank == 0:
        ro, rgrads = attend(one, w)
        res["rel_err"] = _gate(
            {x: _rel(a, b) for x, a, b in zip(
                ("out", "dq", "dk", "dv"), [whole] + grads, [ro] + rgrads)},
            FREE_REL_TOL, fail)
    return res


def _free_pipeline(kind, mesh, one, rank, dev, fail, microbatches) -> dict:
    """pipeline_spmd over the pp ranks, each stage its 8 layers of
    8b-gqa's seed-0 params: the output on the last stage's rank, each
    rank's stage gradients and (stage 0) x's gradient of sum(y * w), held
    against one process on rank 0 (y, x's gradient, every stage's first
    and last layer's gradients, and the global norm of the stacked
    layers' gradients)."""
    cfg = dataclasses.replace(PRESETS["8b-gqa"], attention_impl="xla")
    pp = mesh.shape["pp"]
    per = cfg.num_layers // pp
    layers = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         dev)["layers"]
    gc.collect()
    torch.cuda.empty_cache()
    line = mesh.axis_positions(mesh.local_positions()[0], "pp")
    stage = [s for s, i in enumerate(line) if mesh.is_local(i)][0]
    mine = pipeline._tree_map(
        lambda t: t[stage * per:(stage + 1) * per].clone().requires_grad_(),
        layers)
    if rank != 0:
        del layers
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(8)
    shape = (microbatches, FREE_PP_SEQ, cfg.hidden_size)
    x0 = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    w = torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
    cos, sin = transformer.rope_angles(FREE_PP_SEQ, cfg.head_dim_,
                                       cfg.rope_theta, device=dev)

    def apply_stage(sw, h):
        for lj in range(per):
            h = torch.utils.checkpoint.checkpoint(
                transformer._layer, cfg, h,
                transformer.layer_params({"layers": sw}, lj), cos, sin,
                use_reentrant=False)
        return h

    def run(on, stacked):
        x = x0.clone().requires_grad_()
        y = pipeline.pipeline_spmd(apply_stage, stacked, x, mesh=on,
                                   num_microbatches=microbatches)
        # A rank without the last stage got a tensor of no size.
        loss = (y.float() * w.float()).sum() if y.numel() else y.sum()
        loss.backward()
        return y.detach(), x.grad

    def zero(tree):
        for _, t in _named_leaves(tree):
            t.grad = None
    stacked = pipeline._tree_map(
        lambda t: t.unsqueeze(0).expand((pp,) + tuple(t.shape)), mine)
    (y, xg), ms, summary = _timed_pass(lambda: (zero(mine),
                                                run(mesh, stacked))[1])
    norm2 = torch.zeros((), device=dev)
    for _, t in _named_leaves(mine):
        norm2 += t.grad.float().square().sum()
    torch.distributed.all_reduce(norm2)
    # rank 0's reference, every rank's share of it, and each rank's errors.
    ref = {}
    if rank == 0:
        full = pipeline._tree_map(lambda t: t.requires_grad_(), layers)
        ref["y"], ref["xg"] = run(one, pipeline.split_stages(full, pp))
        ref["norm"] = math.sqrt(sum(t.grad.float().square().sum().item()
                                    for _, t in _named_leaves(full)))
    errs = {}
    last = stage == pp - 1
    yr = ref.get("y", torch.empty(shape, dtype=cfg.dtype, device=dev))
    torch.distributed.broadcast(yr, 0)
    if last:
        errs["y"] = _rel(y, yr)
    if rank == 0:
        errs["x_grad"] = _rel(xg, ref["xg"])
    # Each stage's first and last layer: rank 0's gradient broadcast,
    # held by the stage's rank against its own.
    for s in range(pp):
        for li in (s * per, (s + 1) * per - 1):
            for key, t in _named_leaves(mine):
                want = (_leaf(full, key).grad[li] if rank == 0
                        else torch.empty_like(t[0]))
                torch.distributed.broadcast(want, 0)
                if s == stage:
                    errs[f"layer{li}.{key}"] = _rel(t.grad[li - s * per],
                                                    want)
    got = [None] * mesh.world
    torch.distributed.all_gather_object(got, errs)
    res = dict(stages=pp, layers_a_stage=per, microbatches=microbatches,
               seq=FREE_PP_SEQ, output_here=bool(y.numel()),
               first_call_ms=ms, profiled=summary)
    if rank == 0:
        merged = {k: v for e in got for k, v in e.items()}
        merged["grad_norm"] = abs(math.sqrt(norm2.item()) - ref["norm"]) \
            / ref["norm"]
        _gate(merged, FREE_REL_TOL, fail)
        worst = max(merged, key=merged.get)
        res["rel_err"] = dict(worst=worst, worst_err=merged[worst],
                              checked=len(merged),
                              grad_norm=merged["grad_norm"], y=merged["y"],
                              x_grad=merged["x_grad"], limit=FREE_REL_TOL)
    return res


def _leaf(tree, key: str):
    for part in key.split("."):
        tree = tree[part]
    return tree


def _free_moe(kind, mesh, one, rank, dev, fail, _mb, overrides=None) -> dict:
    """The expert-parallel MoE layer over the ranks, under the default
    table or its ``overrides``: each rank its shards of the seed-0
    params, y of its run of the tokens and its objective (sum(y), the aux
    losses on rank 0); the runs' y, the routing, the aux losses and every
    parameter's gradient gathered across ranks, held on rank 0 against
    the unsharded layer in one process."""
    rules = (LogicalAxisRules.default().with_overrides(*overrides)
             if overrides else None)
    cfg = MoEConfig(**MOE)
    params = init_moe_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    x = torch.randn(MOE_X + (cfg.d_model,), device=dev,
                    generator=torch.Generator(dev).manual_seed(1)
                    ).to(cfg.dtype)
    with torch.no_grad():
        shards = shard_params({k: v.detach() for k, v in params.items()},
                              mesh, rules, logical_axes=moe_logical_axes())
    leaves = {}
    shards = [None if t is None else {
        k: leaves.setdefault(id(v), v.requires_grad_())
        for k, v in t.items()} for t in shards]
    if rank != 0:
        del params
        gc.collect()
        torch.cuda.empty_cache()

    def run():
        for t in leaves.values():
            t.grad = None
        y, aux, routing = moe_layer_routed(shards, x, cfg, mesh, rules)
        obj = y.float().sum()
        if rank == 0:
            obj = obj + aux["moe_load_balance_loss"] + aux["moe_router_z_loss"]
        obj.backward()
        return y.detach(), {k: float(v.detach()) for k, v in aux.items()}, \
            routing
    (y, aux, (idx, keep)), ms, summary = _timed_pass(run)
    ys = [torch.empty_like(y) for _ in range(mesh.world)]
    torch.distributed.all_gather(ys, y)
    idxs = [torch.empty_like(idx) for _ in range(mesh.world)]
    torch.distributed.all_gather(idxs, idx)
    keeps = [torch.empty_like(keep) for _ in range(mesh.world)]
    torch.distributed.all_gather(keeps, keep)
    specs = tree_specs(moe_logical_axes(), mesh, rules)
    res = dict(mesh=dict(mesh.shape), overrides=[
        list(o) for o in overrides or ()], rows=list(moe_ops.moe_rows(
        mesh, MOE_X[0] * MOE_X[1])), first_call_ms=ms, profiled=summary,
        aux=aux)
    ref = None
    if rank == 0:
        for v in params.values():
            v.requires_grad_()
        ref = moe_pass(params, x, cfg)
    errs = {}
    for k in ("router", "w_gate", "w_up", "w_down"):
        parts = all_gather_parts([None if t is None else t[k].grad
                                  for t in shards], mesh)
        if rank == 0:
            errs[k] = _rel(gather_tensor(parts, specs[k], mesh),
                           params[k].grad)
        del parts
    if rank == 0:
        y0, aux0, (idx0, keep0) = ref
        routing_equal = all(torch.equal(a, idx0) for a in idxs) and all(
            torch.equal(a, keep0) for a in keeps)
        if not routing_equal:
            fail("the routing differs from the unsharded layer's")
        if aux["moe_fraction_dropped"] != aux0["moe_fraction_dropped"]:
            fail(f"fraction dropped {aux} vs {aux0}")
        y_err = _rel(torch.cat(ys), y0.reshape(-1, cfg.d_model))
        if not y_err <= MOE_Y_REL_TOL:
            fail(f"y against the unsharded layer: {y_err}")
        if not max(errs.values()) <= MOE_GRAD_REL_TOL:
            fail(f"gradients against the unsharded layer: {errs}")
        res.update(routing_equal=routing_equal, y_rel_err=y_err,
                   grad_rel_err=errs, y_rel_tol=MOE_Y_REL_TOL,
                   grad_rel_tol=MOE_GRAD_REL_TOL, unsharded_aux=aux0)
    return res


def _train_rank(rank: int, world: int, tokens, ref_path: str,
                ref_scalars: dict) -> dict:
    """One rank of the train_ranks phase: each layout of
    ``TRAIN_RANKS[world]`` in turn."""
    dev = torch.device("cuda", torch.cuda.current_device())
    ref_grads = (torch.load(ref_path, map_location="cpu")
                 if rank == 0 else None)
    fails = []
    runs = [_rank_run(name, spec, mb, rank, world, tokens, ref_grads,
                       ref_scalars, fails)
            for name, spec, mb in TRAIN_RANKS[world]]
    for name, spec, over in RULES_RANKS[world]:
        fit = _rules_rank_fit(spec, over, world)
        runs.append(_rank_run(name, spec, None, rank, world, tokens,
                              ref_grads, ref_scalars, fails, over)
                    if fit["ran"] else dict(layout=name, mesh=spec))
        runs[-1]["fit"] = fit
        if not fit["ran"]:
            print(f"train_ranks {name}: not run, the planner's per-rank "
                  f"figure {fit['planned_gb']:.1f} GB leaves less than "
                  f"{TRAIN_RULES_HEADROOM:.0%} of {fit['card_gb']:.1f} GB "
                  f"free", flush=True)
    return dict(rank=rank, device=str(dev), runs=runs, failures=fails)


def _rules_rank_fit(spec, overrides, world) -> dict:
    """Whether a RULES_RANKS run fits: the planner's per-rank figure (the
    rank's params, gradients and two moments, one group's activations and
    logits, the workspace) against the card less TRAIN_RULES_HEADROOM."""
    plan = plan_train_memory(
        dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                            attention_impl="flash"),
        MeshSpec(**spec), global_batch=TRAIN_MESH_BATCH, seq_len=TRAIN_SEQ,
        rules=LogicalAxisRules.default().with_overrides(*overrides),
        world=world)
    need = (4 * plan.rank_params_bytes + plan.activation_bytes
            + plan.logits_bytes + plan.workspace_bytes)
    card = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    return dict(ran=need <= (1 - TRAIN_RULES_HEADROOM) * card,
                planned_gb=need / 1e9, card_gb=card / 1e9,
                headroom=TRAIN_RULES_HEADROOM)


def train_ranks_phase(card: str, failures: list, train_mesh: dict,
                      ref: dict) -> dict:
    """Training with one process per card on dp x fsdp and with tp, sp
    and pp groups split over ranks (see the module docstring), held
    against train_mesh's unsharded pass ``ref``."""
    t_phase = time.perf_counter()
    world = 4 if torch.cuda.device_count() >= 4 else 1
    tokens = np.random.default_rng(5).integers(
        1, PRESETS["8b-gqa"].vocab_size, (TRAIN_MESH_BATCH, TRAIN_SEQ + 1))
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref_grads.pt")
        torch.save(ref["grads"], ref_path)
        scalars = dict(loss=ref["loss"], grad_norm=ref["grad_norm"],
                       wk_sha256=ref["wk_sha256"])
        ranks = run_ranks("train_ranks", _train_rank,
                          (tokens, ref_path, scalars), failures,
                          TRAIN_RANKS_TIMEOUT_S, world=world)
    for r in ranks:
        if r is not None:
            failures += [f"train_ranks rank {r['rank']}: {f}"
                         for f in r["failures"]]
    done = [r for r in ranks if r is not None]
    by_layout = {n: {k: sum(run["launches"][k] for r in done
                            for run in r["runs"]
                            if run["layout"] == n and "launches" in run)
                     for k in ("fwd", "dq", "dkv")}
                 for n, _, _ in TRAIN_RANKS[world] + RULES_RANKS[world]}
    rules_names = [n for n, _, _ in RULES_RANKS[world]]
    res = dict(
        phase="train_ranks", preset="8b-gqa", world=world,
        layouts=[dict(name=n, mesh=sp, num_microbatches=mb)
                 for n, sp, mb in TRAIN_RANKS[world]],
        rules_layouts=[dict(name=n, mesh=sp, overrides=[list(o) for o in ov])
                       for n, sp, ov in RULES_RANKS[world]],
        batch=TRAIN_MESH_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_RANKS_STEPS,
        ranks=ranks, launches_by_layout=by_layout,
        launches=by_layout[TRAIN_RANKS_DP],
        split_launches={k: sum(v[k] for n, v in by_layout.items()
                               if n != TRAIN_RANKS_DP
                               and n not in rules_names)
                        for k in ("fwd", "dq", "dkv")},
        rules_launches={k: sum(by_layout[n][k] for n in rules_names)
                        for k in ("fwd", "dq", "dkv")},
        train_mesh=dict(
            steady_step_ms=train_mesh["runs"][0]["steady_step_ms"],
            tokens_per_s=train_mesh["runs"][0]["tokens_per_s"]),
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        sampled_grad_rel_tol=TRAIN_MESH_GRAD_REL_TOL,
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    return res


def _rel(got, want) -> float:
    return (torch.linalg.vector_norm(got.float() - want.float())
            / torch.linalg.vector_norm(want.float())).item()


def moe_pass(params, x, cfg, mesh=None, rules=None):
    """One MoE forward and the backward of y.float().sum() plus the two aux
    losses: (y, aux as floats, (expert_idx, keep))."""
    y, aux, routing = moe_layer_routed(params, x, cfg, mesh, rules)
    (y.float().sum() + aux["moe_load_balance_loss"]
     + aux["moe_router_z_loss"]).backward()
    return y.detach(), {k: float(v.detach()) for k, v in aux.items()}, \
        routing


def moe_timing(params, x, cfg, mesh=None) -> dict:
    """The forward alone and forward + backward, each once under
    torch.profiler after a warm-up: host (synchronised wall) and device
    (summed kernel) ms; the backward's are the difference."""
    def fwd():
        with torch.no_grad():
            moe_layer_routed(params, x, cfg, mesh)

    def both():
        moe_pass(params, x, cfg, mesh)
    f, b = profiled(fwd), profiled(both)
    for t in params if isinstance(params, list) else [params]:
        for v in t.values():
            v.grad = None

    def dev(p):
        d = p["device_ms"]
        return sum(d.values()) if isinstance(d, dict) else None
    fd, bd = dev(f), dev(b)
    return dict(forward_host_ms=f["wall_ms"],
                backward_host_ms=b["wall_ms"] - f["wall_ms"],
                forward_device_ms=fd if fd is not None else "not measured",
                backward_device_ms=(bd - fd if None not in (fd, bd)
                                    else "not measured"),
                forward_idle_share=f["idle_share"],
                forward_backward=b)


@torch.no_grad()
def relabel_experts_(params, perm) -> None:
    """Permute every expert's MLP units in place (w_gate and w_up columns,
    w_down rows): the same function, another order of w_down's sums."""
    for name in ("w_gate", "w_up"):
        params[name].copy_(params[name][:, :, perm])
    params["w_down"].copy_(params["w_down"][:, perm])


def moe_phase(card: str, failures: list) -> dict:
    """One MoE layer at Mixtral-8x7B's widths, unsharded and ep-sharded
    (see the module docstring)."""
    t_phase = time.perf_counter()
    cfg = MoEConfig(**MOE)
    cuda0 = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    params = init_moe_params(cfg, torch.Generator(cuda0).manual_seed(0),
                             cuda0)
    expert_bytes = sum(params[k].nbytes for k in ("w_gate", "w_up",
                                                  "w_down"))
    x = torch.randn(MOE_X + (cfg.d_model,), device=cuda0,
                    generator=torch.Generator(cuda0).manual_seed(1)
                    ).to(cfg.dtype)
    N = MOE_X[0] * MOE_X[1]
    for v in params.values():
        v.requires_grad_()
    y0, aux0, (idx0, keep0) = moe_pass(params, x, cfg)
    grads0 = {k: v.grad for k, v in params.items()}
    for v in params.values():
        v.grad = None
    plain = moe_timing(params, x, cfg)
    # The control: the unsharded layer with its MLP units relabelled.
    perm = torch.randperm(cfg.d_ff, device=cuda0,
                          generator=torch.Generator(cuda0).manual_seed(2))
    relabel_experts_(params, perm)
    yc, _, _ = moe_pass(params, x, cfg)
    inv = torch.argsort(perm)
    # The relabelled layer's gradients, in the original order of units.
    cgrads = {"router": params["router"].grad,
              "w_gate": params["w_gate"].grad[:, :, inv],
              "w_up": params["w_up"].grad[:, :, inv],
              "w_down": params["w_down"].grad[:, inv]}
    control = dict(y_rel_err=_rel(yc, y0),
                   grad_rel_err={k: _rel(g, grads0[k])
                                 for k, g in cgrads.items()})
    del cgrads, yc
    for v in params.values():
        v.grad = None
    relabel_experts_(params, inv)

    mesh = build_mesh(MeshSpec(**MOE_MESH), devices=[cuda0] * 8)
    with torch.no_grad():
        shards = shard_params({k: v.detach() for k, v in params.items()},
                              mesh, logical_axes=moe_logical_axes())
    distinct = {id(t): t for s in shards for t in s.values()}
    for t in distinct.values():
        t.requires_grad_()
    held = sum(t.nbytes for t in distinct.values())
    on_card = all(t.device == cuda0 for t in distinct.values())
    whole = sum(v.nbytes for v in params.values())
    shapes = {k: tuple(v.shape) for k, v in shards[0].items()}
    ep = MOE_MESH["fsdp"] * MOE_MESH["sp"]
    want_shapes = {"router": (cfg.d_model // MOE_MESH["fsdp"],
                              cfg.num_experts),
                   "w_gate": (cfg.num_experts // ep, cfg.d_model,
                              cfg.d_ff // MOE_MESH["tp"]),
                   "w_up": (cfg.num_experts // ep, cfg.d_model,
                            cfg.d_ff // MOE_MESH["tp"]),
                   "w_down": (cfg.num_experts // ep,
                              cfg.d_ff // MOE_MESH["tp"], cfg.d_model)}
    y1, aux1, (idx1, keep1) = moe_pass(shards, x, cfg, mesh)
    specs = tree_specs(moe_logical_axes(), mesh)
    grads1 = {k: gather_tensor([s[k].grad for s in shards], specs[k], mesh)
              for k in params}
    for t in distinct.values():
        t.grad = None
    sharded = moe_timing(shards, x, cfg, mesh)
    del shards, distinct
    routing_equal = bool(torch.equal(idx1, idx0) and torch.equal(keep1,
                                                                 keep0))
    # Once more under MOE_RULES: each computing position gathers its
    # experts' weights from the table's slices at use.
    rules = LogicalAxisRules.default().with_overrides(*MOE_RULES)
    with torch.no_grad():
        shards = shard_params({k: v.detach() for k, v in params.items()},
                              mesh, rules, moe_logical_axes())
    distinct = {id(t): t for s in shards for t in s.values()}
    for t in distinct.values():
        t.requires_grad_()
    rules_shapes = {k: tuple(v.shape) for k, v in shards[0].items()}
    y2, aux2, (idx2, keep2) = moe_pass(shards, x, cfg, mesh, rules)
    specs2 = tree_specs(moe_logical_axes(), mesh, rules)
    under_rules = dict(
        overrides=[list(o) for o in MOE_RULES], shard_shapes=rules_shapes,
        shards_bytes=sum(t.nbytes for t in distinct.values()),
        routing_equal=bool(torch.equal(idx2, idx0)
                           and torch.equal(keep2, keep0)),
        y_rel_err=_rel(y2, y0),
        grad_rel_err={k: _rel(gather_tensor([s[k].grad for s in shards],
                                            specs2[k], mesh), grads0[k])
                      for k in params})
    del shards, distinct, y2
    if not (under_rules["routing_equal"]
            and under_rules["shards_bytes"] == sum(
                v.nbytes for v in params.values())
            and under_rules["y_rel_err"] <= MOE_Y_REL_TOL
            and max(under_rules["grad_rel_err"].values())
            <= MOE_GRAD_REL_TOL
            and aux2["moe_fraction_dropped"]
            == aux0["moe_fraction_dropped"]):
        failures.append(f"moe: sharded under {MOE_RULES} against "
                        f"unsharded: {under_rules}")
    errs = dict(y_rel_err=_rel(y1, y0),
                grad_rel_err={k: _rel(grads1[k], grads0[k])
                              for k in params})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not routing_equal:
        failures.append("moe: sharded routing differs from the unsharded "
                        "layer's")
    if aux1["moe_fraction_dropped"] != aux0["moe_fraction_dropped"]:
        failures.append(f"moe: fraction dropped {aux1} vs {aux0}")
    if not errs["y_rel_err"] <= MOE_Y_REL_TOL:
        failures.append(f"moe: sharded y against unsharded {errs}")
    if not max(errs["grad_rel_err"].values()) <= MOE_GRAD_REL_TOL:
        failures.append(f"moe: sharded grads against unsharded {errs}")
    if not (held == whole and on_card and shapes == want_shapes):
        failures.append(f"moe: shards hold {held} bytes (params {whole}), "
                        f"on card {on_card}, shapes {shapes} against "
                        f"{want_shapes}")
    if not (y0.shape == x.shape and torch.isfinite(y0).all()):
        failures.append("moe: y not finite or of the wrong shape")
    # Work of one forward: the three expert products over E x C slots,
    # the dispatch and the combine.
    C = cfg.capacity(N)
    flops = (2 * 3 * cfg.num_experts * C * cfg.d_model * cfg.d_ff
             + 2 * 2 * N * cfg.num_experts * C * cfg.d_model)
    res = dict(
        phase="moe", widths=MOE, x=list(MOE_X) + [cfg.d_model],
        dtype=str(cfg.dtype).replace("torch.", ""),
        capacity_factor=cfg.capacity_factor, tokens=N, capacity=C,
        expert_params_bytes=expert_bytes,
        dispatch_bytes=N * cfg.num_experts * C * 2,
        combine_bytes=N * cfg.num_experts * C * 4,
        forward_flops=flops, aux=aux0, sharded_aux=aux1,
        fraction_dropped=aux0["moe_fraction_dropped"],
        routing_equal=routing_equal, sharded=errs, control=control,
        y_rel_tol=MOE_Y_REL_TOL, grad_rel_tol=MOE_GRAD_REL_TOL,
        mesh=MOE_MESH, shard_shapes=shapes, shards_bytes=held,
        params_bytes=whole, shards_on_card=on_card,
        unsharded_timing=plain, sharded_timing=sharded,
        under_rules=under_rules, peak_memory_gb=peak_gb,
        seconds=time.perf_counter() - t_phase, card=card)
    emit(res)
    del params, grads0, grads1
    gc.collect()
    torch.cuda.empty_cache()
    return res


def rllib_batches(rng) -> dict:
    """One seeded batch per learner family at the shapes one iteration of
    each default config gives: PPO two runners' [64, 8] rollouts, IMPALA
    and APPO their aggregate [64, 16], DQN (prioritized weights) and SAC a
    replay batch of 64."""
    def obs(*shape):
        return rng.normal(size=shape + (4,)).astype(np.float32)

    def acts(*shape):
        return rng.integers(0, 2, shape).astype(np.int32)

    def logp(*shape):
        return (np.log(0.5) + 0.1 * rng.normal(size=shape)).astype(
            np.float32)

    ppo = [dict(obs=obs(64, 8), actions=acts(64, 8), logp=logp(64, 8),
                vf=rng.normal(size=(64, 8)).astype(np.float32),
                rewards=np.ones((64, 8), np.float32),
                trunc_bonus=np.zeros((64, 8), np.float32),
                dones=rng.random((64, 8)) < 0.05,
                bootstrap_value=rng.normal(size=8).astype(np.float32))
           for _ in range(2)]
    impala = dict(obs=obs(64, 16), actions=acts(64, 16), logp=logp(64, 16),
                  rewards=np.ones((64, 16), np.float32),
                  trunc_bonus=np.zeros((64, 16), np.float32),
                  dones=rng.random((64, 16)) < 0.05, final_obs=obs(16),
                  episode_returns=[20.0])

    def replay(weights):
        b = dict(obs=obs(64), next_obs=obs(64), actions=acts(64),
                 rewards=np.ones(64, np.float32),
                 dones=rng.random(64) < 0.05,
                 discounts=np.full(64, 0.99 ** 3, np.float32))
        if weights:
            b["weights"] = rng.uniform(0.3, 1.0, 64).astype(np.float32)
        return b
    return dict(ppo=ppo, impala=impala, appo=impala, dqn=replay(True),
                sac=replay(False))


RLLIB_LEARNERS = {"ppo": (Learner, PPOConfig),
                  "impala": (ImpalaLearner, IMPALAConfig),
                  "appo": (AppoLearner, APPOConfig),
                  "dqn": (DQNLearner, DQNConfig),
                  "sac": (SACLearner, SACConfig)}


def _state_rel_err(got: dict, want: dict) -> float:
    """max over the state's tensors (params and targets) of
    max |got - want| / max |want|."""
    worst = 0.0
    for key in ("params", "target_params", "target"):
        for k, w in want.get(key, {}).items():
            g = got[key][k].detach().cpu()
            scale = max(w.abs().max().item(), 1e-30)
            worst = max(worst, (g - w).abs().max().item() / scale)
    return worst


def rllib_learner_check(name: str, failures: list) -> dict:
    """One update of learner ``name`` on the card and on the CPU from one
    state on one batch: the state's and the metrics' errors, and the
    card's update ms (CUDA events over warm updates)."""
    cls, config = RLLIB_LEARNERS[name]
    cfg = config().learner_config_dict()
    batch = rllib_batches(np.random.default_rng(1))[name]
    cpu = cls(RLLIB_SPEC, cfg, 0, "cpu")
    card = cls(RLLIB_SPEC, cfg, 0, "cuda")
    card.set_state(cpu.get_state())
    want_m = cpu.update(copy.deepcopy(batch))
    got_m = card.update(copy.deepcopy(batch))
    adam_steps = card.opt_state["count"]
    got = card.get_state()
    state_err = _state_rel_err(got, cpu.get_state())
    metric_err = {}
    for k, w in want_m.items():
        if isinstance(w, (float, np.ndarray)):
            diff = np.abs(np.asarray(got_m[k]) - np.asarray(w)).max()
            metric_err[k] = float(diff / max(np.abs(w).max(), 1.0))
    on_card = all(t.device.type == "cuda" for t in got["params"].values())
    ms = time_ms(lambda: card.update(copy.deepcopy(batch)),
                 RLLIB_UPDATE_ITERS) if on_card else None
    if not (state_err <= RLLIB_REL_TOL
            and max(metric_err.values()) <= RLLIB_REL_TOL and on_card):
        failures.append(f"rllib: {name} learner on the card against the "
                        f"CPU: state {state_err}, metrics {metric_err}, "
                        f"on card {on_card}")
    return dict(learner=cls.__name__, lr=cfg["lr"],
                grad_clip=cfg["grad_clip"],
                adam_steps=adam_steps,
                state_max_rel_err=state_err,
                metric_max_err=max(metric_err.values()),
                metric_err=metric_err, update_ms=ms, on_card=on_card)


def _rllib_devices(algo) -> dict:
    learner = algo.learner_group.learner
    return dict(
        learner=sorted({str(p.device) for p in learner.net.parameters()}),
        runners=sorted({str(p.device) for r in algo.env_runner_group.runners
                        for p in r.instance.module.parameters()}))


def rllib_train(config, iters: int, stop_at=None):
    """Train ``config`` on the card for up to ``iters`` iterations (until
    a mean return of ``stop_at``): (per-iteration rows, the last metrics,
    the learner's and runners' parameter devices, the algorithm). The
    caller stops the algorithm."""
    algo = config.resources(device="cuda").build_algo()
    steps = (config.num_env_runners * config.num_envs_per_env_runner
             * config.rollout_fragment_length)
    rows = []
    for i in range(iters):
        t0 = time.perf_counter()
        m = algo.train()
        torch.cuda.synchronize()
        rows.append(dict(
            iteration=i + 1, wall_s=time.perf_counter() - t0,
            env_steps=steps, sample_time_s=m.get("sample_time_s"),
            learn_time_s=m.get("learn_time_s"),
            episode_return_mean=m["episode_return_mean"],
            losses={k: v for k, v in m.items() if k.endswith("_loss")},
            num_updates=m.get("num_updates"),
            num_samples=m.get("num_samples")))
        if stop_at is not None and m["episode_return_mean"] >= stop_at:
            break
    return rows, m, _rllib_devices(algo), algo


def rllib_phase(card: str, failures: list) -> dict:
    """The rllib port on the card: each learner against itself on the CPU,
    PPO learning CartPole, IMPALA, APPO, DQN and SAC training. No kernel
    of ops/csrc lies on this path: it must launch none."""
    t_phase = time.perf_counter()
    learners = {name: rllib_learner_check(name, failures)
                for name in RLLIB_LEARNERS}

    before = _launch_counts()
    ppo_cfg = (PPOConfig().environment("CartPole-v1")
               .env_runners(**RLLIB_PPO_RUNNERS)
               .training(lr=3e-4, entropy_coeff=0.01).debugging(seed=0))
    rows, m, devices, algo = rllib_train(ppo_cfg, RLLIB_PPO_ITERS,
                                         RLLIB_PPO_RETURN)
    try:
        prof = profiled(algo.train)
    finally:
        algo.stop()
    reached = m["episode_return_mean"] >= RLLIB_PPO_RETURN
    ppo = dict(config=dict(RLLIB_PPO_RUNNERS, lr=3e-4, entropy_coeff=0.01,
                           seed=0),
               iterations=len(rows), reached=reached,
               episode_return_mean=m["episode_return_mean"],
               env_steps_per_s=(sum(r["env_steps"] for r in rows)
                                / sum(r["wall_s"] for r in rows)),
               devices=devices, per_iteration=rows,
               profiled_iteration=prof)
    if not reached:
        failures.append(f"rllib: PPO's mean return "
                        f"{m['episode_return_mean']} < {RLLIB_PPO_RETURN} "
                        f"after {len(rows)} iterations")

    others = {}
    for name, config in (
            ("impala", IMPALAConfig().training(lr=6e-4,
                                               entropy_coeff=0.01)),
            ("appo", APPOConfig().training(lr=6e-4, entropy_coeff=0.01)),
            # learning_starts: one iteration's 2 x 8 x 16 steps.
            ("dqn", DQNConfig().training(learning_starts=256)),
            ("sac", SACConfig().training(learning_starts=256))):
        config = config.environment("CartPole-v1").debugging(seed=0)
        if name in ("impala", "appo"):
            config = config.env_runners(**RLLIB_PPO_RUNNERS)
        rows_o, m_o, dev_o, algo_o = rllib_train(config, RLLIB_OTHER_ITERS)
        algo_o.stop()
        updated = (m_o.get("num_updates", 0) >= 1
                   if name in ("dqn", "sac") else
                   all(r["num_samples"] for r in rows_o))
        finite = all(math.isfinite(v) for r in rows_o
                     for v in r["losses"].values())
        has_losses = any(r["losses"] for r in rows_o)
        others[name] = dict(per_iteration=rows_o, devices=dev_o,
                            updated=updated)
        if not (updated and finite and has_losses
                and dev_o == RLLIB_ON_CARD):
            failures.append(f"rllib: {name} updated {updated}, losses "
                            f"finite {finite} ({has_losses}), params on "
                            f"{dev_o}")
    launches = tuple(a - b for a, b in zip(_launch_counts(), before))
    if devices != RLLIB_ON_CARD:
        failures.append(f"rllib: PPO's params on {devices}")
    if any(launches):
        failures.append(f"rllib: the path launched kernels {launches}")
    seconds = time.perf_counter() - t_phase
    if seconds > RLLIB_PHASE_S:
        failures.append(f"rllib: the phase took {seconds} s "
                        f"(limit {RLLIB_PHASE_S})")
    res = dict(phase="rllib", spec=RLLIB_SPEC, rel_tol=RLLIB_REL_TOL,
               learners=learners, ppo=ppo, others=others,
               flash_launches=dict(zip(("fwd", "dq", "dkv"), launches)),
               seconds=seconds, card=card)
    emit(res)
    return res


# ---------------------------------------------------------- rllib_offline --
# The JAX tests' recorders (tests/test_rllib_sac_offline.py:156-178 and
# :213-231, tests/test_rllib_cql_iql.py:14-42), over the port's CartPole.
def scripted_cartpole_episodes(n_episodes=40, seed=0):
    env = envs.make("CartPole-v1")
    episodes = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = False
        while not done and len(rows_a) < 200:
            a = int(obs[2] + 0.3 * obs[3] > 0)
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        episodes.append({"obs": np.stack(rows_o),
                         "actions": np.asarray(rows_a, np.int64),
                         "rewards": np.asarray(rows_r, np.float32)})
    env.close()
    return episodes


def random_cartpole_episodes(n_episodes=25, seed=500):
    rng = np.random.default_rng(0)
    env = envs.make("CartPole-v1")
    bad = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = False
        while not done:
            a = int(rng.integers(0, 2))
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        bad.append({"obs": np.stack(rows_o),
                    "actions": np.asarray(rows_a, np.int64),
                    "rewards": np.asarray(rows_r, np.float32)})
    env.close()
    return bad


def record_cartpole(n_episodes=30, p_random=0.3, seed=0, horizon=200):
    rng = np.random.default_rng(seed)
    env = envs.make("CartPole-v1")
    episodes, returns = [], []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        rows_o, rows_a, rows_r = [], [], []
        done = term = False
        while not done and len(rows_a) < horizon:
            if rng.random() < p_random:
                a = int(rng.integers(2))
            else:
                a = int(obs[2] + 0.3 * obs[3] > 0)
            rows_o.append(obs.astype(np.float32))
            rows_a.append(a)
            obs, r, term, trunc, _ = env.step(a)
            rows_r.append(float(r))
            done = term or trunc
        episodes.append({"obs": np.stack(rows_o),
                         "actions": np.asarray(rows_a, np.int64),
                         "rewards": np.asarray(rows_r, np.float32),
                         "terminated": bool(term)})
        returns.append(float(np.sum(rows_r)))
    env.close()
    return episodes, float(np.mean(returns))


def offline_corpus(name: str):
    """(episodes, the behaviour's mean return or None) of a gate."""
    if name == "scripted":
        return scripted_cartpole_episodes(), None
    if name == "scripted+random":
        return (scripted_cartpole_episodes(n_episodes=25)
                + random_cartpole_episodes()), None
    return record_cartpole(seed=7 if name == "mixed-7" else 0)


class TwoCartPoles(MultiAgentEnv):
    """Two independent CartPole instances as one multi-agent env
    (tests/test_rllib_multi_agent.py:22-56 over the port's CartPole): the
    episode ends ('__all__') when either pole falls or time truncates."""

    agents = ["a0", "a1"]

    def __init__(self, time_limit=None):
        self._envs = {a: envs.make("CartPole-v1") for a in self.agents}
        for e in self._envs.values():
            if time_limit:
                e.max_episode_steps = time_limit
        self.observation_spaces = {
            a: e.observation_space for a, e in self._envs.items()}
        self.action_spaces = {
            a: e.action_space for a, e in self._envs.items()}

    def reset(self, seed=None):
        obs = {}
        for i, (a, e) in enumerate(self._envs.items()):
            obs[a], _ = e.reset(seed=None if seed is None else seed + i)
        return obs, {}

    def step(self, action_dict):
        obs, rew, term, trunc = {}, {}, {}, {}
        any_term, any_trunc = False, False
        for a, e in self._envs.items():
            obs[a], rew[a], t, tr, _ = e.step(action_dict[a])
            term[a], trunc[a] = t, tr
            any_term |= t
            any_trunc |= tr
        term["__all__"] = any_term
        trunc["__all__"] = any_trunc and not any_term
        return obs, rew, term, trunc, {}


def _max_err(got, want) -> float:
    """max |got - want| / max(max |want|, 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def rllib_offline_batches(rng) -> dict:
    """One seeded corpus per learner: 2048 recorded rows for BC and
    MARWIL (8 minibatches of 256 a pass), 4096 transitions for CQL and
    IQL (8 updates of 256)."""
    eps = [{"obs": rng.normal(size=(256, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, 256),
            "rewards": rng.uniform(0, 1, 256).astype(np.float32)}
           for _ in range(8)]
    bc = episodes_to_batch(eps, 0.99)
    n = 4096
    tr = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, n),
          "rewards": rng.normal(size=n).astype(np.float32),
          "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
          "dones": (rng.random(n) < 0.05).astype(np.float32)}
    return dict(bc=bc, marwil=bc, cql=tr, iql=tr)


RLLIB_OFFLINE_LEARNERS = {
    "bc": (BCLearner, BCConfig()),
    "marwil": (BCLearner, MARWILConfig().training(beta=2.0)),
    "cql": (CQLLearner, CQLConfig()),
    "iql": (IQLLearner, IQLConfig()),
}


def rllib_offline_learner_check(name: str, failures: list) -> dict:
    """One update_offline (BC, MARWIL) or run_updates of 8 (CQL, IQL) on
    the card and on the CPU from one state on one corpus: the state's and
    the metrics' errors, and the card's update ms (CUDA events, warm)."""
    cls, config = RLLIB_OFFLINE_LEARNERS[name]
    cfg = config.learner_config_dict()
    data = rllib_offline_batches(np.random.default_rng(2))[name]
    cpu = cls(RLLIB_SPEC, cfg, 0, "cpu")
    card = cls(RLLIB_SPEC, cfg, 0, "cuda")
    card.set_state(cpu.get_state())

    def update(learner):
        if cls is BCLearner:
            return learner.update_offline(data)
        return learner.run_updates(data, RLLIB_OFFLINE_UPDATES, 256)
    want_m = update(cpu)
    got_m = update(card)
    adam_steps = card.opt_state["count"]
    got = card.get_state()
    state_err = _state_rel_err(got, cpu.get_state())
    metric_err = {k: _max_err(got_m[k], w) for k, w in want_m.items()}
    on_card = all(t.is_cuda for key in ("params", "target") if key in got
                  for t in got[key].values())
    ms = time_ms(lambda: update(card), RLLIB_UPDATE_ITERS)
    if not (state_err <= RLLIB_REL_TOL
            and max(metric_err.values()) <= RLLIB_REL_TOL and on_card):
        failures.append(f"rllib_offline: {name} learner on the card "
                        f"against the CPU: state {state_err}, metrics "
                        f"{metric_err}, on card {on_card}")
    return dict(learner=cls.__name__, lr=cfg["lr"],
                beta=cfg.get("beta"), adam_steps=adam_steps,
                rows=len(data["actions"]), state_max_rel_err=state_err,
                metric_max_err=max(metric_err.values()),
                metric_err=metric_err, update_ms=ms, on_card=on_card)


def rllib_offline_gate(name: str, failures: list) -> dict:
    """Train ``name`` on the card as its JAX test does, then its greedy
    returns over 5 episodes against the gate; BC's last iteration is
    profiled once more."""
    config, training, iters, corpus, gate = RLLIB_OFFLINE_GATES[name]
    episodes, behavior = offline_corpus(corpus)
    if gate is None:
        gate = behavior + RLLIB_OFFLINE_MARGIN
    algo = (config().environment("CartPole-v1").offline(episodes)
            .training(**training).resources(device="cuda")
            .debugging(seed=0).build_algo())
    try:
        rows = []
        for i in range(iters):
            t0 = time.perf_counter()
            m = algo.train()
            torch.cuda.synchronize()
            rows.append(dict(iteration=i + 1,
                             wall_s=time.perf_counter() - t0,
                             losses={k: v for k, v in m.items()
                                     if k.endswith("_loss")}))
        t0 = time.perf_counter()
        ev = algo.evaluate(num_episodes=RLLIB_OFFLINE_EVAL_EPISODES)
        eval_s = time.perf_counter() - t0
        learner = algo.learner_group.learner
        devices = sorted({str(p.device) for p in learner.net.parameters()})
        prof = profiled(algo.train) if name == "bc" else None
    finally:
        algo.stop()
    finite = all(math.isfinite(v) for r in rows for v in r["losses"].values())
    passed = ev["episode_return_mean"] >= gate
    if not (passed and finite and devices == RLLIB_ON_CARD["learner"]):
        failures.append(f"rllib_offline: {name} greedy return "
                        f"{ev['episode_return_mean']} (gate {gate}), losses "
                        f"finite {finite}, params on {devices}")
    return dict(training=training, iterations=iters,
                rows=sum(len(ep["actions"]) for ep in episodes),
                episodes=len(episodes), behavior_return=behavior,
                gate=gate, greedy_return_mean=ev["episode_return_mean"],
                passed=passed, eval_s=eval_s,
                wall_s_per_iteration=[r["wall_s"] for r in rows],
                last_losses=rows[-1]["losses"], devices=devices,
                profiled_iteration=prof)


def decisive_weights(seed: int) -> dict:
    """A policy's state dict (on the host) whose logits lie ~1e6 apart,
    so that no Gumbel draw flips the argmax on any device (the CPU
    tests' decisive weights)."""
    weights = RLModule(RLModuleSpec(**RLLIB_SPEC), seed, "cpu").state_dict()
    last = len(RLLIB_SPEC["hiddens"])
    weights[f"pi.{last}.weight"] = weights[f"pi.{last}.weight"] * 1e6
    return weights


def rllib_ma_sample_check(failures: list) -> dict:
    """MultiAgentEnvRunner.sample on the card against itself on the CPU,
    independent policies p0/p1, decisive weights, a 9-step time limit, two
    calls: obs, actions, rewards, dones, final obs and returns equal;
    logp, vf, trunc_bonus and bootstrap_value within RLLIB_REL_TOL."""
    mapping = {"a0": "p0", "a1": "p1"}
    specs = {p: dict(RLLIB_SPEC) for p in ("p0", "p1")}
    weights = {"p0": decisive_weights(1), "p1": decisive_weights(2)}
    maker = functools.partial(TwoCartPoles, time_limit=RLLIB_MA_TIME_LIMIT)
    cpu = MultiAgentEnvRunner(maker, specs, mapping, 4, 11, device="cpu")
    card = MultiAgentEnvRunner(maker, specs, mapping, 4, 11, device="cuda")
    card_w = {p: {k: v.to(card.device) for k, v in w.items()}
              for p, w in weights.items()}
    exact, errs, truncs = True, {}, 0
    for _ in range(2):
        want = cpu.sample(weights, RLLIB_MA_SAMPLE_LEN)
        got = card.sample(card_w, RLLIB_MA_SAMPLE_LEN)
        exact &= got["episode_returns"] == want["episode_returns"]
        for p in ("p0", "p1"):
            for k, w in want[p].items():
                if k in ("logp", "vf", "trunc_bonus", "bootstrap_value"):
                    errs[k] = max(errs.get(k, 0.0), _max_err(got[p][k], w))
                else:
                    exact &= (got[p][k].dtype == w.dtype
                              and np.array_equal(got[p][k], w))
            truncs += int(np.count_nonzero(want[p]["trunc_bonus"]))
    if not (exact and max(errs.values()) <= RLLIB_REL_TOL and truncs):
        failures.append(f"rllib_offline: multi-agent sample on the card "
                        f"against the CPU: exact {exact}, errors {errs}, "
                        f"truncation bonuses {truncs}")
    return dict(exact=exact, max_err=errs, truncation_bonuses=truncs,
                columns=int(want["p0"]["obs"].shape[1]))


def _ma_state_equal(a: dict, b: dict) -> bool:
    return (a["opt_state"]["count"] == b["opt_state"]["count"]
            and all(torch.equal(a[key][k], b[key][k])
                    for key in ("params",) for k in a[key])
            and all(torch.equal(a["opt_state"][m][k], b["opt_state"][m][k])
                    for m in ("mu", "nu") for k in a["opt_state"][m]))


def rllib_ma_train(name: str, mapping: dict, failures: list) -> dict:
    """PPO over TwoCartPoles as tests/test_rllib_multi_agent.py configures
    it, 3 iterations on the card, then a save/restore round trip."""
    policies = sorted(set(mapping.values()))
    config = (PPOConfig().environment(TwoCartPoles)
              .multi_agent(policies=policies,
                           policy_mapping_fn=mapping.__getitem__)
              .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(lr=5e-3, minibatch_size=64, num_epochs=2)
              .resources(device="cuda").debugging(seed=7))
    algo = config.build_algo()
    try:
        w0 = {p: lg.get_weights() for p, lg in algo.learner_groups.items()}
        rows = []
        for i in range(RLLIB_MA_ITERS):
            t0 = time.perf_counter()
            m = algo.train()
            torch.cuda.synchronize()
            rows.append(dict(iteration=i + 1,
                             wall_s=time.perf_counter() - t0,
                             sample_time_s=m["sample_time_s"],
                             learn_time_s=m["learn_time_s"],
                             losses={k: v for k, v in m.items()
                                     if k.endswith("total_loss")}))
        moved = {p: any(not torch.equal(lg.get_weights()[k], v)
                        for k, v in w0[p].items())
                 for p, lg in algo.learner_groups.items()}
        devices = sorted(
            {str(t.device) for lg in algo.learner_groups.values()
             for t in lg.learner.net.parameters()}
            | {str(t.device) for r in algo.env_runner_group.runners
               for mod in r.instance.modules.values()
               for t in mod.parameters()})
        with tempfile.TemporaryDirectory() as tmp:
            algo.save(tmp)
            algo2 = config.build_algo()
            try:
                algo2.restore(tmp)
                round_trip = algo2.iteration == algo.iteration and all(
                    _ma_state_equal(algo2.learner_groups[p].get_state(),
                                    lg.get_state())
                    for p, lg in algo.learner_groups.items())
            finally:
                algo2.stop()
    finally:
        algo.stop()
    finite = all(math.isfinite(v) for r in rows for v in r["losses"].values())
    if not (all(moved.values()) and finite
            and devices == RLLIB_ON_CARD["learner"]
            and round_trip and len(rows[-1]["losses"]) == len(policies)):
        failures.append(f"rllib_offline: multi-agent PPO ({name}) moved "
                        f"{moved}, losses finite {finite}, params on "
                        f"{devices}, save/restore equal {round_trip}")
    return dict(policies=policies, per_iteration=rows, moved=moved,
                devices=devices, save_restore_equal=round_trip,
                episode_return_mean=m["episode_return_mean"])


def rllib_offline_phase(card: str, failures: list) -> dict:
    """rllib's offline and multi-agent half on the card: each offline
    learner against itself on the CPU, the JAX tests' four learning gates,
    the multi-agent runner against itself on the CPU and multi-agent PPO.
    No kernel of ops/csrc lies on this path: it must launch none."""
    t_phase = time.perf_counter()
    before = _launch_counts()
    learners = {name: rllib_offline_learner_check(name, failures)
                for name in RLLIB_OFFLINE_LEARNERS}
    gates = {name: rllib_offline_gate(name, failures)
             for name in RLLIB_OFFLINE_GATES}
    multi_agent = dict(
        sample=rllib_ma_sample_check(failures),
        independent=rllib_ma_train("independent", {"a0": "p0", "a1": "p1"},
                                   failures),
        shared=rllib_ma_train("shared", {"a0": "shared", "a1": "shared"},
                              failures))
    launches = tuple(a - b for a, b in zip(_launch_counts(), before))
    if any(launches):
        failures.append(f"rllib_offline: the path launched kernels "
                        f"{launches}")
    seconds = time.perf_counter() - t_phase
    if seconds > RLLIB_OFFLINE_PHASE_S:
        failures.append(f"rllib_offline: the phase took {seconds} s "
                        f"(limit {RLLIB_OFFLINE_PHASE_S})")
    res = dict(phase="rllib_offline", spec=RLLIB_SPEC, rel_tol=RLLIB_REL_TOL,
               learners=learners, gates=gates, multi_agent=multi_agent,
               flash_launches=dict(zip(("fwd", "dq", "dkv"), launches)),
               seconds=seconds, card=card)
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    failures: list = []
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(dict(phase="device", card=card,
              name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    seconds = _build.build()
    ptxas = {name: _build.ptxas_report(log)
             for name, log in _build.build_logs.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_kernel=seconds, ptxas=ptxas))
    for name, log in _build.build_logs.items():
        print(f"--- ptxas report for {name} ---\n{log}", file=sys.stderr)
    spilled = [k for r in ptxas.values() for k in r
               if k["spill_stores"] or k["spill_loads"]]
    if spilled:
        failures.append(f"ptxas reports spills: {spilled}")

    rows = kernel_phase(card, failures)
    bwd_rows = kernel_bwd_phase(card, failures)
    tiling_phase(card, failures)
    pd_rows = paged_decode_phase(card, failures)
    (serve, serve_cache, serve_paged, serve_replica, serve_sp, serve_tp,
     serve_mesh, dplane, serve_rules, perf_res, serve_apps,
     decode) = serve_phases(card, failures)
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(card, failures)
    train_mesh, ref = train_mesh_phase(card, failures, train)
    train_rules = train_rules_phase(card, failures, ref)
    train_pp = train_pp_phase(card, failures, train, train_mesh, ref)
    train_sp = train_sp_phase(card, failures, train, train_mesh, ref)
    collective_phase(card, failures)
    train_ranks = train_ranks_phase(card, failures, train_mesh, ref)
    train_split = train_ranks["split_launches"]
    train_rules_ranks = train_ranks["rules_launches"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    moe_phase(card, failures)
    rllib_phase(card, failures)
    rllib_offline_phase(card, failures)

    def main_shape(rs, heads):
        mine = [r for r in rs if r["dtype"] == "bfloat16"
                and all(r[k] == v for k, v in heads.items() if k != "dtype")]
        return mine, max(mine, key=lambda r: r["S"])

    def shape(r):
        return {k: r[k] for k in ("B", "S", "Hq", "Hkv", "D", "dtype",
                                  "causal")}

    engine_rows, at = main_shape(rows, ENGINE_HEADS)
    tp_rows = [r for c in TP_KERNEL_CASES for r in main_shape(rows, c)[0]]
    train_rows, bat = main_shape(bwd_rows, TRAIN_HEADS)
    train_rows += [r for c in TP_BWD_CASES
                   for r in main_shape(bwd_rows, c)[0]]
    src = "ray_tpu_torch/ops/csrc/"
    emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:89",
             launches=(serve["flash_launches"]
                       + serve_cache["flash_launches"]
                       + serve_paged["flash_launches"]
                       + serve_replica["flash_launches"]
                       + serve_sp["flash_launches"]
                       + serve_tp["flash_launches"]
                       + serve_mesh["flash_launches"]
                       + dplane["flash_launches"]
                       + serve_rules["flash_launches"]
                       + perf_res["flash_launches"]
                       + serve_apps["flash_launches"]
                       + train["launches"]["fwd"]
                       + train_mesh["launches"]["fwd"]
                       + train_rules["launches"]["fwd"]
                       + train_pp["launches"]["fwd"]
                       + train_sp["launches"]["fwd"]
                       + train_ranks["launches"]["fwd"]
                       + train_split["fwd"]
                       + train_rules_ranks["fwd"]),
             launches_by_path=dict(
                 serve=serve["flash_launches"],
                 serve_cache=serve_cache["flash_launches"],
                 serve_paged=serve_paged["flash_launches"],
                 serve_replica=serve_replica["flash_launches"],
                 serve_sp=serve_sp["flash_launches"],
                 serve_tp=serve_tp["flash_launches"],
                 serve_mesh=serve_mesh["flash_launches"],
                 device_plane=dplane["flash_launches"],
                 serve_rules=serve_rules["flash_launches"],
                 perf=perf_res["flash_launches"],
                 serve_apps=serve_apps["flash_launches"],
                 train=train["launches"]["fwd"],
                 train_mesh=train_mesh["launches"]["fwd"],
                 train_rules=train_rules["launches"]["fwd"],
                 train_pp=train_pp["launches"]["fwd"],
                 train_sp=train_sp["launches"]["fwd"],
                 train_ranks=train_ranks["launches"]["fwd"],
                 train_split_ranks=train_split["fwd"],
                 train_rules_ranks=train_rules_ranks["fwd"]),
             max_abs_err=max(r["max_abs_err_o"]
                             for r in engine_rows + tp_rows),
             ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
             bound_by=at["bound_by"], library_ms=at["library_ms"],
             library_backend=at["library_backend"], shape=shape(at)),
        dict(name="flash_attention_dq", route="cuda",
             source=src + "flash_attention_dq.cu",
             replaces="ray_tpu/ops/flash_attention.py:107",
             fuses="delta (ray_tpu/ops/flash_attention.py:270)",
             delta_max_rel_err=max(r["delta_rel_err"] for r in train_rows),
             launches=(train["launches"]["dq"]
                       + train_mesh["launches"]["dq"]
                       + train_rules["launches"]["dq"]
                       + train_pp["launches"]["dq"]
                       + train_sp["launches"]["dq"]
                       + train_ranks["launches"]["dq"]
                       + train_split["dq"]
                       + train_rules_ranks["dq"]),
             launches_by_path=dict(train=train["launches"]["dq"],
                                   train_mesh=train_mesh["launches"]["dq"],
                                   train_rules=train_rules["launches"]["dq"],
                                   train_pp=train_pp["launches"]["dq"],
                                   train_sp=train_sp["launches"]["dq"],
                                   train_ranks=train_ranks["launches"]["dq"],
                                   train_split_ranks=train_split["dq"],
                                   train_rules_ranks=train_rules_ranks[
                                       "dq"]),
             max_abs_err=max(r["max_abs_err_dq"] for r in train_rows),
             ms=bat["dq_ms"], plain_ms=bat["plain_dq_ms"],
             bound_ms=bat["dq_bound_ms"], bound_by=bat["dq_bound_by"],
             library_ms=bat["library_ms"], library_covers="dq, dk, dv",
             library_backend=bat["library_backend"], shape=shape(bat)),
        dict(name="flash_attention_dkv", route="cuda",
             source=src + "flash_attention_dkv.cu",
             replaces="ray_tpu/ops/flash_attention.py:154",
             launches=(train["launches"]["dkv"]
                       + train_mesh["launches"]["dkv"]
                       + train_rules["launches"]["dkv"]
                       + train_pp["launches"]["dkv"]
                       + train_sp["launches"]["dkv"]
                       + train_ranks["launches"]["dkv"]
                       + train_split["dkv"]
                       + train_rules_ranks["dkv"]),
             launches_by_path=dict(train=train["launches"]["dkv"],
                                   train_mesh=train_mesh["launches"]["dkv"],
                                   train_rules=train_rules["launches"]["dkv"],
                                   train_pp=train_pp["launches"]["dkv"],
                                   train_sp=train_sp["launches"]["dkv"],
                                   train_ranks=train_ranks["launches"]["dkv"],
                                   train_split_ranks=train_split["dkv"],
                                   train_rules_ranks=train_rules_ranks[
                                       "dkv"]),
             max_abs_err=max(max(r["max_abs_err_dk"], r["max_abs_err_dv"])
                             for r in train_rows),
             ms=bat["dkv_ms"], plain_ms=bat["plain_dkv_ms"],
             bound_ms=bat["dkv_bound_ms"], bound_by=bat["dkv_bound_by"],
             library_ms=bat["library_ms"], library_covers="dq, dk, dv",
             library_backend=bat["library_backend"], shape=shape(bat)),
        dict(name="paged_decode_attention", route="cuda",
             source=src + "paged_decode.cu",
             replaces="none (ray_tpu/llm/engine.py:220-230 is jnp under jit)",
             launches=sum(c["got"] for c in decode.values()),
             launches_by_path={k: c["got"] for k, c in decode.items()},
             max_abs_err=max(r["max_abs_err"] for r in pd_rows),
             at={r["case"]: {k: r[k] for k in (
                 "ms", "device_ms", "plain_ms", "bound_ms", "share_of_bound",
                 "device_share_of_bound")} for r in pd_rows})]})
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
