#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Card and build: print the card's name and power limit, turn TF32 off
   for float32 matmuls and convolutions, and build every CUDA kernel of
   the port from ``paddle_tpu_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (one compiler process per source, all at once).
2. Kernels against their plain torch versions, on the card, at the
   shapes of the paths that run them (plus larger shapes for the
   serving kernels: paged decode at 32 slots, H 8, D 128 and over a long
   cache of 4096 rows a slot, with its device time beside each call's;
   bias softmax on a ragged row and on rows of 2048, naming the body that
   ran), with each kernel's time beside its plain version's,
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (its bound).  float32 within
   ``atol = rtol = 1e-5`` (the two sum in different orders), bfloat16
   outputs within one bf16 rounding of themselves (``BF16_RTOL``, plus
   ``BF16_ATOL_SCALE`` times the output's RMS; see ``assert_matches``).
   The bfloat16 single-pass forward (tensor cores) is held to one
   rounding of the plain version with tensor-core-summed scores, and of
   the float32-product one plus each element's rounding-flip slack
   (``assert_forward_matches``); the bfloat16 flash forward to one
   rounding of the row-max plain version plus the slack of its tiles'
   running max, and of the plain version that tiles as it does plus the
   rounding-flip slack (``assert_flash_forward_matches``); the bfloat16
   backward bodies (tensor cores: the flash dQ and dK/dV, the single-pass
   backward in both layouts) to one rounding plus the flip slack of
   ``T(p)`` and ``T(dS)`` (``assert_backward_matches``); the log lines
   count the elements that needed a slack.  The bfloat16 instantiations
   of the single-pass forward and backward kernels, of the three flash
   kernels and of the 3x3 conv must hold tensor-core instructions
   (``HMMA``) in ``cuobjdump -sass`` of the built libraries, and their
   float32 instantiations none.
3. Serving: export a seeded ``GenLongConfig`` bundle with the port, load
   ``GenPredictor`` on ``cuda:0`` and serve requests through
   ``GenScheduler`` (continuous batching), once with the paged KV decode
   (10 requests) and once with the dense decode (``paged=False``, 4
   requests: its decode softmax takes a ``[S, 1, 1, L]`` row bias through
   the bias-softmax kernel).  Every stream must complete, the scheduler
   must never crash, every greedy stream must be token-identical to the
   port's own cache-free re-prefill, and the kernels' launch counts over
   the run must equal what the run's prefills and decode steps imply.
   Then the serving front over HTTP on ``127.0.0.1``: the paged bundle
   from ``InferenceServer(warmup=True, async_load=True)``, whose
   ``/readyz`` turns 200 only once the warmup report lists every prompt
   and page bucket and after which no kernel is built; the ten prompts
   as concurrent streamed ``ServingClient.generate`` calls,
   token-identical to the in-process streams, with the two kernels
   launched ``prefills x n_layer`` and ``decode_steps x n_layer`` times
   in every round and the peak allocation flat over ``HTTP_ROUNDS``
   rounds, each followed by a round of the same prompts on the server's
   scheduler in process (the median, least and most tokens/s, TTFT and
   inter-token gaps of each kind printed); two servers and one client
   over both, whose stream resumes on the other server token-identically
   after its owner aborts or drains mid-stream; ``/predict`` through the
   ``MicroBatcher`` at ``bench_serving.py``'s width (feature 32, twelve
   ``fc`` 2048 + ReLU, ``fc`` 4; 8 closed-loop clients), every reply
   equal to a local ``Predictor.run`` to ``PREDICT_TOL``, batches of more
   than one request, no hand-written kernel; and ``python -m
   paddle_tpu_torch serve --warmup`` in a subprocess, ``generate``
   printing the first prompt's stream, ``stats``, every wait bounded by
   ``HTTP_WAIT_S``.
4. Training, route A (composed attention, the bias-softmax kernels),
   route B (streaming attention, the flash kernels) and route C
   (single-pass attention, the ``smalls`` pair): the Transformer-base
   step of ``bench.py`` at full width and depth (d_model 512, 8 heads,
   d_inner 2048, 6 + 6 layers, vocab 10000), bf16 AMP, Adam lr 1e-4,
   dropout 0.1, through ``transformer()``, ``Adam.minimize`` and
   ``Executor.run`` on ``cuda:0``, a few steps on one fixed batch.  The
   loss must be finite and fall, and each of the route's kernels must
   launch exactly 18 times a step (6 encoder self, 6 decoder self and 6
   cross attentions) while every other kernel launches none.  Route A
   runs S = 256 at B = 64 (``bench.py`` runs B = 256; cut for this
   script's time limit), route B S = 2048 at B = 8, route C S = 512 at
   B = 32 (each the same 16384 tokens a step).  Then the causal LM of
   ``gen_lm_train_program`` (``GenLongConfig``) takes a few Adam steps:
   a second model that trains through the bias-softmax kernels.  Then
   the ``[B, S, H, D]`` attention of ``exp_torch_bshd_attn.py`` (the
   ``bshd`` pair: no head transposes): its ``check_numerics`` and a few
   forward + backward steps at B 256, S 256, H 8, D 64, bf16, causal,
   exactly the pair's launches and no other kernel's; then its routes
   with the transposes (the single-pass pair, the composed matmuls) and
   SDPA, their grads against SDPA's and their times.
5. Card against CPU: one step of the same program at full width and
   depth 1 + 1, float32, TF32 off, dropout 0, from one scope, on the card
   (kernels) and on the CPU (their plain versions), for each route; the
   losses and every parameter's grad (its first Adam moment) must agree
   (``CARD_CPU_*``).  And every further optimizer (and ``noam_decay``
   under ``Momentum``) takes three steps of a small fc program on the
   card and on the CPU from one state: parameters and accumulators agree
   to ``OPTIMIZER_TOL``.
6. The conv zoo.  ``conv3x3_bn_act`` against its plain version at
   ResNet-50's four 3x3 shapes (N = 256, bf16 on the tensor cores, ReLU
   on and off; one float32 case on the CUDA cores held to
   ``kernels.conv3x3.f32_tolerance``), with cuDNN's times beside it
   (``F.conv2d`` with the same epilogue, and alone).  ResNet-50
   (``resnet_train_program`` at full width and depth, 224x224, 1000
   classes, B = 256 as ``bench_resnet.py``),
   VGG-16 (32x32x3, 10 classes) and the MNIST convnet train a few steps
   with ``Momentum(0.01, 0.9)`` and bf16 AMP: loss finite and falling, no
   hand-written kernel launched (cuDNN convs), ResNet-50's step time,
   images/s, MFU and peak memory reported.  Then the trained ResNet-50
   goes through ``save_inference_model`` / ``load_inference_model`` and
   runs on the card in float32: its predictions equal the test clone's,
   and each of its sixteen 3x3 ``conv2d -> batch_norm -> relu`` chains,
   run through ``conv3x3_bn_act`` with the batch norm folded, gives the
   program's own output, and the same inputs in bf16 give the plain
   version's within one rounding (exactly 32 launches, 16 float32 and 16
   bf16: the kernel's path).  One float32 step of
   ResNet-50 (B = 2) on the card and on the CPU from one scope: the loss
   to ``CARD_CPU_LOSS_RTOL``, the running batch-norm statistics to
   ``F32_TOL``, the grads (velocities) above every ReLU kink to
   ``CARD_CPU_TOP_GRAD_RTOL`` and all of them against a float64 step on
   the CPU (``CARD_CPU_F64_FACTOR``).
7. Wide & Deep with sparse grads (W&D-Criteo: 13 dense and 26
   categorical features, embeddings of 32, ReLU layers of 1024, one
   shared table of 2**23 rows, B = 4096, float32, ``Adam(1e-3)``):
   ``wide_and_deep_train_program``, ``Adam.minimize`` and
   ``Executor.run`` on ``cuda:0``, ten steps on one seeded batch whose
   ids follow a power law: loss finite and falling, no hand-written
   kernel launched, both tables' grads SelectedRows of B * 26 slots
   (never a dense ``[vocab, dim]`` tensor; their dead slots kept, the
   static slot count), the step a CUDA graph, and a steady step's peak
   allocation above the state under the deep table's 1 GiB; the same
   ten steps eagerly (``_opt_interpret``) from the same state: the
   losses and every parameter equal, or within ``WD_GRAPH_ATOL``.
   Printed beside them: step time graphed and eager, examples/s, peak
   memory, unique rows, the same ids at a table of 2**20 rows and the
   dense route (``is_sparse=False``).  One float32 step at 65536 rows on the card
   and on the CPU from one scope: the loss, every parameter's Adam
   moments (both tables' too) and every parameter element agree
   (``phase_card_vs_cpu_wide_deep``).
8. LoD sequences, LSTM-IMDB-H512 (``models.stacked_lstm.BENCHMARK_LSTM``:
   the reference's stacked dynamic LSTM benchmark, dictionary 30000,
   embeddings and 2 peephole LSTM layers of 512, 64 sequences of 2 ...
   100 words, float32, ``Adam(1e-3)``): ``stacked_lstm_net``,
   ``Adam.minimize`` and ``Executor.run`` on ``cuda:0`` fed ``(words,
   lod)``, 20 steps on one seeded batch (loss finite and falling), then
   10 steps each on a fresh batch with new lengths (every loss finite),
   no hand-written kernel launched; each ``lstm``'s ``Hidden`` carries
   the feed's LoD and the pooled features are ``[64, 1024]``.  Printed:
   step time, sequences/s, rows a step, peak memory.  One float32 step
   at emb and hidden 32 (8 sequences of 2 ... 12 words) on the card and
   on the CPU from one scope: the loss, every parameter's Adam moments
   and every parameter element agree
   (``phase_card_vs_cpu_stacked_lstm``).  Then the sentiment book's two
   nets (``tests/test_book_understand_sentiment.py``: the convolution
   net over ``nets.sequence_conv_pool``, the 3-layer stacked LSTM) at
   its widths train a few Adam steps each: loss finite and falling, no
   hand-written kernel.  Then LSTM-IMDB-H512 in the bucketed LoD mode
   (``main.lod_buckets``; ``phase_stacked_lstm_buckets``):
   ``bench_lstm.py``'s windows of 16 fresh batches, each window one
   ``run_steps`` padded to one (rows, length) bucket with the splits fed
   as ``words@lod0``, the last window the first again; from one state
   as CUDA graphs and eagerly (``_opt_interpret``, twice): the fresh
   windows' losses within ``BUCKET_LOSS_RTOL`` step by step (the
   repeated window's beside two eager runs'), step-cache misses no more
   than the
   bucket pairs the windows reach, every loss finite and the repeated
   window's mean lower; one bucketed step against the static-LoD step
   on the same state and batch within ``BUCKET_LOSS_RTOL``.  Printed: ms
   a batch graphed and eager, capture seconds, graph nodes, peak GiB.
9. Control flow, Seq2Seq-NMT-512 (``models.seq2seq.SEQ2SEQ_NMT_512``:
   ``bench_seq2seq.py``'s widths, dictionaries of 30000, embeddings,
   bi-LSTM encoder and decoder of 512, 16 sentence pairs of 2 ... 50
   tokens, float32, ``Adam(1e-3)``): ``seq_to_seq_net``,
   ``Adam.minimize`` and ``Executor.run`` on ``cuda:0``; the decoder is
   one ``while`` over a sub-block (tensor arrays, a rank table) and its
   grad one ``while_grad``: T masked trips each (T the longest target),
   nothing read on the host.  2 warm-up and 8 timed steps on one batch
   (loss finite, lower after them than at the first step), then 4 steps
   each on a new batch and LoD; no hand-written kernel launched; the
   block stays eager (the static LoD's tables).
   Printed: ms a step, target tokens/s, the ``while`` trips and device
   reads a step, the peak above the state.  One float32 Adam step at
   width 32 (dictionaries of 100, 4 pairs) on the card and on the CPU
   from one scope: the loss to relative 1e-5, every parameter within
   what Adam's first step allows (``phase_card_vs_cpu_seq2seq``).  Then
   Seq2Seq-NMT-512 in the bucketed LoD mode (``phase_seq2seq_buckets``):
   2 windows of 8 fresh batches, each one ``run_steps``, and the first
   again, from one state as CUDA graphs (the ``while`` a bounded loop of
   T_bucket masked trips, the arrays device buffers) and eagerly
   (``_opt_interpret``): the losses equal or within ``BUCKET_LOSS_RTOL``
   (the sequence ops' segment sums add by float atomics), finite, the
   repeated window's mean lower, no host read, ``while`` trips twice the
   target length bucket, misses and graphs bounded by the bucket pairs;
   the first window's batches once more as per-batch bucketed ``run``s
   (each in its own buckets), their losses within ``BUCKET_LOSS_RTOL``
   of the windows'; printed: ms a batch both ways, target tokens/s,
   capture seconds, graph nodes, peak GiB.  Then the beam decode of
   ``tests/test_beam_search.py``'s ``_build_decode`` (transcribed here
   with ``pt.layers``) at dictionary 30000, embedding and hidden 512, 16
   sources, beam 4, 50 steps: with a static LoD (eager), and fed
   bucketed as a CUDA graph and eagerly: well-formed hypotheses, the
   same sentences and scores graphed and eager, ms a decode each way;
   and at the test's width the CPU's static decode against the card's
   static, bucketed graphed and bucketed eager decodes: the same
   sentences and scores (``phase_beam_decode``).
10. Static analysis and the executor's switches.  Route A of phase 4
   from one startup state, unoptimized and under ``PADDLE_TPU_OPT=1
   PADDLE_TPU_VERIFY=1`` (the verify-sandwiched pass pipeline of
   ``analysis/opt`` and the structural verifier before the first run):
   the losses agree step by step to ``TRAIN_OPT_LOSS_RTOL`` (bit for bit
   where no float constant was folded), no pass is aborted, and both
   runs launch exactly the bias-softmax pair 18 times a step; printed:
   the op counts, each pass's stats, the optimize and verify seconds,
   the steady step both ways and ``cost.estimate``'s FLOPs as a share
   of the card's bf16 dense peak.  Route A with ``check_nan_inf`` gives
   the unchecked losses (its step time beside the plain one); on the
   card ``log(-1)`` under the mode raises naming its variable, ``gather``
   and ``lookup_table`` at index -1 and ``n`` give the last row and NaN
   rows and the process's next run works, and the saturating ``cast``
   equals the CPU's.  The paged serving bundle under
   ``InferenceServer(gen_prefill_budget=...)`` (the longest prompt's
   static prefill cost): the ten concurrent streams token-identical to
   the unbudgeted ones in ``HTTP_ROUNDS`` rounds, the kernels launched
   ``prefills x n_layer`` and ``decode_steps x n_layer`` times, the cut
   admission passes and TTFT beside the unbudgeted rounds', and the cost
   model's prompt and page buckets for the ten lengths.
11. CUDA graphs.  Every phase above runs through the executor's
   default path, where a block the capture rule allows runs as one CUDA
   graph per signature (its first run eager, its second captured and
   replayed); each path that should run as graphs must have replayed one
   (the Transformer routes, the gen-LM prefill and decode, the
   ``/predict`` MLP, MNIST, VGG-16, ResNet-50 training and inference,
   the bucketed LSTM-IMDB-H512), and W&D-Criteo (sparse), the static-LoD
   LSTM-IMDB-H512 and Seq2Seq-NMT-512 (static and bucketed) none.
   The exact launch counts hold: a replay adds the launches its capture
   tallied.  ``phase_graph_train``: routes A, B and C from one startup
   state, ``TRAIN_STEPS`` steps graphed and eagerly (a clone with
   ``_opt_interpret``): losses bit-identical (or within two eager runs'
   spread), parameters' max difference, steady step both ways, capture
   seconds, graph nodes, peak allocated and reserved GiB.
   ``phase_graph_serving``: the ten prompts through a graphed and an
   eager predictor, streams token-identical, no capture after warmup,
   prefill and decode-step medians; ``phase_http_generate`` also checks
   that every bucket is a captured graph at ``/readyz`` and that no
   round captures.
12. Input pipeline and checkpoints.  ``phase_reader_train``: route A fed
   as bench.py's recordio mode feeds it (16 ``T.fake_batch`` batches in
   a raw recordio file, ``open_recordio_file`` -> ``double_buffer`` ->
   ``read_file``), two ``run_steps(16)`` windows graphed: the native
   codec, losses bit-identical to the memory-fed windows of the same
   batches from one startup state, 18 + 18 bias-softmax launches a step,
   one cache miss; ms a step both ways.  ``phase_checkpoint_resume``:
   route A at dropout 0 in a trainer process that saves, receives
   SIGTERM under ``GracefulShutdown`` after step ``CKPT_K`` and commits,
   and a second that ``restore_latest()``s and runs the next ``CKPT_K``:
   every persistable bit-identical to a run that never stopped;
   ``save_async`` then a step: the checkpoint equals the snapshot; a
   blocking save's device peak under a quarter of the state (it clones
   nothing); the state's GiB and save, verify and restore seconds
   (``--ckpt-trainer`` runs a trainer).
13. The book's op families and semantic role labeling.
   ``phase_op_families``: each of the 54 op types of the tensor, math,
   loss, nn, metric, CRF and CTC families that this slice ported (held
   against the registry: ``family_ops``) and each op whose NaN grads or
   integer inputs were repaired runs on the card and on the CPU from the
   same seeded inputs (``op_family_cases`` is also the CPU tests' case
   list): float32 within ``F32_TOL``, integers and host outputs equal,
   grads likewise; the random ops by range, moments and seeding.
   ``phase_label_semantic_roles``: the Fluid book's SRL model (8
   features, the fixed 44068 x 32 word embedding, hidden 512, depth 8,
   59 labels, linear-chain CRF, B = 10 unclipped ``conll05`` sequences)
   trains 20 SGD steps through ``layers``, ``SGD.minimize`` and
   ``Executor.run``: losses finite and falling, ``ChunkEvaluator`` equal
   to a plain IOB recount of the decoded paths, no hand-written kernel;
   ms a step, tokens/s, peak memory.  ``phase_card_vs_cpu_srl``: one
   float32 step of it on the card and on the CPU from one state: loss,
   grads and parameters within the card-vs-CPU bounds, Viterbi paths
   equal but at a counted near tie.
14. Detection, CSP and the C inference ABI.  ``phase_op_families``
   also runs the ten detection op types (``detection_op_cases``; the
   ``roi_pool`` and ``scale_sub_region`` grads) card against CPU.
   ``phase_ssd``: MobileNet-SSD on Pascal VOC (``SSD_VOC``: PaddlePaddle's
   2018 ``mobilenet_ssd.py`` at its published widths, 300 x 300, 21
   classes, 1917 priors, B 32, ``ssd_loss`` summed, RMSProp under
   ``piecewise_decay`` with L2Decay 5e-5; seeded images with 1 to 8
   boxes each, ~10% difficult) trains 5 batches x 4 passes eagerly: loss
   finite and falling, no hand-written kernel; then ``detection_output``
   (NMS 0.45) and ``evaluator.DetectionMAP`` (11-point) over held-out
   batches, the streamed mAP equal to a plain numpy recount
   (``voc_map_recount``); then the test program's inference bundle
   through ``load_inference_model`` + ``Executor.run``,
   ``serving.Predictor`` and the C ABI (``native.load_capi``,
   ``ctypes``): identical rows.  Printed: ms a step, images/s, state and
   peak GiB.  ``phase_card_vs_cpu_ssd``: one float32 step at full width,
   B 4, card against CPU (and the CPU in float64): loss, grads against
   float64 as ResNet-50's, match indices equal, negatives equal but at
   counted near ties.  ``phase_csp``: the programs of
   ``tests/test_concurrency.py`` and a ``go`` body running device ops on
   a tensor received through a channel, card against CPU, each run
   joined within ``CSP_TIMEOUT_S``.
15. Device-facing services on route A at full width (graphed, bf16
   AMP).  ``phase_sentinel`` (dropout 0): ``SENTINEL_STEPS`` clean steps,
   then the same steps from the same state under a ``Sentinel(cadence=1,
   strikes=2)`` with a ``CheckpointManager`` (saves after steps 2 and 4)
   and ``sentinel.nan`` on the 5th and 6th checks, in the explicit loop
   of the ``Sentinel`` docstring: the applied losses equal the clean
   run's bit for bit, ``sentinel.skipped_steps`` 2, ``.quarantined`` 2,
   ``.rollbacks`` 1 to ``last_good_step()`` (2), the guarded step one
   CUDA graph whose write-back follows the check, the bias-softmax pair
   18 launches a run; an inf parameter before a guarded replay trips
   naming it and leaves every tensor of the scope bit-equal; the guarded
   and unguarded steps' medians and the ``train.*`` health gauges
   printed; ``ckpt verify`` on the drill's directory (PASS with the
   last-good pointer, exit 1 after a truncated file).  ``python -m
   paddle_tpu_torch replay`` and ``replay --localize`` on a quarantined
   bundle of ``SENTINEL_REPLAY_LAYERS`` layers (exit 0, the loss's op
   named) run on the CPU in two subprocesses started after the kernel
   phases (``start_replays``) and read at the end (``join_replays``), so
   they overlap the card phases.  ``phase_perf`` (dropout 0.1): ``train.mfu`` after the graphed
   steps equal to the record's ``flops / (step s x 989 TFLOP/s)``, the
   HBM census (``params + optimizer`` the scope's bytes, ``total`` at
   most ``memory_allocated()``, the watermark at least ``total``),
   ``measure_device_seconds`` over 3 replays at most their wall time,
   a trace's kernel union, plain sum and ``scope_device_seconds(...,
   "bias_softmax")`` equal to that kernel's events; ``profile op`` lists
   ``softmax`` and ``softmax_grad``, ``profile memory --json`` and
   ``profile compile --json`` pass ``validate_report``; the paged
   serving bundle's decode sets ``gen.decode_mfu``, leaves ``train.mfu``
   and counts its pool as ``kv_pages``.
16. The training loop a real run uses, on route A at full width
   (graphed, bf16 AMP).  ``phase_datapipe_train``: ``PIPE_STEPS`` x 64
   per-sample records written by ``recordio_writer``, read by
   ``RecordIOSource -> shuffle(256) -> map(decode, workers=4) ->
   batch(64) -> prefetch(depth=2)`` onto ``cuda:0`` and driven by
   ``Executor.run_pipeline`` with a ``RunLedger`` at dropout 0.1: losses
   bit-identical to a memory-fed ``Executor.run`` of the same batches in
   the same order from one state, 18 + 18 bias-softmax launches a step,
   one graph, one ledger row a step, the census's ``prefetch`` bytes
   above 0 while batches wait and 0 after, the ``datapipe.next`` and
   ``train.step`` spans through ``trace dump --local``; at dropout 0 the
   resume drill (``PIPE_K`` steps, a commit while prefetch holds queued
   batches, a fresh executor, scope, pipeline and ledger,
   ``restore_latest()``, ``PIPE_K`` more under a sentinel with two
   poisoned checks: one rollback to the restored step, the pipeline and
   ledger rewound; every persistable bit for bit an unbroken run's, the
   ledger one row a step, each batch applied once),
   ``release_memory`` on an eager step and a capture (losses unchanged;
   peak and pool printed), ``bench record`` / ``check`` of its figures;
   ms a step both ways and the stall's p50 / p99 printed, gated on no
   time.  ``phase_cli`` also runs ``version``, ``train --config`` (route
   A at 1 layer through ``manager_from_env``, ``run_pipeline`` and a
   ``RunLedger``, read back by ``runs show`` / ``runs tail``) and
   ``infer --place cuda`` as concurrent subprocesses.
17. Multi-GPU at world size 1 (the card is one GPU; NCCL refuses two
   ranks on one device).  ``phase_parallel_train``: ``init_parallel_env``
   in this process over NCCL, then route A at full width (dropout 0)
   through ``ParallelExecutor`` on a ``(1, 1)`` ``("data", "model")``
   mesh with ``tp_shardings()`` and ZeRO for ``PARALLEL_STEPS`` steps
   (a CUDA graph from the second): losses and every persistable
   bit-identical to ``Executor.run``
   of the same state and feeds, 18 + 18 bias-softmax launches a step on
   the kernels and none of their plain versions; ms a step both ways,
   the collectives of a step (none at one rank) and the first step's
   NCCL broadcasts, the graph (an op that DTensor refuses fails it);
   the ``ring_attention`` op at ``seq`` size 1 against plain attention
   (``RING_TOL``) and the eight ``c_*`` ops pinned to ``data``, one NCCL
   collective each.  The process group is destroyed after it.
   ``phase_pipeline_train``: route A at full width (dropout 0, bf16 AMP)
   through ``pipeline_transpiler(main, 1, ...)`` on a world-1 NCCL
   ``pipe`` mesh, the batch of 64 as ``PIPE_MICROBATCHES`` microbatches of
   16, forward and backward of the summed loss for ``PIPELINE_STEPS``
   steps: each microbatch's loss within one bf16 rounding
   (``BF16_RTOL``) of ``Executor.run`` of it on the same scope (printed:
   whether bit-identical), every parameter's grad within one bf16
   rounding (``BF16_RTOL``, ``BF16_ATOL_SCALE`` x RMS) of the
   ``append_backward`` grads summed over the microbatches, the
   bias-softmax pair on its kernels 72 + 72 times a step (18 + 18 a
   microbatch; the backward reads the forward's kept graph, no
   recompute) and its plain versions never, ``lint_pipeline`` of the
   program at 2 and 4 stages clean; ms a step.
   ``phase_sharded_tables``: W&D-Criteo at ``phase_wide_deep``'s widths
   and table height through ``ParallelExecutor`` on a world-1 NCCL
   ``data`` mesh with ``plan_sharded_tables``' rules (each table and its
   Adam moments ``Shard(0)``), ``WD_COMPARE_STEPS`` steps: losses and
   every persistable bit-identical to ``Executor.run`` from the same
   state, no kernel launched; ``sharded_gather`` /
   ``sharded_scatter_add`` of a batch's ids at the table's height equal
   to dense indexing.  Each destroys its process group.
18. The fleet (``phase_fleet``, ``phase_fleet_controller``,
   ``phase_master_train``).  Phase 3's paged bundle served by a
   ``MasterServer`` holding replica leases (TTL ``FLEET_LEASE_TTL_S``),
   two in-process ``FleetReplica``s and a child ``serve --master`` on
   ``cuda:0``, behind a master-discovered ``FleetRouter``: the ten
   streams through it token-identical to phase 3's; the router's
   ``gen.session.kill_owner`` drill and the child's own
   ``fleet.replica.kill=kill@N`` each resumed on a survivor token- and
   index-identical with one resume, the child's lease dropped within TTL
   + one heartbeat, the corpse stale in ``/metrics?fleet=1`` and a
   failure of ``trace dump --fleet``; ``master.lease.expire`` answered
   503 ``lease_lost`` then a rejoin; a rolling restart under a stream
   with a warmed replacement that builds nothing; the federation's
   headroom rollup equal to the least the replicas report; the kernels
   launched ``n_layer`` times a prefill and a decode step.  Then a
   ``FleetController`` (``CTL_POLICY``) over one replica with a standby
   warmed on the card, a ``TrafficReplay`` step of real streams against
   a p99 TTFT objective of half the one-replica median at the peak: the
   ladder climbs, the standby is enrolled and serves without a build, no
   accepted request is lost, every shed carries ``Retry-After``, the
   idle drain returns to one replica.  Then route A at full width
   (dropout 0) fed by the master's task leases: through
   ``cloud_reader``, and through a trainer that abandons a lease and a
   fresh one that restores its checkpoint after the requeue, every
   persistable bit-identical.
19. Report: a ``{"graphs": [...]}`` line (each graph's path, signature,
   captures, replays, capture seconds, nodes, pool growth), a
   ``{"kernels": [...]}`` line (every kernel's fields; the
   single-pass kernels also name the second TPU kernel each stands for,
   ``also_replaces``, the redesigned kernels what their redesign changed
   and their SASS's tensor-core instruction counts, ``flash_fwd`` its
   repair and its route B device time, ``device_ms``), a
   ``{"profiler_short_captures": [...]}`` line (every ``torch.profiler``
   capture that came back short of launches the wrappers counted), a
   ``{"phase_seconds": {...}}`` line (each phase's wall seconds and the
   run's), the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  Exits non-zero when CUDA is
unavailable or the port is not beside it.  Writes its bundle and build
logs under ``runs/chip_smoke/``.
"""

import contextlib
import gc
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke")

#: float32 tolerance of a kernel against its plain version: the kernel
#: and torch reduce in different orders
F32_TOL = 1e-5
#: bfloat16 output against its plain version: both compute in float32
#: from the same bf16 inputs and round once to bf16, so an element may
#: differ by one bf16 ulp of itself (at most 2**-7 of it) where the two
#: float32 values straddle a rounding boundary; ``BF16_ATOL_SCALE`` times
#: the output's RMS covers the float32 summation-order error of elements
#: near zero
BF16_RTOL = 2.0 ** -7
BF16_ATOL_SCALE = 2.0 ** -8
#: H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, float32
#: (non-tensor-core) operations/s and bf16 dense tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

SEED = 20260416
PAGE_LEN, NUM_SLOTS = 16, 8
PROMPT_LENS = (15, 16, 17, 31, 33, 48, 64, 100, 150, 199)
MAX_NEW_TOKENS = 32


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call of ``fn`` on the card: CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls (so small
    kernels include their launch cost, as the serving loop pays it)."""
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


def _device_events(fn, iters, warmup):
    """``(name, microseconds)`` of every CUDA kernel ``iters`` calls of
    ``fn`` ran, by ``torch.profiler``, after ``warmup`` calls.  The
    profile's first step, one more call, is the profiler's own warm-up and
    its events are dropped: a capture that counts from the moment tracing
    is switched on has come back short of a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [(ev.name, float(ev.time_range.end - ev.time_range.start))
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


#: profiler captures ``device_ms`` takes before it fails.  The profiler
#: has returned captures short of launches that the wrappers counted (4
#: of 10 flash forwards once; 8, 0 and 5 of 10 in three captures
#: running, and three short of the flash backward before a full one, in
#: two runs of one tree whose next runs, and the parent's in the same
#: call, saw every launch), so a short capture is taken again.  Each
#: capture must still see every launch, and the wrappers' counts must
#: show a launch on every call of every capture (``_captured``), so a
#: wrapper that skips its kernel fails at its first capture however many
#: retakes there are
DEVICE_MS_CAPTURES = 8
#: every capture the profiler returned short of launches that the
#: wrappers' own counts show ran: ``{"kernels", "seen", "calls",
#: "launched"}`` each, printed in the ``{"profiler_short_captures"}``
#: line so that their trend shows from run to run
PROFILER_SHORT = []


def _wrapper_launches():
    from paddle_tpu_torch.kernels import ALL_KERNELS
    return sum(k.launches for k in ALL_KERNELS)


def _captured(fn, iters, warmup):
    """``_device_events`` and the launches the wrappers counted in it,
    which must be the same whole number for each of its ``warmup + 1 +
    iters`` calls: a wrapper that skips its kernel on some calls fails
    here, whatever the profiler saw."""
    calls = warmup + 1 + iters
    before = _wrapper_launches()
    events = _device_events(fn, iters, warmup)
    launched = _wrapper_launches() - before
    if launched <= 0 or launched % calls:
        raise AssertionError(f"the wrappers counted {launched} launches in "
                             f"{calls} calls")
    return events, launched


def device_ms(fn, names, iters=10, warmup=2):
    """Mean device milliseconds a call of ``fn`` spends in each CUDA kernel
    whose name holds one of ``names`` (each must launch once a call), by
    ``torch.profiler`` over ``iters`` calls after ``warmup`` calls."""
    for _ in range(DEVICE_MS_CAPTURES):
        us = dict.fromkeys(names, 0.0)
        seen = dict.fromkeys(names, 0)
        events, launched = _captured(fn, iters, warmup)
        for name, t in events:
            for n in names:
                if n in name:
                    us[n] += t
                    seen[n] += 1
        if all(seen[n] == iters for n in names):
            return {n: us[n] / iters / 1e3 for n in names}
        PROFILER_SHORT.append({"kernels": list(names), "seen": seen,
                               "calls": iters, "launched": launched})
        log(f"device_ms: profiler saw launches {seen}, want {iters} each "
            f"(the wrappers counted {launched} in {warmup + 1 + iters} "
            f"calls); capturing again")
    raise AssertionError(f"profiler saw launches {seen}, want {iters} each "
                         f"in {DEVICE_MS_CAPTURES} captures")


def device_ms_sum(fn, names, iters=10, warmup=2):
    """Mean device milliseconds a call of ``fn`` spends in every CUDA
    kernel whose name holds one of ``names`` (launched any number of times
    a call, at least once), by ``torch.profiler`` over ``iters`` calls."""
    for _ in range(DEVICE_MS_CAPTURES):
        events, launched = _captured(fn, iters, warmup)
        hits = [t for name, t in events if any(n in name for n in names)]
        if len(hits) >= iters:
            return sum(hits) / iters / 1e3
        PROFILER_SHORT.append({"kernels": list(names), "seen": len(hits),
                               "calls": iters, "launched": launched})
        log(f"device_ms_sum: profiler saw {len(hits)} launches of {names} "
            f"in {iters} calls (the wrappers counted {launched} in "
            f"{warmup + 1 + iters} calls); capturing again")
    raise AssertionError(f"profiler saw {len(hits)} launches of {names} in "
                         f"{iters} calls in {DEVICE_MS_CAPTURES} captures")


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """Least time for the work: bytes over HBM rate vs operations over
    ``ops_per_s`` (float32 by default), the larger; returns
    ``(ms, "bytes"|"operations")``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max().item())


def assert_matches(got, want, what):
    """``got`` (a kernel's output) against ``want`` (its plain version's):
    float32 within ``F32_TOL``, bfloat16 within one rounding of itself
    (``BF16_RTOL`` and ``BF16_ATOL_SCALE``)."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        rms = float(w.square().mean().sqrt().item())
        tol = dict(atol=BF16_ATOL_SCALE * rms, rtol=BF16_RTOL)
    else:
        tol = dict(atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{what}: {m}")


def _one_rounding(got, want):
    """``(tolerance, err / tolerance)`` of a bfloat16 output against its
    plain version: one rounding (``BF16_RTOL``, ``BF16_ATOL_SCALE``)."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt().item())
    tol = BF16_ATOL_SCALE * rms + BF16_RTOL * w.abs()
    return tol, (g - w).abs() / tol


def _within_slack(got, want, tol, ratio, slack_fn, what):
    """Fail if an element lies beyond one rounding plus its slack (the
    slack is computed only where some element is beyond one rounding);
    returns a note: elements beyond one rounding, the largest err / tol
    and, where some are beyond, the largest err / (tol + slack)."""
    n_over = int((ratio > 1).sum().item())
    note = f"{n_over} beyond one rounding, err/tol {float(ratio.max()):.3f}"
    if n_over:
        flip = (got.float() - want.float()).abs() / (tol + slack_fn())
        worst = float(flip.max().item())
        if worst > 1:
            raise AssertionError(
                f"{what}: {int((flip > 1).sum().item())} elements beyond one "
                f"rounding plus their rounding-flip slack (largest err / "
                f"(tolerance + slack) {worst:.3f})")
        note += f", err/(tol + slack) {worst:.3f}"
    return note


def assert_forward_matches(out, want, q, k, v, mask, causal, scale, what):
    """A bfloat16 single-pass forward's ``out`` [B, H, S, Dv] against two
    plain versions on the same [B, H, S, D] inputs (views of another
    layout will do): ``want``, whose scores are a float32 product (the
    one the CPU tests tie to the reference), within one rounding plus
    each element's rounding-flip slack
    (``smalls_attention.forward_rounding_slack``: the kernel sums its
    scores in another order, so ``T(e)`` may round a key's weight the
    other way where ``e`` lies near a bf16 rounding boundary, and nowhere
    else); and the plain version with tensor-core-summed scores within
    one rounding.  Returns a note for the log: the elements beyond one
    rounding of ``want``, the largest err / tolerance, and where some
    are beyond, the largest err / (tolerance + slack)."""
    from paddle_tpu_torch.kernels import smalls_attention as sm
    if not out.isfinite().all():
        raise AssertionError(f"{what}: non-finite output")
    tol, ratio = _one_rounding(out, want)
    note = _within_slack(
        out, want, tol, ratio,
        lambda: sm.forward_rounding_slack(q, k, v, mask, causal, scale),
        what)
    tc_want, _ = sm.smalls_attention_fwd_reference(q, k, v, mask, causal,
                                                   scale, tensor_core=True)
    assert_matches(out, tc_want, f"{what} (tensor-core scores)")
    return note


def assert_flash_forward_matches(out, want, q, k, v, mask, causal, scale,
                                 what):
    """The bfloat16 flash forward's ``out`` against two plain versions:
    ``want``, the row-max one (the one the CPU tests tie to the
    reference), within one rounding plus
    ``flash_forward_rounding_slack`` (the kernel takes ``e`` against the
    running max of its key tiles and rounds it there, so where that max
    grew after a key's tile the key's weight is rounded at another
    scale); and the plain version that tiles as the kernel does
    (``key_tile=KEY_TILE``) within one rounding plus the slack of the
    score sums' order alone (zero unless a key lies near a bf16
    rounding boundary).  Returns a note with both readings."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    if not (out.isfinite().all()):
        raise AssertionError(f"{what}: non-finite output")
    args = (q, k, v, mask, causal, scale)
    tol, ratio = _one_rounding(out, want)
    notes = ["row max: " + _within_slack(
        out, want, tol, ratio,
        lambda: fa.flash_forward_rounding_slack(*args), f"{what} (row max)")]
    tiled, _ = fa.flash_attention_fwd_reference(*args,
                                                key_tile=fa.KEY_TILE)
    tol, ratio = _one_rounding(out, tiled)
    notes.append("tiled: " + _within_slack(
        out, tiled, tol, ratio,
        lambda: fa.flash_forward_rounding_slack(*args, tiled=True),
        f"{what} (tiled)"))
    return "; ".join(notes)


def assert_backward_matches(grads, wants, args, what):
    """A bfloat16 attention backward's ``(dq, dk, dv)`` (the tensor-core
    bodies: the flash dQ and dK/dV kernels, the single-pass backward)
    against the plain versions' within one rounding plus
    ``flash_backward_rounding_slack(*args)`` (the bodies sum ``q . k``
    and ``dO . v`` in another order, so ``T(dS)`` and ``T(p)`` may round
    the other way where they lie near a bf16 rounding boundary, and
    nowhere else).  ``args`` are the backward's ``(q, k, v, mask, out,
    lse, dout, causal, scale)`` in ``[B, H, S, .]``, and ``grads`` and
    ``wants`` in the same layout: views of ``[B, S, H, .]`` tensors
    transposed to it will do.  Returns a note for the log: for each grad
    the elements beyond one rounding (those that needed the slack), the
    largest err / tolerance and, where some are beyond, the largest err
    / (tolerance + slack)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    slack = []

    def slack_of(i):
        if not slack:
            slack.extend(fa.flash_backward_rounding_slack(*args))
        return slack[i]
    notes = []
    for i, (name, got, want) in enumerate(zip(("dq", "dk", "dv"), grads,
                                              wants)):
        if not got.isfinite().all():
            raise AssertionError(f"{what} {name}: non-finite output")
        tol, ratio = _one_rounding(got, want)
        notes.append(f"{name} " + _within_slack(
            got, want, tol, ratio, lambda i=i: slack_of(i),
            f"{what} {name}"))
    return "; ".join(notes)


def paged_case(S, H, D, PL, P, NP, lens, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(S, H * D, generator=g) * 0.4).cuda()
    kc = (torch.randn(NP, PL, H * D, generator=g) * 0.4).cuda()
    vc = (torch.randn(NP, PL, H * D, generator=g) * 0.4).cuda()
    pt = torch.randperm(NP, generator=g)[:S * P].reshape(S, P)
    pt = pt.to(torch.int32).cuda()
    lens = torch.tensor(lens, dtype=torch.int32).reshape(S, 1).cuda()
    return q, kc, vc, pt, lens


def check_paged(S, H, D, PL, P, NP, lens, seed):
    """Kernel vs plain version on one case; returns (max_abs_err, args)."""
    import torch
    from paddle_tpu_torch.kernels.paged_decode import (
        paged_attention, paged_attention_reference)
    args = paged_case(S, H, D, PL, P, NP, lens, seed)
    scale = float(D) ** -0.5
    got = paged_attention(*args, H, scale)
    torch.cuda.synchronize()
    want = paged_attention_reference(*args, H, scale)
    live = args[4].reshape(-1) > 0
    if not torch.isfinite(got).all():
        raise AssertionError(f"paged_decode: non-finite output at S={S} "
                             f"H={H} D={D} P={P}")
    err = max_err(got[live], want[live]) if live.any() else 0.0
    torch.testing.assert_close(got[live], want[live], atol=F32_TOL,
                               rtol=F32_TOL)
    return err, args


def paged_bound(args, H):
    q, kc, vc, pt, lens = args
    S, HD = q.shape
    P = pt.shape[1]
    PL = kc.shape[1]
    rows = int(lens.clamp(max=P * PL).sum().item())
    nbytes = 4 * (q.numel() + 2 * rows * HD + pt.numel() + lens.numel()
                  + q.numel())
    nops = 4 * rows * HD            # q.k and p.v, multiply + add each
    return bound_ms(nbytes, nops)


def paged_library(args, H, scale):
    """One SDPA call over the slots' gathered pages (timing yardstick)."""
    import torch
    import torch.nn.functional as F
    q, kc, vc, pt, lens = args
    S, HD = q.shape
    D = HD // H
    P = pt.shape[1]
    NP, PL, _ = kc.shape
    T = P * PL
    kg = kc[pt.long()].reshape(S, T, H, D).permute(0, 2, 1, 3).contiguous()
    vg = vc[pt.long()].reshape(S, T, H, D).permute(0, 2, 1, 3).contiguous()
    qh = q.reshape(S, H, 1, D)
    mask = (torch.arange(T, device=q.device).reshape(1, T)
            < lens.reshape(S, 1)).reshape(S, 1, 1, T)
    return lambda: F.scaled_dot_product_attention(qh, kg, vg,
                                                  attn_mask=mask,
                                                  scale=scale)


#: the long-cache decode case: 8 slots of 4096 rows (256 pages of 16),
#: H 8, D 128: 268 MB of K/V, where the split over the cache matters
LONG_CACHE = dict(S=8, H=8, D=128, PL=16, P=256, NP=2048)


def phase_paged():
    import torch
    from paddle_tpu_torch.kernels.paged_decode import (
        ROWS_PER_PART, paged_attention, paged_attention_reference,
        paged_decode_partitions)
    S, H, D, PL, NP = NUM_SLOTS, 2, 16, PAGE_LEN, 128
    worst = 0.0
    for P in (1, 2, 4, 8, 16):
        full = P * PL
        lens = [min(n, full) for n in
                (0, 1, PL, 2 * PL, full, full - 1, PL + 1, full // 2)]
        err, args = check_paged(S, H, D, PL, P, NP, lens, SEED + P)
        worst = max(worst, err)
        log(f"paged_decode S={S} H={H} D={D} PL={PL} NP={NP} P={P} "
            f"lens={lens}: max_abs_err={err:.3e}")
    main_args = args                      # P = 16, the longest bucket
    # lens on and around the kernel's partition edges, over 64 pages (4
    # partitions of ROWS_PER_PART rows, merged)
    R, P = ROWS_PER_PART, 64
    lens = [min(n, P * PL) for n in
            (R - 1, R, R + 1, 2 * R, 2 * R + 1, 3 * R, 0, P * PL)]
    err, _ = check_paged(S, H, D, PL, P, S * P, lens, SEED + 17)
    worst = max(worst, err)
    log(f"paged_decode S={S} H={H} D={D} PL={PL} NP={S * P} P={P} "
        f"lens={lens} (partition edges, R={R}, partitions "
        f"{paged_decode_partitions(P, PL)[1]}): max_abs_err={err:.3e}")
    err, big = check_paged(32, 8, 128, 16, 16, 512,
                           [int(x) for x in torch.randint(
                               0, 257, (32,), generator=torch.Generator()
                               .manual_seed(SEED)).tolist()], SEED + 99)
    worst = max(worst, err)
    log(f"paged_decode S=32 H=8 D=128 PL=16 NP=512 P=16: "
        f"max_abs_err={err:.3e}")
    lc = LONG_CACHE
    err, long_args = check_paged(lc["S"], lc["H"], lc["D"], lc["PL"],
                                 lc["P"], lc["NP"],
                                 [lc["P"] * lc["PL"]] * lc["S"], SEED + 256)
    worst = max(worst, err)
    log(f"paged_decode long cache {lc}: max_abs_err={err:.3e}")

    rows = {}
    for label, a, h, d in (("serving", main_args, H, D),
                           ("S32_H8_D128", big, 8, 128),
                           ("long_cache", long_args, lc["H"], lc["D"])):
        scale = float(d) ** -0.5
        call = (lambda a=a, h=h, scale=scale:
                paged_attention(*a, h, scale))
        ms = time_ms(call)
        dev = device_ms_sum(call, ("paged_decode_kernel",
                                   "paged_merge_kernel"))
        it = dict(iters=20, warmup=3) if label == "long_cache" else {}
        plain = time_ms(lambda: paged_attention_reference(*a, h, scale),
                        **it)
        lib = time_ms(paged_library(a, h, scale))
        b, by = paged_bound(a, h)
        R, parts = paged_decode_partitions(a[3].shape[1], a[1].shape[1])
        log(f"paged_decode[{label}] kernel_ms={ms:.5f} device_ms={dev:.5f}"
            f" plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={b:.6f} "
            f"({by}) rows_per_part={R} partitions={parts}")
        rows[label] = dict(ms=ms, device_ms=dev, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by)
    return worst, rows


def prefill_bias(T, p):
    """The predictor's combined causal + padding plane for a prompt of
    ``p`` tokens in bucket ``T``, as [1, T, T]."""
    import torch
    tri = torch.triu(torch.full((T, T), -1e9), 1)
    mask = (torch.arange(T) < p).float()
    return (tri + (mask * 1e9 - 1e9)[None, :]).reshape(1, T, T)


# the training slice's kernel shapes (bench.py's Transformer-base)
TRAIN_HEADS, TRAIN_D = 8, 64
ROUTE_A_B, ROUTE_A_S = 64, 256
ROUTE_B_B, ROUTE_B_S = 8, 2048
ROUTE_C_B, ROUTE_C_S = 32, 512


def phase_softmax():
    """The bias-softmax forward against its plain version: the serving
    prefill's causal planes ``[1, 2, T, T]`` in float32, the dense decode
    step's ``[8, 2, 1, 256]`` scores with a row bias, and route A's
    scores ``[64, 8, 256, 256]`` with a ``[64, 256]`` row bias (encoder
    self and cross attention) and with the decoder's ``[1, 256, 256]``
    causal plane, each in bfloat16 (what AMP hands it) and float32; then
    a ragged bf16 row (Sk 250: the warp body's element loads) and route
    B's ``[8, 8, 2048, 2048]`` bf16 scores with a causal plane (above the
    warp body's 1024: the block body).  Each log line names the body
    that ran (``bias_softmax_body_of``)."""
    import torch
    from paddle_tpu_torch.kernels.bias_softmax import (
        bias_softmax, bias_softmax_body_of, bias_softmax_reference)
    g = torch.Generator().manual_seed(SEED)
    cases = {}
    for T in (8, 16, 32, 64, 128, 256):
        x = torch.randn(1, 2, T, T, generator=g).cuda()
        cases[f"serving [1,2,{T},{T}] causal float32"] = (
            x, None, prefill_bias(T, max(1, T - 3)).cuda())
    # the dense decode step: one query row a slot against the whole cache,
    # masked by a [S, 1, 1, L] row bias (GenLongConfig: 8 slots, L = 256)
    x = torch.randn(NUM_SLOTS, 2, 1, 256, generator=g).cuda()
    live = torch.arange(256)[None, :] < torch.tensor(
        [[0], [1], [16], [17], [100], [255], [256], [31]])
    cases["dense decode [8,2,1,256] row float32"] = (
        x, torch.where(live, 0.0, -1e9).cuda(), None)
    S = ROUTE_A_S
    shape = [ROUTE_A_B, TRAIN_HEADS, S, S]
    x = torch.randn(shape, generator=g).cuda()
    pad = torch.rand(ROUTE_A_B, S, generator=g) < 0.2
    pad[0] = True                           # a row with every key masked
    row = torch.where(pad, -1e9, 0.0).cuda()
    tri = torch.triu(torch.full((S, S), -1e9), 1).reshape(1, S, S).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        cases[f"route A {shape} row {tag}"] = (x.to(dtype), row, None)
        cases[f"route A {shape} causal {tag}"] = (x.to(dtype), None, tri)
    # a ragged row (no 16-byte pieces: the warp body's element loads) and
    # one above the warp body's 1024 (the block body), in bf16
    ragged = [ROUTE_A_B, TRAIN_HEADS, 250, 250]
    cases[f"ragged {ragged} row bfloat16"] = (
        torch.randn(ragged, generator=g).to(torch.bfloat16).cuda(),
        row[:, :250].contiguous(), None)
    SB = ROUTE_B_S
    long_rows = [ROUTE_B_B, TRAIN_HEADS, SB, SB]
    cases[f"block {long_rows} causal bfloat16"] = (
        torch.randn(long_rows, generator=g).to(torch.bfloat16).cuda(), None,
        torch.triu(torch.full((SB, SB), -1e9), 1).reshape(1, SB, SB).cuda())
    worst = 0.0
    for label, (x, rb, tb) in cases.items():
        got = bias_softmax(x, rb, tb)
        torch.cuda.synchronize()
        want = bias_softmax_reference(x, rb, tb)
        err = max_err(got, want)
        assert_matches(got, want, f"bias_softmax {label}")
        worst = max(worst, err)
        log(f"bias_softmax {label}: max_abs_err={err:.3e} "
            f"body={bias_softmax_body_of(x, rb, tb)}")
        del got, want

    rows = {}
    for label, key in (
            ("serving", "serving [1,2,256,256] causal float32"),
            ("route A row", f"route A {shape} row bfloat16"),
            ("route A causal", f"route A {shape} causal bfloat16"),
            ("ragged", f"ragged {ragged} row bfloat16"),
            ("block", f"block {long_rows} causal bfloat16")):
        x, rb, tb = cases[key]
        bias = tb if tb is not None else rb
        bias4 = tb[:, None] if tb is not None else rb[:, None, None, :]
        bias4 = bias4.to(x.dtype)
        big = x.numel() > 1 << 20
        it = dict(iters=50, warmup=5) if big else {}
        ms = time_ms(lambda: bias_softmax(x, rb, tb), **it)
        plain = time_ms(lambda: bias_softmax_reference(x, rb, tb), **it)
        lib = time_ms(lambda: torch.softmax(x + bias4, dim=-1), **it)
        b, by = bound_ms(2 * _dtype_bytes(x) + _dtype_bytes(bias),
                         6 * x.numel())
        body = bias_softmax_body_of(x, rb, tb)
        log(f"bias_softmax[{label}, {key}] kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"(softmax(x + bias) in x's dtype) bound_ms={b:.6f} ({by}) "
            f"body={body}")
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by, body=body[0])
    return worst, rows


def _dtype_bytes(t):
    return t.element_size() * t.numel()


def phase_softmax_grad():
    """The bias-softmax backward at route A's scores [64, 8, 256, 256]:
    y and dy bf16 (what AMP hands it), bf16 y with a float32 dy, and
    float32."""
    import torch
    from paddle_tpu_torch.kernels.bias_softmax import (
        bias_softmax_grad, bias_softmax_grad_reference)
    g = torch.Generator().manual_seed(SEED + 1)
    shape = (ROUTE_A_B, TRAIN_HEADS, ROUTE_A_S, ROUTE_A_S)
    y = torch.softmax(torch.randn(shape, generator=g), -1).cuda()
    dy = torch.randn(shape, generator=g).cuda()
    worst = 0.0
    cases = [("bf16 y, bf16 dy", y.bfloat16(), dy.bfloat16()),
             ("bf16 y, f32 dy", y.bfloat16(), dy),
             ("f32 y, f32 dy", y, dy)]
    for label, yy, dd in cases:
        got = bias_softmax_grad(yy, dd)
        torch.cuda.synchronize()
        want = bias_softmax_grad_reference(yy, dd)
        err = max_err(got, want)
        assert_matches(got, want, f"bias_softmax_grad {label}")
        worst = max(worst, err)
        log(f"bias_softmax_grad {list(shape)} {label}: max_abs_err={err:.3e}")
    _, yy, dd = cases[0]                          # what route A runs
    ms = time_ms(lambda: bias_softmax_grad(yy, dd), iters=50, warmup=5)
    plain = time_ms(lambda: bias_softmax_grad_reference(yy, dd), iters=20,
                    warmup=3)
    lib = time_ms(lambda: torch.ops.aten._softmax_backward_data(
        dd, yy, -1, yy.dtype), iters=50, warmup=5)
    b, by = bound_ms(3 * _dtype_bytes(yy), 3 * yy.numel())
    log(f"bias_softmax_grad[route A, bf16] kernel_ms={ms:.5f} "
        f"plain_ms={plain:.5f} library_ms={lib:.5f} "
        f"(aten._softmax_backward_data) bound_ms={b:.6f} ({by})")
    return worst, dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                       bound_by=by)


def _pairs(Sq, Sk, causal):
    """(query, key) pairs the masks leave to compute."""
    if not causal:
        return Sq * Sk
    return sum(min(r + 1, Sk) for r in range(Sq))


def phase_flash():
    """The three flash kernels against their plain versions: small ragged
    and cross-attention shapes (head widths 16 to 128, both builds of the
    bf16 tensor-core bodies, rows not on 16 bytes, causal windows fully
    masked), then route B's attention [8, 8, 2048, 2048, 64], causal
    (decoder self) and key-masked (encoder self, cross; a batch row with
    every key off), each in f32 and bf16; then route B's bf16 times (the
    forward's by CUDA events and by device time, the backward kernels' by
    device time, as the wrapper launches both).
    The bound counts the products the masks leave (causal: the lower
    triangle) at the bf16 tensor-core peak, and each input read and
    output written once."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_dkdv_reference, flash_attention_dq_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    g = torch.Generator().manual_seed(SEED + 2)

    def case(B, H, Sq, Sk, D, Dv, dtype, masked, first_key_off=False,
             offset=0):
        def card(*shape, std=0.5):
            # contiguous, starting `offset` elements into its storage
            x = (torch.randn(shape, generator=g) * std).to(dtype).cuda()
            buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
            buf[offset:] = x.reshape(-1)
            return buf[offset:].view(shape)
        q, k = card(B, H, Sq, D), card(B, H, Sk, D)
        v, do = card(B, H, Sk, Dv), card(B, H, Sq, Dv, std=1.0)
        mask = None
        if masked or first_key_off:
            mask = torch.ones(B, Sk)
            if masked:
                mask = (torch.rand(B, Sk, generator=g) > 0.2).float()
                mask[0] = 0.0             # a row with every key masked
            if first_key_off:             # causal windows fully masked
                mask[:, 0] = 0.0
            mask = mask.cuda()
        return q, k, v, mask, do

    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    # (shape, causal, case options): both builds of the bf16 bodies (head
    # widths to 64 and to 128), rows of 20, 36 and (offset 1) 40 bf16 not
    # on 16 bytes, causal windows fully masked (first key off)
    small = [((2, 2, 100, 100, 64, 64), True, {}),
             ((1, 2, 96, 48, 16, 16), False, {}),
             ((1, 1, 37, 130, 128, 96), False, {}),
             ((2, 4, 513, 257, 128, 128), True, {}),
             ((2, 3, 70, 200, 40, 24), False, {}),
             ((1, 2, 90, 75, 20, 36), True, {}),
             ((2, 2, 200, 200, 64, 64), True, dict(first_key_off=True)),
             ((2, 2, 130, 77, 40, 40), True, dict(first_key_off=True,
                                                  offset=1)),
             ((2, 3, 150, 260, 128, 96), False, dict(offset=1))]
    big = (ROUTE_B_B, TRAIN_HEADS, ROUTE_B_S, ROUTE_B_S, TRAIN_D, TRAIN_D)
    for shape, causal, opts in small + [(big, True, {}), (big, False, {})]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = case(*shape, dtype, masked=not causal,
                                     **opts)
            scale = shape[4] ** -0.5
            out, lse = flash_attention_fwd(q, k, v, mask, causal, scale)
            dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, do,
                                             causal, scale)
            torch.cuda.synchronize()
            ro, rl = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                   scale)
            rq, rk, rv = flash_attention_bwd_reference(q, k, v, mask, out,
                                                       lse, do, causal,
                                                       scale)
            errs = {"flash_fwd": max(max_err(out, ro), max_err(lse, rl)),
                    "flash_dq": max_err(dq, rq),
                    "flash_dkdv": max(max_err(dk, rk), max_err(dv, rv))}
            what = (f"flash {list(shape)} {str(dtype)[6:]} "
                    f"{'causal' if causal else 'key-masked'}"
                    + "".join(f", {n}={x}" for n, x in opts.items()))
            flips = ""
            if dtype == torch.bfloat16:
                flips = " out: " + assert_flash_forward_matches(
                    out, ro, q, k, v, mask, causal, scale, f"{what} out")
                flips += "; grads: " + assert_backward_matches(
                    (dq, dk, dv), (rq, rk, rv), (q, k, v, mask, out, lse, do,
                                                 causal, scale), what)
            else:
                for n, a, b in (("out", out, ro), ("dq", dq, rq),
                                ("dk", dk, rk), ("dv", dv, rv)):
                    assert_matches(a, b, f"{what} {n}")
            torch.testing.assert_close(lse, rl, atol=F32_TOL, rtol=1e-6)
            for n, e in errs.items():
                worst[n] = max(worst[n], e)
            log(f"{what}: " + " ".join(f"{n}={e:.3e}"
                                      for n, e in errs.items()) + flips)
            del q, k, v, do, out, lse, dq, dk, dv, ro, rl, rq, rk, rv
            torch.cuda.empty_cache()

    rows = {}
    B, H, S, _, D, _ = big
    for label, causal in (("causal", True), ("key-masked", False)):
        q, k, v, mask, do = case(B, H, S, S, D, D, torch.bfloat16,
                                 masked=not causal)
        if mask is not None:
            mask.fill_(1.0)           # the encoder's all-ones fake_batch mask
        scale = D ** -0.5
        out, lse = flash_attention_fwd(q, k, v, mask, causal, scale)
        pairs = B * H * _pairs(S, S, causal)
        el = 2                                    # bf16 bytes
        mask_bytes = 0 if mask is None else 4 * B * S
        io_fwd = el * 4 * B * H * S * D + 4 * B * H * S * 2 + mask_bytes
        io_bwd = el * 4 * B * H * S * D + 4 * B * H * S * 3 + mask_bytes
        ops = {"flash_fwd": pairs * 2 * (D + D),
               "flash_dq": pairs * (4 * D + 2 * D),
               "flash_dkdv": pairs * (4 * D + 4 * D)}
        nbytes = {"flash_fwd": io_fwd, "flash_dq": io_bwd + el * B * H * S * D,
                  "flash_dkdv": io_bwd + 2 * el * B * H * S * D}
        t_fwd = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal,
                                                    scale), iters=10,
                        warmup=2)
        # the forward alone on the device: the wrapper's host time is no
        # longer small beside it
        dev_fwd = device_ms(lambda: flash_attention_fwd(
            q, k, v, mask, causal, scale),
            ("flash_fwd_kernel",))["flash_fwd_kernel"]
        bwd_args = (q, k, v, mask, out, lse, do, causal, scale)
        t_bwd = time_ms(lambda: flash_attention_bwd(*bwd_args), iters=10,
                        warmup=2)
        # the wrapper launches both backward kernels: each one's device time
        dev = device_ms(lambda: flash_attention_bwd(*bwd_args),
                        ("flash_dq_kernel", "flash_dkdv_kernel"))
        t_dq, t_dkdv = dev["flash_dq_kernel"], dev["flash_dkdv_kernel"]
        p_fwd = time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, mask, causal, scale), iters=3, warmup=1)
        p_dq = time_ms(lambda: flash_attention_dq_reference(*bwd_args),
                       iters=3, warmup=1)
        p_dkdv = time_ms(lambda: flash_attention_dkdv_reference(*bwd_args),
                         iters=3, warmup=1)
        attn_mask = None if mask is None else \
            (mask > 0.5)[:, None, None, :].expand(B, 1, S, S)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, scale=scale),
            iters=10, warmup=2)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask,
                                            is_causal=causal, scale=scale)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), iters=10, warmup=2)
        for n, ms, pl, lib in (("flash_fwd", t_fwd, p_fwd, lib_fwd),
                               ("flash_dq", t_dq, p_dq, None),
                               ("flash_dkdv", t_dkdv, p_dkdv, None)):
            b, by = bound_ms(nbytes[n], ops[n], BF16_TC_OPS_PER_S)
            rows[(n, label)] = dict(ms=ms, plain_ms=pl, library_ms=lib,
                                    bound_ms=b, bound_by=by)
            if n == "flash_fwd":
                rows[(n, label)]["device_ms"] = dev_fwd
            log(f"{n}[route B {label}, bf16 {[B, H, S, S, D]}] "
                f"kernel_ms={ms:.5f} plain_ms={pl:.5f} library_ms="
                f"{'none' if lib is None else f'{lib:.5f}'} "
                f"bound_ms={b:.6f} ({by})")
        log(f"flash forward[route B {label}] wrapper {t_fwd:.5f} ms by CUDA "
            f"events, the kernel {dev_fwd:.5f} ms device time "
            f"(torch.profiler); card {card_line()}")
        log(f"flash backward[route B {label}] wrapper (delta + dq + dkdv) "
            f"{t_bwd:.5f} ms by CUDA events, of which dq {t_dq:.5f} and dkdv "
            f"{t_dkdv:.5f} ms device time (torch.profiler); one PyTorch call "
            f"computing dq, dk and dv (SDPA's backward) {lib_bwd:.5f} ms")
        del q, k, v, do, out, lse, ql, kl, vl, ol
        torch.cuda.empty_cache()
    return worst, rows


def phase_smalls():
    """The single-pass pair against its plain versions: route C's
    attention [32, 8, 512, 64], key-masked (encoder self, cross; a batch
    row with every key off) and causal (decoder self), and causal with
    the first key off (rows whose causal window is fully masked), each in
    f32 and bf16 (the bf16 pair on the tensor cores: the forward held by
    ``assert_forward_matches``, dq, dk, dv by ``assert_backward_matches``;
    f32 by ``assert_matches``); S = 1024, a ragged S = 200 and head
    widths 16, 96 and 128 at S = 512.  Then route C's bf16 times beside
    the plain versions', SDPA's forward and SDPA's backward (one call for
    dq, dk and dv, as the backward kernel is), and the bound: the
    products the masks leave at the bf16 tensor-core peak, each input
    read and output written once."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import smalls_attention as sm
    from paddle_tpu_torch.kernels.build import load_library
    g = torch.Generator().manual_seed(SEED + 4)

    # the rule's shared-memory sums (the float32 body's and the bfloat16
    # tensor-core body's) are the kernel source's
    smem = load_library(sm.SMALLS_FWD.source).smalls_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 5
    smem.restype = ctypes.c_long
    for R, S, D, Dv in ((4, 512, 64, 64), (2, 1024, 64, 64),
                        (1, 2000, 128, 96), (4, 200, 16, 128),
                        (2, 512, 8, 20), (1, 3000, 64, 64)):
        for bf16 in (0, 1):
            src = smem(bf16, R, S, D, Dv)
            rule = sm._fwd_smem_bytes(R, S, D, Dv, bf16=bool(bf16))
            if src != rule:
                raise AssertionError(
                    f"smalls: shared memory of R={R} S={S} D={D} Dv={Dv} "
                    f"({'bf16' if bf16 else 'f32'} body): source {src}, "
                    f"rule {rule}")

    def case(B, H, S, D, dtype, masked, first_key_off=False):
        q, k, v = ((torch.randn(B, H, S, D, generator=g) * 0.5).to(dtype)
                   .cuda() for _ in range(3))
        do = torch.randn(B, H, S, D, generator=g).to(dtype).cuda()
        mask = None
        if masked or first_key_off:
            mask = torch.ones(B, S)
            if masked:
                mask = (torch.rand(B, S, generator=g) > 0.2).float()
                mask[0] = 0.0             # a row with every key masked
            if first_key_off:
                mask[:, 0] = 0.0
            mask = mask.cuda()
        return q, k, v, mask, do

    worst = {"smalls_fwd": 0.0, "smalls_bwd": 0.0}
    route_c = (ROUTE_C_B, TRAIN_HEADS, ROUTE_C_S, TRAIN_D)
    cases = [(route_c, False, False), (route_c, True, False),
             (route_c, True, True), ((4, 8, 1024, 64), True, False),
             ((4, 8, 1024, 64), False, False), ((2, 4, 200, 64), True, True),
             ((2, 4, 200, 64), False, False), ((2, 4, 512, 16), True, True),
             ((2, 4, 512, 96), False, False), ((2, 4, 512, 128), True, False)]
    for shape, causal, first_off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = case(*shape, dtype, masked=not causal,
                                     first_key_off=first_off)
            scale = shape[3] ** -0.5
            out, lse = sm.smalls_attention_fwd(q, k, v, mask, causal, scale)
            grads = sm.smalls_attention_bwd(q, k, v, mask, out, lse, do,
                                            causal, scale)
            torch.cuda.synchronize()
            ro, rl = sm.smalls_attention_fwd_reference(q, k, v, mask, causal,
                                                       scale)
            rgrads = sm.smalls_attention_bwd_reference(
                q, k, v, mask, out, lse, do, causal, scale)
            what = (f"smalls {list(shape)} {str(dtype)[6:]} "
                    f"{'causal' if causal else 'key-masked'}"
                    f"{', first key off' if first_off else ''}")
            flips = ""
            if dtype == torch.bfloat16:
                flips = " out: " + assert_forward_matches(
                    out, ro, q, k, v, mask, causal, scale, f"{what} out")
            else:
                assert_matches(out, ro, f"{what} out")
            if dtype == torch.bfloat16:
                flips += "; grads: " + assert_backward_matches(
                    grads, rgrads, (q, k, v, mask, out, lse, do, causal,
                                    scale), what)
            else:
                for n, a, b in (("dq", grads[0], rgrads[0]),
                                ("dk", grads[1], rgrads[1]),
                                ("dv", grads[2], rgrads[2])):
                    assert_matches(a, b, f"{what} {n}")
            torch.testing.assert_close(lse, rl, atol=F32_TOL, rtol=1e-6)
            errs = {"smalls_fwd": max(max_err(out, ro), max_err(lse, rl)),
                    "smalls_bwd": max(max_err(a, b)
                                      for a, b in zip(grads, rgrads))}
            for n, e in errs.items():
                worst[n] = max(worst[n], e)
            log(f"{what}: " + " ".join(f"{n}={e:.3e}"
                                      for n, e in errs.items()) + flips)
            del q, k, v, do, out, lse, grads, ro, rl, rgrads
            torch.cuda.empty_cache()

    rows = {}
    B, H, S, D = route_c
    for label, causal in (("causal", True), ("key-masked", False)):
        q, k, v, mask, do = case(B, H, S, D, torch.bfloat16,
                                 masked=not causal)
        if mask is not None:
            mask.fill_(1.0)           # the encoder's all-ones fake_batch mask
        scale = D ** -0.5
        out, lse = sm.smalls_attention_fwd(q, k, v, mask, causal, scale)
        bwd_args = (q, k, v, mask, out, lse, do, causal, scale)
        pairs = B * H * _pairs(S, S, causal)
        el = 2                                    # bf16 bytes
        mask_bytes = 0 if mask is None else 4 * B * S
        nbytes = {"smalls_fwd": el * 4 * B * H * S * D + 4 * B * H * S * 2
                  + mask_bytes,
                  "smalls_bwd": el * 7 * B * H * S * D + 4 * B * H * S * 3
                  + mask_bytes}
        ops = {"smalls_fwd": pairs * 4 * D, "smalls_bwd": pairs * 10 * D}
        it = dict(iters=20, warmup=3)
        t_fwd = time_ms(lambda: sm.smalls_attention_fwd(
            q, k, v, mask, causal, scale), **it)
        t_bwd = time_ms(lambda: sm.smalls_attention_bwd(*bwd_args), **it)
        dev = device_ms(lambda: sm.smalls_attention_bwd(*bwd_args),
                        ("smalls_bwd_kernel",))["smalls_bwd_kernel"]
        p_fwd = time_ms(lambda: sm.smalls_attention_fwd_reference(
            q, k, v, mask, causal, scale), iters=5, warmup=1)
        p_bwd = time_ms(lambda: sm.smalls_attention_bwd_reference(*bwd_args),
                        iters=5, warmup=1)
        attn_mask = None if mask is None else \
            (mask > 0.5)[:, None, None, :].expand(B, 1, S, S)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, scale=scale),
            **it)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask,
                                            is_causal=causal, scale=scale)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), **it)
        for n, ms, pl, lib in (("smalls_fwd", t_fwd, p_fwd, lib_fwd),
                               ("smalls_bwd", t_bwd, p_bwd, lib_bwd)):
            b, by = bound_ms(nbytes[n], ops[n], BF16_TC_OPS_PER_S)
            rows[(n, label)] = dict(ms=ms, plain_ms=pl, library_ms=lib,
                                    bound_ms=b, bound_by=by)
            log(f"{n}[route C {label}, bf16 {[B, H, S, S, D]}] "
                f"kernel_ms={ms:.5f} plain_ms={pl:.5f} library_ms={lib:.5f} "
                f"(SDPA {'forward' if n == 'smalls_fwd' else 'backward'}) "
                f"bound_ms={b:.6f} ({by})")
        log(f"smalls backward[route C {label}] wrapper (delta + kernel) "
            f"{t_bwd:.5f} ms by CUDA events, of which the kernel "
            f"{dev:.5f} ms device time (torch.profiler)")
        del q, k, v, do, out, lse, ql, kl, vl, ol
        torch.cuda.empty_cache()
    return worst, rows


def phase_sass():
    """Tensor-core instructions of the redesigned kernels: ``cuobjdump
    -sass`` of the built ``smalls_attention.cu``, ``bshd_attention.cu``,
    ``flash_attention.cu`` and ``conv3x3.cu`` libraries, the ``HMMA`` /
    ``HGMMA`` count of each instantiation of ``smalls_fwd_kernel``,
    ``bshd_fwd_kernel`` (template arguments R and W),
    ``smalls_bwd_kernel``, ``bshd_bwd_kernel``, ``flash_fwd_kernel``,
    ``flash_dq_kernel`` and ``flash_dkdv_kernel`` (W for the bfloat16
    bodies) and ``conv3x3_kernel`` (the block tile BM x BN of the
    bfloat16 body).  Fails if a bfloat16 instantiation has none (its
    products are not on the tensor cores), or a float32 one has any (the
    float32 bodies stay on the CUDA cores).  Returns ``{wrapper name:
    {instantiation: count}}``."""
    import re
    from paddle_tpu_torch.kernels import build
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    found, sass = {}, {}
    for name, source, params in (
            ("smalls_fwd", "smalls_attention.cu", ("R", "W")),
            ("bshd_fwd", "bshd_attention.cu", ("R", "W")),
            ("smalls_bwd", "smalls_attention.cu", ("W",)),
            ("bshd_bwd", "bshd_attention.cu", ("W",)),
            ("flash_fwd", "flash_attention.cu", ("W",)),
            ("flash_dq", "flash_attention.cu", ("W",)),
            ("flash_dkdv", "flash_attention.cu", ("W",)),
            ("conv3x3", "conv3x3.cu", ("BM", "BN"))):
        kernel = f"{name}_kernel"
        if source not in sass:
            sass[source] = subprocess.run(
                [cuobjdump, "-sass", build.library_path(source)],
                capture_output=True, text=True, timeout=300,
                check=True).stdout
        counts = {}
        for part in sass[source].split("Function : ")[1:]:
            symbol = part.split("\n", 1)[0].strip()
            if kernel not in symbol:
                continue
            dtype = "bf16" if "__nv_bfloat16" in symbol else "f32"
            args = re.findall(r"Li(\d+)E", symbol)
            label = " ".join([dtype] + [f"{n}={a}"
                                        for n, a in zip(params, args)])
            counts[label] = len(re.findall(r"\bH(?:G)?MMA\b", part))
        if not any(k.startswith("bf16") for k in counts):
            raise AssertionError(f"{kernel}: no bf16 instantiation in the "
                                 f"SASS of {source}")
        for label, n in counts.items():
            if label.startswith("bf16") and n == 0:
                raise AssertionError(f"{kernel} {label}: no HMMA/HGMMA "
                                     f"instruction in its SASS")
            if label.startswith("f32") and n != 0:
                raise AssertionError(f"{kernel} {label}: {n} HMMA/HGMMA "
                                     f"instructions in the float32 body "
                                     f"(the CUDA cores')")
        found[name] = counts
        log(f"sass {kernel}: HMMA/HGMMA instructions by instantiation "
            f"{counts}")
    return found


def phase_bshd():
    """The [B, S, H, D] pair against its plain versions: the flagship
    attention of ``exp_torch_bshd_attn.py`` [256, 256, 8, 64] in bf16,
    key-masked (a bf16 mask, as the original passes it, with a batch row
    whose every key is off) and causal with the first key off (rows whose
    causal window is fully masked), held on the head-transposed views as
    the [B, H, S, D] pair is (``assert_forward_matches``,
    ``assert_backward_matches``); a ragged [4, 200, 8, 64] in float32 (a
    float32 mask), the same two, to ``F32_TOL``.  Then the flagship's
    bf16 times as the path runs it (causal, all-ones mask) beside the
    plain versions', SDPA's forward and backward on the transposed views
    (one call each for the same function), and the bound: the products
    the causal mask leaves at the bf16 tensor-core peak, each input read
    and output written once."""
    import torch
    import torch.nn.functional as F
    import exp_torch_bshd_attn as exp
    from paddle_tpu_torch.kernels import bshd_attention as ba
    g = torch.Generator().manual_seed(SEED + 8)
    H, D = exp.H, exp.D

    def case(B, S, dtype, masked, first_key_off):
        q, k, v, do = (torch.randn(B, S, H, D, generator=g).to(dtype).cuda()
                       for _ in range(4))
        mask = torch.ones(B, S)
        if masked:
            mask = (torch.rand(B, S, generator=g) > 0.2).float()
            mask[0] = 0.0                 # a row with every key masked
        if first_key_off:
            mask[:, 0] = 0.0
        return q, k, v, mask.to(dtype).cuda(), do

    worst = {"bshd_fwd": 0.0, "bshd_bwd": 0.0}
    flagship, ragged = (exp.B, exp.S), (4, 200)
    cases = [(flagship, torch.bfloat16, False),
             (flagship, torch.bfloat16, True),
             (ragged, torch.float32, False), (ragged, torch.float32, True)]
    for (B, S), dtype, causal in cases:
        q, k, v, mask, do = case(B, S, dtype, masked=not causal,
                                 first_key_off=causal)
        scale = D ** -0.5
        out, res = ba.bshd_attention_fwd(q, k, v, mask, causal, scale)
        grads = ba.bshd_attention_bwd(q, k, v, mask, out, res, do, causal,
                                      scale)
        torch.cuda.synchronize()
        ro, rr = ba.bshd_attention_fwd_reference(q, k, v, mask, causal,
                                                 scale)
        rgrads = ba.bshd_attention_bwd_reference(q, k, v, mask, out, res, do,
                                                 causal, scale)
        what = (f"bshd {[B, S, H, D]} {str(dtype)[6:]} "
                f"{'causal, first key off' if causal else 'key-masked'}")
        flips = ""
        if dtype == torch.bfloat16:
            heads = [x.transpose(1, 2) for x in (out, ro, q, k, v)]
            flips = " out: " + assert_forward_matches(
                *heads, mask, causal, scale, f"{what} out")
        else:
            assert_matches(out, ro, f"{what} out")
        if dtype == torch.bfloat16:
            hq, hk, hv, hout, hres, hdo = (
                x.transpose(1, 2) for x in (q, k, v, out, res, do))
            flips += "; grads: " + assert_backward_matches(
                [x.transpose(1, 2) for x in grads],
                [x.transpose(1, 2) for x in rgrads],
                (hq, hk, hv, mask, hout, hres, hdo, causal, scale), what)
        else:
            for n, a, b in (("dq", grads[0], rgrads[0]),
                            ("dk", grads[1], rgrads[1]),
                            ("dv", grads[2], rgrads[2])):
                assert_matches(a, b, f"{what} {n}")
        torch.testing.assert_close(res, rr, atol=F32_TOL, rtol=1e-6)
        errs = {"bshd_fwd": max(max_err(out, ro), max_err(res, rr)),
                "bshd_bwd": max(max_err(a, b)
                                for a, b in zip(grads, rgrads))}
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        log(f"{what}: " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
            + flips)
        del q, k, v, do, mask, out, res, grads, ro, rr, rgrads
        torch.cuda.empty_cache()

    B, S = flagship
    q, k, v, do, mask = exp.make_inputs(g)
    scale = D ** -0.5
    out, res = ba.bshd_attention_fwd(q, k, v, mask, True, scale)
    bwd_args = (q, k, v, mask, out, res, do, True, scale)
    pairs = B * H * _pairs(S, S, True)
    el = 2                                        # bf16 bytes
    mask_bytes = 4 * B * S                        # the kernels' float32 mask
    nbytes = {"bshd_fwd": el * 4 * B * S * H * D + 4 * B * S * H * 2
              + mask_bytes,
              "bshd_bwd": el * 7 * B * S * H * D + 4 * B * S * H * 3
              + mask_bytes}
    ops = {"bshd_fwd": pairs * 4 * D, "bshd_bwd": pairs * 10 * D}
    it = dict(iters=20, warmup=3)
    t_fwd = time_ms(lambda: ba.bshd_attention_fwd(q, k, v, mask, True,
                                                  scale), **it)
    t_bwd = time_ms(lambda: ba.bshd_attention_bwd(*bwd_args), **it)
    dev = device_ms(lambda: ba.bshd_attention_bwd(*bwd_args),
                    ("bshd_bwd_kernel",))["bshd_bwd_kernel"]
    p_fwd = time_ms(lambda: ba.bshd_attention_fwd_reference(
        q, k, v, mask, True, scale), iters=5, warmup=1)
    p_bwd = time_ms(lambda: ba.bshd_attention_bwd_reference(*bwd_args),
                    iters=5, warmup=1)
    heads = [x.transpose(1, 2) for x in (q, k, v)]    # views, no copy
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, is_causal=True, scale=scale), **it)
    leaves = [x.detach().requires_grad_() for x in heads]
    ol = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        ol, leaves, do.transpose(1, 2), retain_graph=True), **it)
    rows = {}
    for n, ms, pl, lib in (("bshd_fwd", t_fwd, p_fwd, lib_fwd),
                           ("bshd_bwd", t_bwd, p_bwd, lib_bwd)):
        b, by = bound_ms(nbytes[n], ops[n], BF16_TC_OPS_PER_S)
        rows[n] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=b,
                       bound_by=by)
        log(f"{n}[causal, all-ones mask, bf16 {[B, S, H, D]}] "
            f"kernel_ms={ms:.5f} plain_ms={pl:.5f} library_ms={lib:.5f} "
            f"(SDPA {'forward' if n == 'bshd_fwd' else 'backward'}) "
            f"bound_ms={b:.6f} ({by})")
    log(f"bshd backward wrapper (delta + kernel) {t_bwd:.5f} ms "
        f"by CUDA events, of which the kernel {dev:.5f} ms device time "
        f"(torch.profiler)")
    del q, k, v, do, mask, out, res, heads, leaves, ol
    torch.cuda.empty_cache()
    return worst, rows


#: forward + backward steps of the bshd route on its path
BSHD_PATH_STEPS = 5


def phase_bshd_path():
    """The path that runs the [B, S, H, D] pair: ``exp_torch_bshd_attn``'s
    ``check_numerics`` on the card (the pair under autograd against
    float32 attention and its plain versions, causal and not), then
    ``BSHD_PATH_STEPS`` forward + backward steps of its ``bshd`` route at
    the flagship shape, the counts set to 0 just before and read just
    after: exactly ``len(CASES) + BSHD_PATH_STEPS`` launches of each
    kernel of the pair and none of any other.  Then, outside that window
    (the comparison routes launch the single-pass and bias-softmax
    kernels), the experiment's four routes: grads against SDPA's and
    forward + backward times."""
    import torch
    import exp_torch_bshd_attn as exp
    from paddle_tpu_torch.kernels import ALL_KERNELS
    q, k, v, do, mask = exp.make_inputs(torch.Generator().manual_seed(
        SEED + 9))
    table = exp.routes(q, k, v, do, mask)

    for kern in ALL_KERNELS:
        kern.launches = 0
    numerics = exp.check_numerics()
    for _ in range(BSHD_PATH_STEPS):
        grads = table["bshd"]()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    n = len(exp.CASES) + BSHD_PATH_STEPS
    if launches != {"bshd_fwd": n, "bshd_bwd": n}:
        raise AssertionError(f"bshd path: launches {launches}, want {n} "
                             f"bshd_fwd and {n} bshd_bwd")
    for x in grads:
        if tuple(x.shape) != tuple(q.shape) or not torch.isfinite(x).all():
            raise AssertionError(f"bshd path: grad {tuple(x.shape)} not "
                                 f"finite [B, S, H, D]")
    route_errs = exp.compare_routes(table)
    times = exp.time_routes(table)
    log(f"bshd path: check_numerics {numerics}; {BSHD_PATH_STEPS} steps of "
        f"the bshd route at {list(q.shape)}; launches {launches}")
    log("bshd routes (forward + backward, causal, bf16 "
        f"{list(q.shape)}): " + " ".join(
            f"{r}={times[f'{r}_ms']:.4f}ms (grads {route_errs[r]:.3e} from "
            f"SDPA's)" for r in table))
    del table, grads, q, k, v, do, mask
    torch.cuda.empty_cache()
    return launches, dict(numerics=numerics, route_errs=route_errs, **times)


# ---------------------------------------------------------------------------
# phase 4: training through the port's entry points
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5
#: per route: (batch, sequence length, kernels that must launch 18 a step)
ROUTES = {"A": (ROUTE_A_B, ROUTE_A_S, ("bias_softmax", "bias_softmax_grad")),
          "B": (ROUTE_B_B, ROUTE_B_S, ("flash_fwd", "flash_dq",
                                       "flash_dkdv")),
          "C": (ROUTE_C_B, ROUTE_C_S, ("smalls_fwd", "smalls_bwd"))}


def _steady(step_s, graphed):
    """Steady seconds a step: the median of a graph's replays (the steps
    after its eager first and its captured second), else of the eager
    steps after the first."""
    import numpy as np
    return float(np.median(step_s[2:] if graphed else step_s[1:]))


def _transformer_program(pt, T, hp, B, S, amp):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _ = T.transformer(B, S, S, hp)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = amp
    return main, startup, cost


def phase_train(route):
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S, kernels = ROUTES[route]
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    types = [op.type for op in main.global_block().ops]
    log(f"train[{route}]: B={B} S={S} ops={len(types)} "
        f"sdpa={types.count('scaled_dot_product_attention')} "
        f"softmax={types.count('softmax')} params="
        f"{len(main.global_block().all_parameters())} "
        f"adam={types.count('adam')}")
    scope = pt.Scope()
    exe = pt.Executor()                # default place: cuda:0
    if exe.device.type != "cuda":
        raise AssertionError(f"Executor landed on {exe.device}")
    exe.run(startup, scope=scope)
    feed = T.fake_batch(B, S, S, hp, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in ALL_KERNELS:
        kern.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)   # the fetch synchronizes
        losses.append(float(np.asarray(loss).reshape(())))
    launches = {kern.name: kern.launches for kern in ALL_KERNELS}

    want = {kern.name: (18 * TRAIN_STEPS if kern.name in kernels else 0)
            for kern in ALL_KERNELS}
    if launches != want:
        raise AssertionError(f"train[{route}]: launches {launches} != "
                             f"{want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train[{route}]: losses {losses} not finite "
                             f"and falling")
    steady = _steady(step_s, True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = B * S
    # the first step eager, the second captured and replayed, the rest
    # replays
    if _graphs(f"train_{route}", exe, True) != TRAIN_STEPS - 1:
        raise AssertionError(f"train[{route}]: graph replays "
                             f"{exe.graph_stats()}")
    log(f"train[{route}]: losses {[round(x, 5) for x in losses]}; step s "
        f"{[round(x, 4) for x in step_s]}; steady (the replays' median) "
        f"{1e3 * steady:.2f} ms a "
        f"step = {tokens / steady:.1f} tokens/s ({tokens} target tokens a "
        f"step); peak memory {peak:.2f} GiB; launches {launches}")
    del scope, exe
    torch.cuda.empty_cache()
    return launches, dict(step_ms=1e3 * steady, tokens_per_s=tokens / steady,
                          losses=losses, peak_gib=peak)


#: card against CPU, one float32 step at full width and depth 1 + 1: the
#: loss agrees to ``CARD_CPU_LOSS_RTOL`` (cuBLAS and the CPU sum float32
#: products in different orders; TF32 is off), and every parameter's
#: grad, read as its first Adam moment (``(1 - beta1) * grad`` after one
#: step), agrees leaf by leaf as ``|card - cpu| / |cpu|`` (2-norms).
#: Summation order alone leaves leaves a few 1e-6 apart, so they are held
#: to ``CARD_CPU_GRAD_RTOL``.  A ReLU input within rounding of 0 passes
#: its grad on one side only and moves every leaf below it: the phase
#: counts such inputs, and where there is one (route A's batch has one in
#: the decoder's FFN, its leaves then lie up to about 3e-4 apart on an
#: H100) holds leaves to ``CARD_CPU_KINK_GRAD_RTOL``.  An attention grad
#: 1% off in one attention moves leaves by more than 5e-3 (see
#: ``test_leaf_grad_check_sees_one_wrong_attention`` in
#: ``tests/test_torch_train.py``).  The parameters themselves are not
#: held: an early Adam step moves each by about lr whatever its grad's
#: size, so they are reported only.
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_GRAD_RTOL = 2e-5
CARD_CPU_KINK_GRAD_RTOL = 1e-3
CARD_CPU = {"A": (2, ROUTE_A_S), "B": (1, ROUTE_B_S), "C": (1, ROUTE_C_S)}


def phase_card_vs_cpu(route):
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S = CARD_CPU[route]
    hp = T.ModelHyperParams()
    hp.n_layer, hp.dropout = 1, 0.0
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=False)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    names = persistable_names(main)
    state = {n: to_numpy(cpu_scope.find_var(n)) for n in names}
    card_scope = scope_from_numpy(state, None, main)
    feed = T.fake_batch(B, S, S, hp, seed=SEED + 3)
    feed["src_mask"][-1, S // 2:] = 0.0         # a padded source row
    relu_in = [op.input("X")[0] for op in main.global_block().ops
               if op.type == "relu"]
    t = time.perf_counter()
    cpu_loss, *cpu_relu = cpu.run(main, feed=feed,
                                  fetch_list=[cost] + relu_in,
                                  scope=cpu_scope)
    cpu_s = time.perf_counter() - t
    for kern in ALL_KERNELS:
        kern.launches = 0
    card_loss, *card_relu = pt.Executor().run(
        main, feed=feed, fetch_list=[cost] + relu_in, scope=card_scope)
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    if sorted(launches) != sorted(ROUTES[route][2]) or \
            any(n != 3 for n in launches.values()):
        raise AssertionError(f"card-vs-cpu[{route}]: launches {launches}")
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[{route}]: loss {a} vs {b}")
    moment1 = {op.input("Param")[0]: op.input("Moment1")[0]
               for op in main.global_block().ops if op.type == "adam"}
    trainable = {p.name for p in main.global_block().all_parameters()
                 if p.trainable}
    if set(moment1) != trainable:
        raise AssertionError(f"card-vs-cpu[{route}]: {len(moment1)} Adam "
                             f"ops for {len(trainable)} parameters")
    rel, param_max = {}, 0.0
    for p, m in moment1.items():
        want = to_numpy(cpu_scope.find_var(m)).astype(np.float64)
        got = to_numpy(card_scope.find_var(m)).astype(np.float64)
        norm = float(np.linalg.norm(want))
        if not norm > 0:
            raise AssertionError(f"card-vs-cpu[{route}]: {p} got no grad")
        rel[p] = float(np.linalg.norm(got - want)) / norm
        param_max = max(param_max, float(np.abs(
            to_numpy(card_scope.find_var(p)).astype(np.float64)
            - to_numpy(cpu_scope.find_var(p))).max()))
    worst = max(rel, key=rel.get)
    kinks = sum(int(((x > 0) != (y > 0)).sum())
                for x, y in zip(cpu_relu, card_relu))
    log(f"card-vs-cpu[{route}]: {kinks} of "
        f"{sum(x.size for x in cpu_relu)} ReLU inputs lie on different "
        f"sides of 0 on the card and the CPU")
    log(f"card-vs-cpu[{route}] B={B} S={S} 1+1 layers f32: loss card {a!r} "
        f"cpu {b!r} (rel {abs(a - b) / abs(b):.2e}); grads (first moments) "
        f"|card - cpu| / |cpu| worst {rel[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} "
        f"parameters; parameters max abs diff {param_max:.3e}; launches "
        f"{launches}; cpu step {cpu_s:.2f}s")
    bound = CARD_CPU_KINK_GRAD_RTOL if kinks else CARD_CPU_GRAD_RTOL
    if rel[worst] > bound:
        raise AssertionError(f"card-vs-cpu[{route}]: grad of {worst} "
                             f"differs by {rel[worst]} relative (bound "
                             f"{bound}, {kinks} ReLU inputs straddle 0)")
    torch.cuda.empty_cache()
    return dict(loss_rel=abs(a - b) / abs(b), grad_rel=rel[worst],
                param_max=param_max, relu_kinks=kinks)


#: each further optimizer on the card against the CPU: float32
#: elementwise updates of a two-layer fc program, three steps from one
#: state; the products of the forward and backward sum in different
#: orders on the two devices
OPTIMIZER_TOL = 1e-5
OPTIMIZER_STEPS = 3


def phase_optimizers():
    """Every optimizer beside SGD and Adam (and ``noam_decay`` driving
    ``Momentum`` through a ``Variable`` learning rate, and
    ``ModelAverage`` beside SGD) takes ``OPTIMIZER_STEPS`` steps of a
    small fc program on the card and on the CPU from one state; every
    persistable variable (parameters, accumulators, the step counter)
    must agree to ``OPTIMIZER_TOL``."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    O, L = pt.optimizer, pt.layers
    makers = {
        "Momentum": lambda: O.Momentum(0.01, momentum=0.9),
        "Momentum(nesterov)": lambda: O.Momentum(0.01, momentum=0.9,
                                                 use_nesterov=True),
        "Adagrad": lambda: O.Adagrad(0.01),
        "Adamax": lambda: O.Adamax(0.01),
        "DecayedAdagrad": lambda: O.DecayedAdagrad(0.01),
        "Adadelta": lambda: O.Adadelta(0.01),
        "RMSProp": lambda: O.RMSProp(0.01, momentum=0.5),
        "Ftrl": lambda: O.Ftrl(0.01, l1=0.01, l2=0.01),
        "Momentum(noam_decay)": lambda: O.Momentum(L.noam_decay(64, 4),
                                                   momentum=0.9),
        "SGD + ModelAverage": lambda: O.SGD(0.01),
    }
    rng = np.random.RandomState(SEED % (2 ** 31))
    feed = {"x": rng.randn(64, 32).astype("float32")}
    worst = {}
    for name, make in makers.items():
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = SEED
        with pt.program_guard(main, startup):
            x = L.data(name="x", shape=[64, 32], dtype="float32",
                       append_batch_size=False)
            out = L.fc(L.fc(x, 64, act="relu"), 1)
            loss = L.mean(out * out)
            make().minimize(loss)
            if "ModelAverage" in name:
                O.ModelAverage(max_average_window=2)
        cpu_scope = pt.Scope()
        cpu = pt.Executor(pt.CPUPlace())
        cpu.run(startup, scope=cpu_scope)
        names = persistable_names(main)
        card_scope = scope_from_numpy(
            {n: to_numpy(cpu_scope.find_var(n)) for n in names}, None, main)
        card = pt.Executor()
        if card.device.type != "cuda":
            raise AssertionError(f"Executor landed on {card.device}")
        losses = []
        for _ in range(OPTIMIZER_STEPS):
            (a,) = cpu.run(main, feed=feed, fetch_list=[loss],
                           scope=cpu_scope)
            (b,) = card.run(main, feed=feed, fetch_list=[loss],
                            scope=card_scope)
            losses.append((float(a.reshape(())), float(b.reshape(()))))
        err = 0.0
        for n in names:
            want = to_numpy(cpu_scope.find_var(n)).astype(np.float64)
            got = to_numpy(card_scope.find_var(n)).astype(np.float64)
            if card_scope.find_var(n).device.type != "cuda":
                raise AssertionError(f"optimizers[{name}]: {n} left the card")
            np.testing.assert_allclose(
                got, want, rtol=OPTIMIZER_TOL, atol=OPTIMIZER_TOL,
                err_msg=f"optimizers[{name}]: {n}")
            err = max(err, float(np.abs(got - want).max()))
        if not all(np.isfinite(l).all() for l in losses) or \
                losses[-1][1] == losses[0][1]:
            raise AssertionError(f"optimizers[{name}]: losses {losses}")
        worst[name] = err
        log(f"optimizers[{name}]: {len(names)} persistable variables, max "
            f"abs diff card vs cpu {err:.3e} after {OPTIMIZER_STEPS} steps; "
            f"card losses {[round(l[1], 6) for l in losses]}")
    return worst


#: ``phase_reader_train``: steps a ``run_steps`` window, and the five
#: feeds of ``T.fake_batch`` in the order of ``transformer(input_vars=)``
READER_STEPS = 16
READER_KEYS = ("src_word", "trg_word", "src_mask", "lbl_word", "lbl_weight")
READER_DTYPES = ["int32", "int32", "float32", "int32", "float32"]


def _take_launches():
    """The launch counts, set back to 0."""
    from paddle_tpu_torch.kernels import ALL_KERNELS
    launches = _launch_counts()
    for kern in ALL_KERNELS:
        kern.launches = 0
    return launches


def _reader_program(pt, T, hp, B, S, path=None):
    """Route A's program, named alike every time it is built: with
    ``path``, fed by bench.py's recordio pipeline (``open_recordio_file``
    -> ``double_buffer`` -> ``read_file``), else by ``layers.data``."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.framework.unique_name_scope("rt_"), \
            pt.program_guard(main, startup):
        inputs = None
        if path is not None:
            reader = pt.layers.open_recordio_file(
                filename=path, shapes=[(B, S)] * 5, lod_levels=[0] * 5,
                dtypes=READER_DTYPES, pass_num=10 ** 6)
            reader = pt.layers.double_buffer(reader,
                                             capacity=READER_STEPS + 2)
            inputs = pt.layers.read_file(reader)
        cost, _ = T.transformer(B, S, S, hp, input_vars=inputs)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = True
    return main, startup, cost


def _reader_windows(pt, exe, main, cost, scope, feed):
    """Two ``run_steps(READER_STEPS)`` windows: the losses (float32, both
    windows) and the second window's seconds (replays only)."""
    import numpy as np
    import torch
    losses, seconds = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        (out,) = exe.run_steps(main, feed=feed, fetch_list=[cost],
                               steps=READER_STEPS, scope=scope)
        seconds.append(time.perf_counter() - t)   # the fetch synchronizes
        losses.append(np.asarray(out, np.float32).reshape(-1))
    return np.concatenate(losses), seconds[1]


def phase_reader_train():
    """Route A (Transformer-base, S 256, B 64, bf16 AMP, Adam, dropout
    0.1) fed as bench.py's ``PADDLE_TPU_BENCH_INPUT=recordio`` feeds it:
    ``READER_STEPS`` distinct ``T.fake_batch`` batches written raw
    (``compressor=0``) by ``convert_reader_to_recordio_file``, read by
    ``open_recordio_file(pass_num=10**6)`` -> ``double_buffer(capacity
    READER_STEPS + 2)`` -> ``read_file``, two ``run_steps(READER_STEPS)``
    windows on the default (graphed) path.  Held to: the native codec;
    the same program as the memory-fed one but the reader ops; losses
    bit-identical to a memory-fed ``run_steps`` of the same batches
    stacked (bench.py's default mode) from the same startup state and a
    fresh executor each; 18 + 18 bias-softmax launches a step both ways;
    one ``jit_cache`` miss for both reader-fed windows, one graph.
    Prints ms a step both ways (the second window, replays only)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import native, profiler
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.reader_ops import READER_OPS
    from paddle_tpu_torch.recordio_writer import \
        convert_reader_to_recordio_file

    B, S, kernels = ROUTES["A"]
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    batches = [T.fake_batch(B, S, S, hp, seed=SEED % 2 ** 31 + s)
               for s in range(READER_STEPS)]
    path = os.path.join(OUT_DIR, "reader_train.recordio")
    t = time.perf_counter()
    n = convert_reader_to_recordio_file(
        path, lambda: (tuple(b[k] for k in READER_KEYS) for b in batches),
        compressor=0)
    write_s = time.perf_counter() - t
    codec = native.codec()
    if codec != "native" or n != READER_STEPS:
        raise AssertionError(f"reader_train: codec {codec!r}, {n} records")
    reader_main, _, reader_cost = _reader_program(pt, T, hp, B, S, path)
    main, startup, cost = _reader_program(pt, T, hp, B, S)
    fed = [op.type for op in reader_main.global_block().ops
           if op.type not in READER_OPS]
    if fed != [op.type for op in main.global_block().ops]:
        raise AssertionError("reader_train: the reader-fed program is not "
                             "the memory-fed one but its reader ops")
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    stacked = {k: np.stack([b[k] for b in batches]) for k in READER_KEYS}
    want = {k: 18 * 2 * READER_STEPS for k in kernels}
    runs = {}
    for mode, program, c, feed in (("reader", reader_main, reader_cost,
                                    None),
                                   ("memory", main, cost, stacked)):
        _no_launches(f"reader_train[{mode}]")
        scope = _scope_copy(pt, scope0)
        exe = pt.Executor()
        misses = profiler.runtime_metrics.counter("jit_cache.misses")
        losses, window_s = _reader_windows(pt, exe, program, c, scope,
                                           feed)
        misses = profiler.runtime_metrics.counter("jit_cache.misses") - \
            misses
        launches = _take_launches()
        if launches != want:
            raise AssertionError(f"reader_train[{mode}]: launches "
                                 f"{launches} != {want}")
        replays = _graphs(f"reader_train_{mode}", exe, True)
        if misses != 1 or replays != 2 * READER_STEPS - 1:
            raise AssertionError(f"reader_train[{mode}]: {misses} cache "
                                 f"misses, graphs {exe.graph_stats()}")
        runs[mode] = dict(losses=losses, launches=launches,
                          step_ms=1e3 * window_s / READER_STEPS)
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    got, ref = runs["reader"]["losses"], runs["memory"]["losses"]
    if not np.array_equal(got, ref):
        raise AssertionError(f"reader_train: reader-fed losses {got} "
                             f"against memory-fed {ref}")
    if not np.all(np.isfinite(got)) or not got[-1] < got[0]:
        raise AssertionError(f"reader_train: losses {got}")
    os.remove(path)
    out = dict(reader_step_ms=runs["reader"]["step_ms"],
               memory_step_ms=runs["memory"]["step_ms"],
               record_write_s=write_s, codec=codec, bit_identical=True,
               losses=[float(x) for x in got], card=card_line())
    log(f"reader_train[A]: reader-fed {out['reader_step_ms']:.3f} ms a step "
        f"against memory-fed {out['memory_step_ms']:.3f} (second window of "
        f"{READER_STEPS}, replays); losses bit-identical over "
        f"{2 * READER_STEPS} steps; one cache miss a run; codec {codec}; "
        f"{READER_STEPS} records written in {write_s:.3f} s; card "
        f"{out['card']}")
    del scope0
    return runs["reader"]["launches"], runs["memory"]["launches"], out


#: ``phase_checkpoint_resume``: the trainer is stopped after ``CKPT_K``
#: of ``2 * CKPT_K`` steps (4 until the run passed 700 s)
CKPT_K = 3
CKPT_CHILD_TIMEOUT_S = 300


def _ckpt_program(pt, T):
    """Route A at dropout 0, named alike in every process."""
    B, S, _ = ROUTES["A"]
    hp = T.ModelHyperParams()
    hp.max_length = max(hp.max_length, S)
    hp.dropout = 0.0
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.framework.unique_name_scope("ck_"), \
            pt.program_guard(main, startup):
        cost, _ = T.transformer(B, S, S, hp)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = True
    return main, startup, cost, hp


def _ckpt_feed(T, hp, step):
    B, S, _ = ROUTES["A"]
    return T.fake_batch(B, S, S, hp, seed=SEED % 2 ** 31 + 100 + step)


def _tensor_state(scope):
    """``name -> host array`` of every tensor of ``scope``."""
    import torch
    from paddle_tpu_torch.convert import to_numpy
    return {n: to_numpy(v) for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def ckpt_trainer(argv):
    """Child mode of ``phase_checkpoint_resume`` (``chip_smoke.py
    --ckpt-trainer first|second DIR OUT``).  ``first``: route A at
    dropout 0 from its startup, a ``CheckpointManager.save`` after step
    ``CKPT_K - 1``, then, after step ``CKPT_K``, a ready file and a wait
    for SIGTERM under ``GracefulShutdown``; the loop stops and commits a
    final checkpoint.  ``second``: ``restore_latest()`` into a fresh
    scope and executor, the remaining steps, a checkpoint of the end
    state.  Each writes a JSON report to OUT."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fault import CheckpointManager, GracefulShutdown
    from paddle_tpu_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    role, dirname, out = argv
    main, startup, cost, hp = _ckpt_program(pt, T)
    exe, scope = pt.Executor(), pt.Scope()
    mgr = CheckpointManager(dirname, keep=3, executor=exe,
                            main_program=main, scope=scope)
    report = {"role": role}

    def step(s):
        exe.run(main, feed=_ckpt_feed(T, hp, s), fetch_list=[cost],
                scope=scope)

    if role == "first":
        exe.run(startup, scope=scope)
        done = 0
        with GracefulShutdown() as stop:
            for s in range(1, 2 * CKPT_K + 1):
                if stop.should_stop():
                    break
                step(s)
                done = s
                if s == CKPT_K - 1:
                    t = time.perf_counter()
                    mgr.save(s)
                    report["save_s"] = time.perf_counter() - t
                if s == CKPT_K:
                    torch.cuda.synchronize()
                    with open(out + ".ready", "w") as f:
                        f.write(str(s))
                    stop.wait(CKPT_CHILD_TIMEOUT_S)
            t = time.perf_counter()
            mgr.save(done)
            report["final_save_s"] = time.perf_counter() - t
        report.update(done=done, signal=stop.received)
    else:
        t = time.perf_counter()
        report["restored"] = mgr.restore_latest()
        report["restore_s"] = time.perf_counter() - t
        for s in range(report["restored"] + 1, 2 * CKPT_K + 1):
            step(s)
        mgr.save(2 * CKPT_K)
        report["done"] = 2 * CKPT_K
    report["launches"] = _launch_counts()
    report["graph_replays"] = sum(g["replays"] for g in exe.graph_stats())
    with open(out, "w") as f:
        json.dump(report, f)
    return 0


def _ckpt_child(role, dirname, out, sigterm_when_ready=False):
    """Run ``ckpt_trainer`` in a child process; returns its report.  The
    child is killed if it outlives ``CKPT_CHILD_TIMEOUT_S``."""
    import signal
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--ckpt-trainer", role, dirname, out],
                            cwd=ROOT)
    try:
        deadline = time.monotonic() + CKPT_CHILD_TIMEOUT_S
        if sigterm_when_ready:
            while not os.path.exists(out + ".ready"):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"checkpoint_resume[{role}]: the trainer exited "
                        f"({proc.returncode}) or timed out before its "
                        f"ready file")
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"checkpoint_resume[{role}]: the trainer "
                             f"exited {rc}")
    with open(out) as f:
        return json.load(f)


def phase_checkpoint_resume():
    """Route A at dropout 0 stopped and resumed across processes: trainer
    1 runs ``CKPT_K`` steps (a ``CheckpointManager.save`` after step
    ``CKPT_K - 1``), receives SIGTERM under ``GracefulShutdown``, commits
    a final checkpoint and exits 0; trainer 2 restores it with
    ``restore_latest()`` into a fresh scope and executor and runs the
    remaining ``CKPT_K`` steps.  Its parameters and Adam moments (every
    persistable) must equal, bit for bit, a run in this process that
    never stopped.  Then ``save_async`` of that state, one more step
    (which writes the state in place), and the written checkpoint must
    equal the state as snapshotted.  A blocking save clones nothing on
    the card: its device peak above the state must stay under a quarter
    of the state (the async snapshot's clone is printed beside it).
    Prints the state's GiB and the save, verify and restore seconds.
    Dropout is 0: both packages key
    their dropout masks on the executor's run counter, which no
    checkpoint holds."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fault import CheckpointManager, shard_ckpt
    from paddle_tpu_torch.fault.checkpoint import verify_checkpoint
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.obs import trace

    _, _, kernels = ROUTES["A"]
    root = os.path.join(OUT_DIR, "checkpoint_resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ckdir = os.path.join(root, "ckpt")
    _no_launches("checkpoint_resume")
    first = _ckpt_child("first", ckdir, os.path.join(root, "first.json"),
                        sigterm_when_ready=True)
    second = _ckpt_child("second", ckdir, os.path.join(root, "second.json"))
    if (first["done"], first["signal"], second["restored"]) != \
            (CKPT_K, 15, CKPT_K):
        raise AssertionError(f"checkpoint_resume: trainers {first} "
                             f"{second}")
    for r in (first, second):
        if r["launches"] != {k: 18 * CKPT_K for k in kernels}:
            raise AssertionError(f"checkpoint_resume[{r['role']}]: "
                                 f"launches {r['launches']}")
    resumed = pt.Scope()
    pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()), ckdir,
                          step=2 * CKPT_K, scope=resumed)
    resumed = _tensor_state(resumed)

    main, startup, cost, hp = _ckpt_program(pt, T)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    for s in range(1, 2 * CKPT_K + 1):
        exe.run(main, feed=_ckpt_feed(T, hp, s), fetch_list=[cost],
                scope=scope)
    want = _tensor_state(scope)
    if sorted(resumed) != sorted(want):
        raise AssertionError(f"checkpoint_resume: resumed state holds "
                             f"{len(resumed)} of {len(want)} variables")
    differ = [n for n in want if not np.array_equal(resumed[n], want[n])]
    moments = [n for n in want if "moment" in n]
    if differ or not moments:
        raise AssertionError(f"checkpoint_resume: {len(differ)} variables "
                             f"differ after the resume: {differ[:5]}")
    gib = sum(a.nbytes for a in want.values()) / 2 ** 30

    mgr = CheckpointManager(os.path.join(root, "here"), keep=2,
                            executor=exe, main_program=main, scope=scope)
    torch.cuda.synchronize()
    # where a blocking save's time goes: the host copy of the live state
    # timed alone, then a save under the ckpt.* spans; it clones nothing
    # on the card (its device peak above the state is held under a
    # quarter of the state; save_async's snapshot is the clone)
    t = time.perf_counter()
    shard_ckpt.host_state(pt.io._persistable_state(main, scope))
    parts = {"host_copy": time.perf_counter() - t}
    trace.clear()
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    path = mgr.save(2 * CKPT_K)
    save_s = time.perf_counter() - t
    save_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    trace.disable()
    if save_peak_gib > gib / 4:
        raise AssertionError(f"checkpoint_resume: a blocking save took "
                             f"{save_peak_gib:.4f} GiB on the card above "
                             f"a {gib:.4f} GiB state")
    for sp in trace.snapshot_spans():
        if sp["name"] in ("ckpt.write", "ckpt.manifest", "ckpt.rename",
                          "ckpt.gc"):
            parts[sp["name"][5:]] = sp["dur"]
    parts["shard_writes_summed"] = sum(
        sp["dur"] for sp in trace.snapshot_spans()
        if sp["name"] == "ckpt.shard.write")
    trace.clear()
    t = time.perf_counter()
    verify_checkpoint(path)
    verify_s = time.perf_counter() - t
    fresh = pt.Scope()
    t = time.perf_counter()
    pt.io.load_checkpoint(exe, mgr.dirname, scope=fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del fresh
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    mgr.save_async(2 * CKPT_K + 1)
    snapshot_s = time.perf_counter() - t
    async_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    exe.run(main, feed=_ckpt_feed(T, hp, 2 * CKPT_K + 1), fetch_list=[cost],
            scope=scope)
    mgr.wait_pending()
    async_s = time.perf_counter() - t
    written = shard_ckpt.read_state(
        mgr.path(2 * CKPT_K + 1), shard_ckpt.read_manifest(
            mgr.path(2 * CKPT_K + 1))["topology"])
    after = _tensor_state(scope)
    stale = [n for n in want if not np.array_equal(written[n][0], want[n])]
    moved = [n for n in want if not np.array_equal(after[n], want[n])]
    if stale or not moved:
        raise AssertionError(f"checkpoint_resume: the async checkpoint "
                             f"differs from its snapshot in {stale[:5]} "
                             f"({len(moved)} variables moved by the step)")
    launches = _take_launches()
    if launches != {k: 18 * (2 * CKPT_K + 1) for k in kernels}:
        raise AssertionError(f"checkpoint_resume: launches {launches}")
    for r in (first, second):
        for k, n in r["launches"].items():
            launches[k] += n
    shutil.rmtree(root, ignore_errors=True)
    out = dict(state_gib=gib, variables=len(want), save_s=save_s,
               verify_s=verify_s, restore_s=restore_s,
               save_peak_gib=save_peak_gib, async_peak_gib=async_peak_gib,
               async_snapshot_s=snapshot_s, async_total_s=async_s,
               child_save_s=first["save_s"],
               child_final_save_s=first["final_save_s"],
               child_restore_s=second["restore_s"], save_parts_s=parts,
               bit_identical=True, card=card_line())
    log(f"checkpoint_resume[A, dropout 0]: state {gib:.4f} GiB in "
        f"{len(want)} variables; SIGTERM after step {CKPT_K}, resumed in a "
        f"second process from ckpt-{CKPT_K}: all variables bit-identical "
        f"after {2 * CKPT_K} steps to the run that never stopped; save "
        f"{save_s:.3f} s, verify {verify_s:.3f} s, restore "
        f"{restore_s:.3f} s (the trainers': save {first['save_s']:.3f}, "
        f"final {first['final_save_s']:.3f}, restore_latest "
        f"{second['restore_s']:.3f}); device peak above the state: "
        f"blocking save {save_peak_gib:.4f} GiB, save_async snapshot "
        f"{async_peak_gib:.4f} GiB; save_async snapshot "
        f"{snapshot_s:.3f} s, with a step and the commit {async_s:.3f} s, "
        f"written = snapshot; a save's parts (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; card {out['card']}")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 15: the device-facing services on route A: the training sentinel
# (skip, quarantine, rollback, replay), the checkpoint survey, the live
# MFU, the HBM census and device time on torch.profiler
# ---------------------------------------------------------------------------

#: steps of the sentinel drill, the saves in it, and the failpoint: the
#: 5th and 6th checked steps poisoned (two strikes, then the rollback)
SENTINEL_STEPS, SENTINEL_SAVES = 10, (2, 4)
#: layers of the bundle the ``replay`` subprocesses re-execute on the CPU,
#: at the drill's widths: the full-width drill's own bundle took 98.6 s to
#: replay and 255.5 s to localize there on 8 cores, a 2-layer one 97.8 s
#: and 194.7 s beside the card phases (cut to 1 when the run passed 700 s)
SENTINEL_REPLAY_LAYERS = 1
#: CPU threads and niceness of each replay subprocess, which runs beside
#: the card phases after the kernel phases
REPLAY_THREADS, REPLAY_NICE = 2, 10
#: the replay subprocesses in flight, stopped when the script ends
REPLAYS = []
#: guarded against unguarded graphed steps, timed after the drill
SENTINEL_TIMED = 8


def _tensors(scope):
    import torch
    return {n: v for n, v in scope.items() if isinstance(v, torch.Tensor)}


def _snapshot(scope):
    """Device clones of every tensor of ``scope``."""
    return {n: v.clone() for n, v in _tensors(scope).items()}


def _bit_equal(scope, snap):
    """Names of the tensors of ``scope`` whose bytes differ from
    ``snap``'s (NaN-safe: compared as raw words)."""
    import torch
    bad = []
    cur = _tensors(scope)
    if set(cur) != set(snap):
        return sorted(set(cur) ^ set(snap))
    for n, v in snap.items():
        a, b = cur[n], v
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                a.contiguous().view(torch.uint8),
                b.contiguous().view(torch.uint8)):
            bad.append(n)
    return bad


def _sentinel_drill(pt, T, main, cost, hp, state, root, inject):
    """``SENTINEL_STEPS`` graphed route A steps from ``state`` (name ->
    device tensor) in a fresh scope and executor.  With ``inject``: a
    ``Sentinel(cadence=1, strikes=2)`` on a ``CheckpointManager``, saves
    after ``SENTINEL_SAVES``, ``sentinel.nan`` on the 5th and 6th checks,
    and the loop of the ``Sentinel`` docstring: a fault is handed to
    ``handle_fault``, a rollback resumes after the restored step.
    Returns ``(losses of the applied steps in order, step seconds, runs,
    rollbacks, exe, scope, mgr, sentinel)``."""
    import numpy as np
    from paddle_tpu_torch.fault import (CheckpointManager, NumericalFault,
                                        Sentinel, chaos)
    exe, scope = pt.Executor(), pt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    mgr = sentinel = None
    if inject:
        mgr = CheckpointManager(os.path.join(root, "ckpt"), keep=3,
                                executor=exe, main_program=main,
                                scope=scope)
        sentinel = Sentinel(manager=mgr, cadence=1, strikes=2,
                            mark_good_after=1, spike_factor=None)
        chaos.inject("sentinel.nan", after=4, times=2)
    losses, step_s, rollbacks, runs, step = {}, [], [], 0, 0
    try:
        while step < SENTINEL_STEPS:
            step += 1
            runs += 1
            t = time.perf_counter()
            try:
                (loss,) = exe.run(main, feed=_ckpt_feed(T, hp, step),
                                  fetch_list=[cost], scope=scope,
                                  sentinel=sentinel)
            except NumericalFault as fault:
                restored = sentinel.handle_fault(fault, step=step)
                if restored is not None:
                    rollbacks.append((restored, mgr.last_good_step()))
                    step = restored
                    losses = {k: v for k, v in losses.items() if k <= step}
                continue
            step_s.append(time.perf_counter() - t)
            losses[step] = float(np.asarray(loss).reshape(()))
            if inject and step in SENTINEL_SAVES:
                mgr.save(step)
                sentinel.note_checkpoint(step)
    finally:
        chaos.clear("sentinel.nan")
    return ([losses[k] for k in sorted(losses)], step_s, runs, rollbacks,
            exe, scope, mgr, sentinel)


def _replay_bundle_of(pt, T, layers, root):
    """A quarantine bundle of one injected guarded route A step at
    ``layers`` layers a stack (the drill's widths, batch and sequence)."""
    from paddle_tpu_torch.fault import NumericalFault, Sentinel, chaos
    B, S, _ = ROUTES["A"]
    hp = T.ModelHyperParams()
    hp.max_length = max(hp.max_length, S)
    hp.dropout, hp.n_layer = 0.0, layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.framework.unique_name_scope("ck_"), \
            pt.program_guard(main, startup):
        cost, _ = T.transformer(B, S, S, hp)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = True
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    sentinel = Sentinel(cadence=1, spike_factor=None,
                        quarantine_dir=os.path.join(root, "replay"))
    chaos.inject("sentinel.nan", times=1)
    try:
        exe.run(main, feed=_ckpt_feed(T, hp, 1), fetch_list=[cost],
                scope=scope, sentinel=sentinel)
    except NumericalFault as fault:
        path = sentinel.quarantine(fault, step=1)
    else:
        raise AssertionError("replay bundle: the injected step did not "
                             "trip")
    finally:
        chaos.clear("sentinel.nan")
    loss_op = [op.type for op in main.global_block().ops
               if cost.name in op.output_arg_names][0]
    return path, loss_op


def _reap(job):
    """Wait for ``job``'s process; note its end, CPU seconds and peak
    resident set (a thread per process, so the end is known when the
    script reads it later)."""
    try:
        _, status, usage = os.wait4(job["proc"].pid, 0)
    except ChildProcessError:   # reaped by a kill in stop_replays
        return
    job["end"] = time.perf_counter()
    job["proc"].returncode = os.waitstatus_to_exitcode(status)
    job["cpu_s"] = usage.ru_utime + usage.ru_stime
    job["maxrss_gib"] = usage.ru_maxrss / 2 ** 20


def start_replays():
    """A quarantine bundle of one injected guarded route A step at
    ``SENTINEL_REPLAY_LAYERS`` layers (its launches counted on no path),
    then ``python -m paddle_tpu_torch replay --json`` and ``replay
    --localize --json`` on it, started in two subprocesses on the CPU
    (``REPLAY_THREADS`` threads each, niced, the card hidden) that run
    beside the card phases; :func:`join_replays` reads them."""
    import shutil
    import threading
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as T

    root = os.path.join(OUT_DIR, "sentinel_replay")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bundle, loss_op = _replay_bundle_of(pt, T, SENTINEL_REPLAY_LAYERS,
                                        root)
    _take_launches()
    gc.collect()
    torch.cuda.empty_cache()
    threads = str(REPLAY_THREADS)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
    jobs = []
    for extra in ((), ("--localize",)):
        tag = "localize" if extra else "replay"
        out = open(os.path.join(root, f"{tag}.out"), "w+")
        err = open(os.path.join(root, f"{tag}.err"), "w+")
        job = {"tag": tag, "out": out, "err": err,
               "start": time.perf_counter(),
               "proc": subprocess.Popen(
                   ["nice", "-n", str(REPLAY_NICE), sys.executable, "-m",
                    "paddle_tpu_torch", "replay", *extra, "--json", bundle],
                   cwd=ROOT, env=env, stdout=out, stderr=err)}
        REPLAYS.append(job["proc"])
        job["reaper"] = threading.Thread(target=_reap, args=(job,),
                                         daemon=True)
        job["reaper"].start()
        jobs.append(job)
    return {"root": root, "loss_op": loss_op, "jobs": jobs}


def stop_replays():
    """Kill the replay subprocesses still running (a failed run)."""
    for proc in REPLAYS:
        if proc.returncode is None:
            try:
                proc.kill()
            except OSError:
                pass


def join_replays(started):
    """Wait for :func:`start_replays`'s subprocesses (up to
    ``HTTP_WAIT_S`` more each): ``replay`` exits 0 with the injected
    fault reproduced, ``replay --localize`` exits 0 naming the op that
    produces the loss.  Returns each one's wall seconds from its start,
    CPU seconds, peak resident set and the seconds this join waited."""
    import shutil

    t = time.perf_counter()
    reports = {}
    for job in started["jobs"]:
        job["reaper"].join(HTTP_WAIT_S)
        if job["reaper"].is_alive():
            stop_replays()
            raise AssertionError(f"{job['tag']}: still running after "
                                 f"{time.perf_counter() - job['start']:.0f}"
                                 f" s")
        job["out"].seek(0)
        job["err"].seek(0)
        text, err = job["out"].read(), job["err"].read()
        try:
            reports[job["tag"]] = json.loads(text)
        except ValueError:
            raise AssertionError(f"{job['tag']}: exit "
                                 f"{job['proc'].returncode}, {text[-2000:]!r}"
                                 f" {err[-2000:]!r}")
    wait_s = time.perf_counter() - t
    jobs = {job["tag"]: job for job in started["jobs"]}
    report, loc = reports["replay"], reports["localize"]
    rc_replay = jobs["replay"]["proc"].returncode
    if rc_replay != 0 or not report["reproduced"] or \
            report["reason"] != "non_finite":
        raise AssertionError(f"replay: exit {rc_replay}, {report}")
    rc_loc = jobs["localize"]["proc"].returncode
    first = loc.get("first_bad_op") or {}
    if rc_loc != 0 or first.get("type") != started["loss_op"]:
        raise AssertionError(f"replay --localize: exit {rc_loc}, first bad "
                             f"op {first.get('type')} (want "
                             f"{started['loss_op']})")
    out = {"replay_layers": SENTINEL_REPLAY_LAYERS,
           "threads": REPLAY_THREADS, "localized_op": started["loss_op"],
           "join_wait_s": wait_s}
    for tag, job in jobs.items():
        out[f"{tag}_s"] = job["end"] - job["start"]
        out[f"{tag}_cpu_s"] = job["cpu_s"]
        out[f"{tag}_maxrss_gib"] = job["maxrss_gib"]
        job["out"].close()
        job["err"].close()
    shutil.rmtree(started["root"], ignore_errors=True)
    return out


def phase_sentinel():
    """The training sentinel on route A at full width (dropout 0, bf16
    AMP, graphed): a clean run of ``SENTINEL_STEPS`` steps, then the
    same steps from the same state with a ``Sentinel`` guarding every
    step (``_sentinel_drill``): the applied losses equal the clean run's
    bit for bit, two steps skipped and quarantined, one rollback to
    ``last_good_step()``; every guarded run launches the bias-softmax
    pair 18 times.  A real fault: one parameter set to inf before a
    guarded replay: the trip names it and the scope after it equals the
    pre-step state bit for bit.  The guarded and unguarded graphed steps
    timed, the health gauges printed.  ``ckpt verify`` on the drill's
    directory (PASS, then 1 after a truncated file).  The CPU replays of
    a quarantined bundle run beside the card phases (:func:`start_replays`,
    :func:`join_replays`)."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fault import NumericalFault, Sentinel
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.profiler import runtime_metrics as m

    _, _, kernels = ROUTES["A"]
    root = os.path.join(OUT_DIR, "sentinel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    main, startup, cost, hp = _ckpt_program(pt, T)
    exe0, scope0 = pt.Executor(), pt.Scope()
    exe0.run(startup, scope=scope0)
    state = _snapshot(scope0)
    del exe0, scope0

    _take_launches()
    clean, clean_s, clean_runs, _, exe, scope, _, _ = _sentinel_drill(
        pt, T, main, cost, hp, state, root, inject=False)
    got = _take_launches()
    want = {k: 18 * clean_runs for k in kernels}
    if got != want:
        raise AssertionError(f"sentinel[clean]: launches {got} != {want}")
    unguarded_s = []
    for s in range(SENTINEL_TIMED):
        t = time.perf_counter()
        exe.run(main, feed=_ckpt_feed(T, hp, 1 + s), fetch_list=[cost],
                scope=scope)
        unguarded_s.append(time.perf_counter() - t)
    writeback = [c.fn.writeback_in_graph for c in exe._cache.values()
                 if hasattr(c.fn, "writeback_in_graph")]
    if writeback != [True]:
        raise AssertionError(f"sentinel: the unguarded graph's write-back "
                             f"{writeback}")
    _graphs("sentinel_clean", exe, True)
    exe.close()
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()

    counters = ("sentinel.skipped_steps", "sentinel.quarantined",
                "sentinel.rollbacks")
    before = {n: m.counter(n) for n in counters}
    _take_launches()
    (losses, guarded_s, runs, rollbacks, exe, scope, mgr,
     sentinel) = _sentinel_drill(pt, T, main, cost, hp, state, root,
                                 inject=True)
    launches = _take_launches()
    delta = {n: m.counter(n) - before[n] for n in counters}
    want = {k: 18 * runs for k in kernels}
    if launches != want:
        raise AssertionError(f"sentinel[drill]: launches {launches} != "
                             f"{want} ({runs} guarded runs)")
    if delta != {"sentinel.skipped_steps": 2, "sentinel.quarantined": 2,
                 "sentinel.rollbacks": 1} or rollbacks != [(2, 2)]:
        raise AssertionError(f"sentinel[drill]: counters {delta}, "
                             f"rollbacks {rollbacks}")
    if losses != clean:
        raise AssertionError(f"sentinel[drill]: applied losses {losses} "
                             f"!= the clean run's {clean}")
    guarded = [c for c in exe._cache.values()
               if hasattr(c.fn, "writeback_in_graph")]
    if [c.fn.writeback_in_graph for c in guarded] != [False] or \
            not guarded[0].fn.replays:
        raise AssertionError("sentinel: the guarded step is not one "
                             "graph whose write-back follows its replay")
    health = {g: m.gauge(g) for g in ("train.param_norm", "train.grad_norm",
                                      "train.update_ratio")}
    if not all(v is not None and np.isfinite(v) for v in health.values()):
        raise AssertionError(f"sentinel: health gauges {health}")

    # the guarded step, timed as the unguarded one was
    for s in range(SENTINEL_TIMED):
        t = time.perf_counter()
        exe.run(main, feed=_ckpt_feed(T, hp, 1 + s), fetch_list=[cost],
                scope=scope, sentinel=sentinel)
        guarded_s.append(time.perf_counter() - t)
    # a real fault: one parameter inf before a guarded replay
    pname = main.global_block().all_parameters()[0].name
    with torch.no_grad():
        scope.find_var(pname).view(-1)[0] = float("inf")
    snap = _snapshot(scope)
    guard = Sentinel(cadence=1, spike_factor=None)
    replays0 = guarded[0].fn.replays
    try:
        exe.run(main, feed=_ckpt_feed(T, hp, 3), fetch_list=[cost],
                scope=scope, sentinel=guard)
    except NumericalFault as fault:
        real = fault
    else:
        raise AssertionError("sentinel: an inf parameter did not trip")
    if guarded[0].fn.replays != replays0 + 1 or pname not in real.bad or \
            real.injected:
        raise AssertionError(f"sentinel: the real fault's trip "
                             f"{real.bad[:4]} (replayed "
                             f"{guarded[0].fn.replays - replays0})")
    changed = _bit_equal(scope, snap)
    if changed:
        raise AssertionError(f"sentinel: a tripped graphed step changed "
                             f"{changed[:4]}")
    _graphs("sentinel", exe, True)

    # the checkpoint survey of the drill's directory
    from paddle_tpu_torch import cli
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["ckpt", "verify", mgr.dirname])
    survey = buf.getvalue()
    if rc != 0 or "ckpt verify: PASS" not in survey or \
            f"last_good: {mgr.last_good_step()}" not in survey:
        raise AssertionError(f"ckpt verify (exit {rc}): {survey}")
    steps = sorted(mgr.steps())
    victim = mgr.path(steps[-1])
    files = [os.path.join(d, f) for d, _, fs in os.walk(victim)
             for f in fs if f != "MANIFEST.json"]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    with contextlib.redirect_stdout(io.StringIO()):
        rc_bad = cli.main(["ckpt", "verify", mgr.dirname])
    if rc_bad != 1:
        raise AssertionError(f"ckpt verify after a truncated file: exit "
                             f"{rc_bad}")

    bundles = sorted(os.listdir(sentinel.quarantine_dir))
    out = dict(
        steps=SENTINEL_STEPS, guarded_runs=runs, losses_equal_clean=True,
        counters=delta, rollback_to=rollbacks[0][0],
        unguarded_step_ms=1e3 * float(np.median(unguarded_s)),
        guarded_step_ms=1e3 * float(np.median(guarded_s[-SENTINEL_TIMED:])),
        unguarded_step_ms_range=[1e3 * min(unguarded_s),
                                 1e3 * max(unguarded_s)],
        guarded_step_ms_range=[1e3 * min(guarded_s[-SENTINEL_TIMED:]),
                               1e3 * max(guarded_s[-SENTINEL_TIMED:])],
        health=health, real_fault=pname, bundles=len(bundles),
        ckpt_verify_exit=[rc, rc_bad], card=card_line())
    log("sentinel[A]: " + json.dumps(out))
    exe.close()
    del exe, scope, state, snap
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 16: the training loop a real run uses: the datapipe through
# Executor.run_pipeline on route A at full width, the run ledger, the
# resume and sentinel drills through the loop, early release
# ---------------------------------------------------------------------------

#: batches of ``phase_datapipe_train``'s epoch (``PIPE_STEPS`` x 64
#: records), and the resume drill's stop: ``PIPE_K`` then ``PIPE_K`` more
PIPE_STEPS, PIPE_K = 6, 3
#: the pipeline's shuffle buffer, map workers and prefetch depth
PIPE_SHUFFLE, PIPE_WORKERS, PIPE_DEPTH = 256, 4, 2
#: the resume drill's guarded second half: the restored checkpoint turns
#: known-good at the first clean check, the next two are poisoned (two
#: strikes: the rollback)
PIPE_NAN_AFTER = 1


def _pipe_records(T, hp, path, n):
    """``n`` per-sample records (tuples of the ``READER_KEYS`` rows of one
    ``T.fake_batch``) in a recordio file; returns the rows."""
    from paddle_tpu_torch.recordio_writer import \
        convert_reader_to_recordio_file
    _, S, _ = ROUTES["A"]
    rows = T.fake_batch(n, S, S, hp, seed=SEED % 2 ** 31 + 7)
    got = convert_reader_to_recordio_file(
        path, lambda: (tuple(rows[k][i] for k in READER_KEYS)
                       for i in range(n)), compressor=0)
    if got != n:
        raise AssertionError(f"datapipe_train: {got} of {n} records")
    return rows


def _decode_record(rec):
    return dict(zip(READER_KEYS, rec))


def _pipe(dp, path, prefetch=True):
    """``RecordIOSource -> shuffle -> map(workers) -> batch(64) ->
    prefetch`` onto ``cuda:0`` (without ``prefetch``: host batches)."""
    B, _, _ = ROUTES["A"]
    pipe = (dp.RecordIOSource(path)
            .shuffle(PIPE_SHUFFLE, seed=SEED)
            .map(_decode_record, workers=PIPE_WORKERS)
            .batch(B, drop_last=True))
    return pipe.prefetch(depth=PIPE_DEPTH) if prefetch else pipe


def _cli_trace_dump(path):
    """``python -m paddle_tpu_torch trace dump --local --output PATH`` in
    this process (its span ring): the count of each span name written."""
    import collections
    import contextlib
    import io
    from paddle_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli.main(["trace", "dump", "--local", "--output", path])
    if rc != 0 or "wrote" not in buf.getvalue():
        raise AssertionError(f"cli trace dump (exit {rc}): "
                             f"{buf.getvalue()!r}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(ev.get("name") for ev in events)


def _cli_bench(runs):
    """``bench record`` of this run's pipeline figures as the
    ``datapipe`` bench (samples/s through ``run_pipeline``; speedup: the
    memory-fed step's time over the pipeline's), then ``bench check``,
    on a trajectory under ``OUT_DIR`` (in this process): PASS."""
    import contextlib
    import io
    from paddle_tpu_torch import cli
    B, _, _ = ROUTES["A"]
    traj = os.path.join(OUT_DIR, "bench_trajectory.json")
    summary = os.path.join(OUT_DIR, "bench_datapipe_summary.json")
    if os.path.exists(traj):
        os.remove(traj)
    with open(summary, "w") as f:
        json.dump({"datapipe": {"samples_per_sec":
                                1e3 * B / runs["pipeline"]["step_ms"]},
                   "speedup": runs["memory"]["step_ms"] /
                   runs["pipeline"]["step_ms"]}, f)
    codes = []
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        codes.append(cli.main(["bench", "record", "--bench", "datapipe",
                               "--summary", summary, "--trajectory", traj,
                               "--baseline"]))
        codes.append(cli.main(["bench", "check", "--trajectory", traj]))
    text = buf.getvalue()
    if codes != [0, 0] or "bench check (regression gate): PASS" not in \
            text:
        raise AssertionError(f"cli bench (exits {codes}): {text!r}")
    with open(traj) as f:
        return json.load(f)["runs"][0]["metrics"]


def _loss_list(outs):
    import numpy as np
    return [float(np.asarray(o[0]).reshape(())) for o in outs]


def _state_scope(pt, state):
    """A fresh scope holding device clones of ``state``."""
    scope = pt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    return scope


def _release_figures(pt, main, cost, state, feed):
    """Two route A steps from ``state`` on fresh executors, with and
    without ``release_memory`` on a clone of ``main``: the first eager,
    the second captured (and replayed).  Losses bit-identical either way;
    the eager step's peak allocation above its start, the graph's pool,
    and the bytes and vars the walk dropped."""
    import numpy as np
    import torch
    from paddle_tpu_torch.analysis.opt import clone_program
    out, losses = {}, {}
    for released in (False, True):
        key = "released" if released else "kept"
        prog = clone_program(main)
        if released:
            pt.release_memory(prog)
        exe, scope = pt.Executor(), _state_scope(pt, state)
        got = []
        for step in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got.append(float(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[cost],
                scope=scope)[0]).reshape(())))
            if step == 0:
                torch.cuda.synchronize()
                out[f"{key}_peak_gib"] = (
                    torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if released:
                    out["eager_dropped"] = dict(prog._release_stats)
        stats = exe.graph_stats()
        if len(stats) != 1 or stats[0]["captures"] != 1:
            raise AssertionError(f"datapipe_train[release]: graphs {stats}")
        out[f"{key}_pool_gib"] = stats[0]["pool_gib"]
        if released:
            out["capture_dropped"] = dict(prog._release_stats)
        losses[released] = got
        exe.close()
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    if losses[True] != losses[False]:
        raise AssertionError(f"datapipe_train[release]: losses {losses}")
    out["losses"] = losses[True]
    return out


def phase_datapipe_train():
    """Route A (Transformer-base, S 256, B 64, bf16 AMP, Adam) through
    the port's training loop: ``PIPE_STEPS`` x 64 per-sample records
    (rows of ``T.fake_batch``) written by ``recordio_writer``, read by
    ``RecordIOSource -> shuffle(256) -> map(decode, workers=4) ->
    batch(64, drop_last) -> prefetch(depth=2)`` onto ``cuda:0`` and
    driven by ``exe.run_pipeline(..., ledger=RunLedger)`` on the default
    (graphed) path, dropout 0.1.  Held to: losses bit-identical to a
    memory-fed ``Executor.run`` of the same batches in the same order
    (the same pipeline without ``prefetch``, on the host) from the same
    startup state and a fresh executor; 18 + 18 bias-softmax launches a
    step both ways; one graph; the ledger's ``PIPE_STEPS`` rows, each
    step once; the census's ``prefetch`` bytes above 0 while batches are
    staged and 0 after the epoch.  Then at dropout 0 (the dropout masks
    follow the executor's run counter, which no checkpoint holds): the
    resume drill (``PIPE_K`` steps with a ``CheckpointManager(datapipe,
    ledger)`` committing at step ``PIPE_K - 1`` while prefetch holds
    queued batches; a fresh executor, scope, pipeline and ledger handle;
    ``restore_latest()``; the rest of the epoch through ``run_pipeline``
    under a ``Sentinel(strikes=2)`` whose 2nd and 3rd checks are
    poisoned, so it rolls back to the restored checkpoint, rewinding the
    pipeline and the ledger): every persistable bit for bit a ``2 *
    PIPE_K``-step run that never stopped, the returned losses each batch
    once, the ledger ``2 * PIPE_K`` rows, each step once (none for a
    skipped step); ``release_memory``: an eager step and a capture on
    fresh executors, losses unchanged, peak and pool printed.  Prints ms
    a step through ``run_pipeline`` against memory-fed, the prefetch
    stall's p50 / p99 and the census's bytes; gates on no time."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.datapipe as dp
    from paddle_tpu_torch.fault import CheckpointManager, Sentinel, chaos
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.obs import perf, trace
    from paddle_tpu_torch.obs.ledger import RunLedger, read_rows
    from paddle_tpu_torch.profiler import runtime_metrics as m

    B, S, kernels = ROUTES["A"]
    root = os.path.join(OUT_DIR, "datapipe_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    path = os.path.join(root, "records.recordio")
    t = time.perf_counter()
    _pipe_records(T, hp, path, PIPE_STEPS * B)
    write_s = time.perf_counter() - t
    order = list(_pipe(dp, path, prefetch=False))
    if len(order) != PIPE_STEPS:
        raise AssertionError(f"datapipe_train: {len(order)} host batches")
    launches, parts_s = {}, {}
    t_part = time.perf_counter()

    def take(part, steps):
        got = _take_launches()
        want = {k: 18 * steps for k in kernels}
        if got != want:
            raise AssertionError(f"datapipe_train[{part}]: launches "
                                 f"{got} != {want}")
        launches[part] = got

    # -- the epoch at dropout 0.1: pipeline against memory-fed ---------
    main, startup, cost = _reader_program(pt, T, hp, B, S)
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    _take_launches()        # the counts set to 0 just before the path
    runs = {}
    for mode in ("pipeline", "memory"):
        scope = _scope_copy(pt, scope0)
        exe = pt.Executor()
        marks, staged = [], []
        torch.cuda.synchronize()
        if mode == "pipeline":
            ledger = RunLedger(os.path.join(root, "ledger_epoch"),
                               install=False)
            pipe = _pipe(dp, path)

            def on_step(step, fetches):
                marks.append(time.perf_counter())
                if step == 0:
                    # batches wait while the first (eager) step runs; a
                    # census outside the timed steps after the capture
                    staged.append(perf.hbm_census(scope)["prefetch"])

            trace.clear()
            trace.enable(4 * trace.DEFAULT_RING)   # a span a sample
            t0 = time.perf_counter()
            outs = exe.run_pipeline(main, pipe, fetch_list=[cost],
                                    scope=scope, ledger=ledger,
                                    on_step=on_step)
            trace.disable()
            spans = _cli_trace_dump(os.path.join(root, "trace.json"))
            trace.clear()
            trace.enable(trace.DEFAULT_RING)
            trace.disable()
            after = perf.hbm_census(scope)["prefetch"]
            ledger.close()
            rows = read_rows(ledger.dirname)
            if [r["step"] for r in rows] != list(range(PIPE_STEPS)) or \
                    ledger.rows_total != PIPE_STEPS:
                raise AssertionError(f"datapipe_train: ledger rows "
                                     f"{[r['step'] for r in rows]}")
            (staged_max,) = staged
            if not staged_max > 0 or after != 0:
                raise AssertionError(f"datapipe_train: census prefetch "
                                     f"bytes {staged} then {after}")
            stall = m.snapshot()["series"]["datapipe.prefetch.stall_seconds"]
            if spans.get("datapipe.next") != PIPE_STEPS or \
                    spans.get("train.step") != PIPE_STEPS:
                raise AssertionError(f"datapipe_train: trace dump spans "
                                     f"{spans}")
        else:
            t0 = time.perf_counter()
            outs = []
            for b in order:
                outs.append(exe.run(main, feed=b, fetch_list=[cost],
                                    scope=scope))
                marks.append(time.perf_counter())
        take(mode, PIPE_STEPS)
        replays = _graphs(f"datapipe_train_{mode}", exe, True)
        if len(exe.graph_stats()) != 1 or replays != PIPE_STEPS - 1:
            raise AssertionError(f"datapipe_train[{mode}]: graphs "
                                 f"{exe.graph_stats()}")
        steps_ms = np.diff([t0] + marks) * 1e3
        runs[mode] = dict(losses=_loss_list(outs),
                          step_ms=float(np.median(steps_ms[2:])),
                          step_ms_range=[float(steps_ms[2:].min()),
                                         float(steps_ms[2:].max())],
                          first_two_ms=[float(x) for x in steps_ms[:2]])
        exe.close()
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    got, want = runs["pipeline"]["losses"], runs["memory"]["losses"]
    if got != want or not np.all(np.isfinite(got)):
        raise AssertionError(f"datapipe_train: pipeline losses {got} "
                             f"against memory-fed {want}")
    del scope0

    parts_s["epoch"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # -- dropout 0: the resume drill, its second half guarded ---------
    main0, startup0, cost0, _ = _ckpt_program(pt, T)
    exe0, scope0 = pt.Executor(), pt.Scope()
    exe0.run(startup0, scope=scope0)
    state = _snapshot(scope0)
    del exe0, scope0
    feed0 = {k: v for k, v in order[0].items()}

    scope, exe = _state_scope(pt, state), pt.Executor()
    ledger = RunLedger(os.path.join(root, "ledger_unbroken"),
                       install=False)
    outs = exe.run_pipeline(main0, _pipe(dp, path), fetch_list=[cost0],
                            scope=scope, max_steps=2 * PIPE_K,
                            ledger=ledger)
    clean = _loss_list(outs)
    want_state = _tensor_state(scope)
    ledger.close()
    take("unbroken", 2 * PIPE_K)
    exe.close()
    del exe, scope
    parts_s["unbroken"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    ckdir = os.path.join(root, "ckpt")
    led_dir = os.path.join(root, "ledger_resume")
    scope, pipe, exe = _state_scope(pt, state), _pipe(dp, path), \
        pt.Executor()
    ledger = RunLedger(led_dir, install=False)
    mgr = CheckpointManager(ckdir, keep=2, executor=exe, main_program=main0,
                            scope=scope, datapipe=pipe, ledger=ledger)
    queued = []

    def commit(step, fetches):
        if step == PIPE_K - 1:
            q = pipe._q
            queued.append(q.qsize() if q is not None else 0)
            mgr.save(PIPE_K)
    first = exe.run_pipeline(main0, pipe, fetch_list=[cost0], scope=scope,
                             max_steps=PIPE_K, ledger=ledger,
                             on_step=commit)
    pending = len(pipe._pending)
    ledger.close()
    exe.close()
    del exe, scope, pipe, mgr, ledger
    gc.collect()
    parts_s["first_half"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # a fresh executor, scope, pipeline and ledger handle; the rest of the
    # epoch under a sentinel whose 2nd and 3rd checks are poisoned: two
    # strikes roll back to the restored checkpoint (made known-good by
    # the first clean check), rewinding the pipeline and the ledger
    counters = ("sentinel.skipped_steps", "sentinel.quarantined",
                "sentinel.rollbacks")
    before = {n: m.counter(n) for n in counters}
    scope, pipe, exe = pt.Scope(), _pipe(dp, path), pt.Executor()
    ledger = RunLedger(led_dir, install=False)
    mgr = CheckpointManager(ckdir, keep=2, executor=exe, main_program=main0,
                            scope=scope, datapipe=pipe, ledger=ledger)
    t = time.perf_counter()
    restored = mgr.restore_latest()
    restore_s = time.perf_counter() - t
    if restored != PIPE_K or ledger.rows_total != PIPE_K or \
            not mgr.last_restore_rewound:
        raise AssertionError(f"datapipe_train[resume]: restored "
                             f"{restored}, ledger {ledger.rows_total} rows")
    sentinel = Sentinel(manager=mgr, cadence=1, strikes=2,
                        mark_good_after=1, spike_factor=None,
                        quarantine_dir=os.path.join(root, "quarantine"))
    sentinel.note_checkpoint(PIPE_K)
    chaos.inject("sentinel.nan", after=PIPE_NAN_AFTER, times=2)
    try:
        t = time.perf_counter()
        outs = exe.run_pipeline(main0, pipe, fetch_list=[cost0],
                                scope=scope, sentinel=sentinel)
        second_s = time.perf_counter() - t
    finally:
        chaos.clear("sentinel.nan")
    ledger.close()
    guarded = PIPE_NAN_AFTER + 2 + PIPE_K
    take("resume", PIPE_K + guarded)
    delta = {n: m.counter(n) - before[n] for n in counters}
    resumed = _loss_list(first) + _loss_list(outs)
    got_state = _tensor_state(scope)
    differ = [n for n in want_state
              if not np.array_equal(got_state.get(n), want_state[n])]
    steps = [r["step"] for r in read_rows(led_dir)]
    if differ or sorted(got_state) != sorted(want_state) or \
            resumed != clean or steps != list(range(2 * PIPE_K)):
        raise AssertionError(f"datapipe_train[resume]: {len(differ)} "
                             f"variables differ ({differ[:4]}), losses "
                             f"{resumed} against {clean}, ledger steps "
                             f"{steps}")
    if delta != {"sentinel.skipped_steps": 2, "sentinel.quarantined": 2,
                 "sentinel.rollbacks": 1} or \
            mgr.last_good_step() != PIPE_K:
        raise AssertionError(f"datapipe_train[sentinel]: counters {delta}, "
                             f"last good {mgr.last_good_step()}")
    exe.close()
    del exe, scope, pipe, mgr, ledger, sentinel, got_state
    gc.collect()
    torch.cuda.empty_cache()
    parts_s["second_half"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # -- release_memory: an eager step and a capture -------------------
    release = _release_figures(pt, main0, cost0, state, feed0)
    parts_s["release"] = time.perf_counter() - t_part
    take("release", 4)
    if release["losses"][0] != clean[0]:
        raise AssertionError(f"datapipe_train[release]: losses "
                             f"{release['losses']} against {clean[0]}")
    del state
    bench = _cli_bench(runs)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(
        pipeline_step_ms=runs["pipeline"]["step_ms"],
        memory_step_ms=runs["memory"]["step_ms"],
        pipeline_step_ms_range=runs["pipeline"]["step_ms_range"],
        memory_step_ms_range=runs["memory"]["step_ms_range"],
        first_two_ms={k: v["first_two_ms"] for k, v in runs.items()},
        stall_p50_ms=1e3 * stall["p50"], stall_p99_ms=1e3 * stall["p99"],
        stall_count=stall["count"], prefetch_bytes_staged=staged_max,
        prefetch_bytes_after=after, records_write_s=write_s,
        losses_bit_identical=True, resume_bit_identical=True,
        resume_restore_s=restore_s, prefetch_queued_at_commit=queued[0],
        prefetch_pending_at_stop=pending, guarded_second_half_s=second_s,
        guarded_runs=guarded, release=release, bench=bench,
        parts_s=parts_s,
        trace_spans={k: spans[k] for k in ("datapipe.next", "train.step")},
        card=card_line())
    log(f"datapipe_train[A]: run_pipeline + prefetch "
        f"{out['pipeline_step_ms']:.3f} ms a step against memory-fed "
        f"{out['memory_step_ms']:.3f} (median of the {PIPE_STEPS - 2} "
        f"steps after the capture); "
        f"losses bit-identical over {PIPE_STEPS} steps; stall p50 "
        f"{out['stall_p50_ms']:.3f} ms, p99 {out['stall_p99_ms']:.3f} ms; "
        f"census prefetch {staged_max} bytes staged, {after} after; "
        f"resume at dropout 0 ({PIPE_K} + {PIPE_K}, {queued[0]} batches "
        f"queued at the commit; the second half guarded: 2 skipped, 1 "
        f"rollback to the restored step) bit-identical to the unbroken "
        f"run, ledger one row a step; release: eager peak "
        f"{release['kept_peak_gib']:.3f} -> "
        f"{release['released_peak_gib']:.3f} GiB, graph pool "
        f"{release['kept_pool_gib']:.3f} -> "
        f"{release['released_pool_gib']:.3f} GiB; card {out['card']}")
    return launches, out


#: steps of ``phase_parallel_train`` (route A at full width, dropout 0)
PARALLEL_STEPS = 6
#: the ``ring_attention`` op's check at ``seq`` size 1: [B, H, S, D]
#: float32, against plain float32 attention on the card (the op falls
#: back to the unfused route, the bias-softmax kernel; the two sum in
#: different orders)
RING_SHAPE = (4, 8, 256, 64)
RING_TOL = 2e-5


def _ring_op_check(pt, parallel):
    """The ``ring_attention`` op through ``ParallelExecutor`` on a
    ``(1, 1)`` ``("data", "seq")`` mesh, causal, against plain attention
    in float32: the max abs error."""
    import numpy as np
    import torch
    B, H, S, D = RING_SHAPE
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q, k, v = (pt.layers.data(name=n, shape=list(RING_SHAPE),
                                  append_batch_size=False)
                   for n in ("rq", "rk", "rv"))
        out = pt.layers.ring_attention(q, k, v, causal=True)
    rng = np.random.RandomState(SEED)
    feed = {n: (rng.randn(*RING_SHAPE) * 0.5).astype("float32")
            for n in ("rq", "rk", "rv")}
    mesh = parallel.make_mesh((1, 1), ("data", "seq"))
    pexe = parallel.ParallelExecutor(main_program=main, mesh=mesh)
    (got,) = pexe.run(feed=feed, fetch_list=[out], scope=pt.Scope())
    qt, kt, vt = (torch.from_numpy(feed[n]).cuda() for n in ("rq", "rk", "rv"))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").triu(1)
    want = torch.matmul(torch.softmax(s.masked_fill(mask, float("-inf")),
                                      -1), vt).cpu().numpy()
    return float(np.abs(got - want).max())


def _collective_ops_check(pt, parallel):
    """The eight ``c_*`` ops pinned to the ``data`` axis
    (``axis="data"``) through ``ParallelExecutor`` at world size 1: each
    runs its NCCL collective on this rank's value, which at one rank
    gives the value back (``c_allreduce_prod`` as ``exp(log x)``, within
    rounding).  Returns the collectives counted and the max abs error."""
    import numpy as np
    from paddle_tpu_torch.layer_helper import LayerHelper
    ops = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
           "c_allreduce_prod", "c_broadcast", "c_allgather",
           "c_reducescatter", "c_alltoall")
    main, startup = pt.Program(), pt.Program()
    outs = []
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="cx", shape=[8, 16], append_batch_size=False)
        for t in ops:
            helper = LayerHelper(t)
            out = helper.create_tmp_variable("float32")
            helper.append_op(type=t, inputs={"X": [x]},
                             outputs={"Out": [out]}, attrs={"axis": "data"})
            outs.append(out)
    xv = np.random.RandomState(SEED).uniform(0.5, 2.0, (8, 16)).astype(
        "float32")
    mesh = parallel.make_mesh((1,), ("data",))
    pexe = parallel.ParallelExecutor(main_program=main, mesh=mesh)
    pexe.count_collectives = True
    got = pexe.run(feed={"cx": xv}, fetch_list=outs, scope=pt.Scope())
    err = max(float(np.abs(g - xv).max()) for g in got)
    return pexe.collective_stats, err


@contextlib.contextmanager
def _plain_bias_softmax_calls():
    """``{"fwd": n, "grad": n}``: the calls of the bias-softmax pair's
    plain versions inside the block (none may run on the card)."""
    import importlib
    bsm = importlib.import_module("paddle_tpu_torch.kernels.bias_softmax")
    calls = {"fwd": 0, "grad": 0}
    ref_fwd, ref_grad = bsm.bias_softmax_reference, \
        bsm.bias_softmax_grad_reference

    def fwd(*a, **k):
        calls["fwd"] += 1
        return ref_fwd(*a, **k)

    def grad(*a, **k):
        calls["grad"] += 1
        return ref_grad(*a, **k)

    bsm.bias_softmax_reference = fwd
    bsm.bias_softmax_grad_reference = grad
    try:
        yield calls
    finally:
        bsm.bias_softmax_reference = ref_fwd
        bsm.bias_softmax_grad_reference = ref_grad


def phase_parallel_train():
    """Route A at full width through ``ParallelExecutor`` on NCCL at world
    size 1 (``init_parallel_env`` in this process): Transformer-base,
    S 256, B 64, bf16 AMP, Adam, dropout 0, on a ``(1, 1)`` ``("data",
    "model")`` mesh with ``tp_shardings()`` and ZeRO, ``PARALLEL_STEPS``
    steps.  The losses and every persistable must be bit-identical to
    ``Executor.run`` of the same state and feeds; the bias-softmax pair
    must launch 18 + 18 times a step on its kernels and its plain
    versions never.  Prints ms a step both ways (medians of the steps
    after the first; both graphed: the first step eager, the second
    captured, the rest replays), the collectives of one step (counted on
    the second, the capture: none at world size 1, where DTensor elides
    the collectives of a one-rank mesh axis) and their bytes, the first
    step's NCCL broadcasts of the state, the graph, the ``ring_attention``
    op's error at ``seq`` size 1, and the eight ``c_*`` ops pinned to
    the ``data`` axis, each one NCCL collective.  The process group is
    destroyed at the end."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import transformer as T

    B, S = ROUTE_A_B, ROUTE_A_S
    hp = T.ModelHyperParams()
    hp.dropout = 0.0
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    feeds = [T.fake_batch(B, S, S, hp, seed=SEED + i)
             for i in range(PARALLEL_STEPS)]
    parallel.init_parallel_env()
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"parallel_train: {dist.get_backend()} "
                                 f"world of {dist.get_world_size()}")
        scope = pt.Scope()
        exe = pt.Executor()
        exe.run(startup, scope=scope)
        init = _snapshot(scope)
        plain_losses, plain_s = [], []
        for feed in feeds:
            t = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[cost],
                              scope=scope)
            plain_s.append(time.perf_counter() - t)
            plain_losses.append(np.asarray(loss).reshape(()))
        plain_state = _snapshot(scope)
        _graphs("parallel_train_plain", exe, True)
        del exe, scope
        torch.cuda.empty_cache()

        pscope = pt.Scope()
        for n, v in init.items():
            pscope.set_var(n, v)
        del init
        mesh = parallel.make_mesh((1, 1), ("data", "model"))
        pexe = parallel.ParallelExecutor(
            loss_name=cost.name, main_program=main, mesh=mesh,
            param_shardings=T.tp_shardings(), zero=True)
        _take_launches()
        losses, par_s, comms = [], [], None
        with _plain_bias_softmax_calls() as plain_calls:
            for i, feed in enumerate(feeds):
                pexe.count_collectives = i == 1
                t = time.perf_counter()
                (loss,) = pexe.run(feed=feed, fetch_list=[cost],
                                   scope=pscope)
                par_s.append(time.perf_counter() - t)
                losses.append(np.asarray(loss).reshape(()))
                if i == 1:
                    comms = pexe.collective_stats
            launches = _take_launches()
        want = {"bias_softmax": 18 * PARALLEL_STEPS,
                "bias_softmax_grad": 18 * PARALLEL_STEPS}
        if launches != want or any(plain_calls.values()):
            raise AssertionError(f"parallel_train: launches {launches} != "
                                 f"{want}, plain versions {plain_calls}")
        if [x.tobytes() for x in losses] != \
                [x.tobytes() for x in plain_losses]:
            raise AssertionError(f"parallel_train: losses {losses} != "
                                 f"Executor.run's {plain_losses}")
        got = {n: (v.full_tensor() if hasattr(v, "full_tensor") else v)
               for n, v in _tensors(pscope).items()}
        holder = pt.Scope()
        for n, v in got.items():
            holder.set_var(n, v)
        bad = _bit_equal(holder, plain_state)
        if bad:
            raise AssertionError(f"parallel_train: {len(bad)} persistables "
                                 f"differ from Executor.run's: {bad[:5]}")
        graphs = pexe.graph_stats()
        if not graphs or not all(g["graphed"] for g in graphs) or \
                _graphs("parallel_train", pexe, True) != PARALLEL_STEPS - 1:
            raise AssertionError(f"parallel_train: graph state {graphs}")
        if comms is None or not pexe.broadcast_stats["calls"]:
            raise AssertionError(f"parallel_train: no first-step "
                                 f"broadcast ({pexe.broadcast_stats})")
        broadcasts = dict(pexe.broadcast_stats)
        placed = {n: str(tuple(v.placements)) for n, v in
                  _tensors(pscope).items() if hasattr(v, "placements") and
                  any(p.is_shard() for p in v.placements)}
        del pexe, pscope, holder, got, plain_state
        torch.cuda.empty_cache()
        ring_err = _ring_op_check(pt, parallel)
        if not ring_err <= RING_TOL:
            raise AssertionError(f"parallel_train: ring_attention at seq "
                                 f"size 1 off by {ring_err}")
        c_ops, c_err = _collective_ops_check(pt, parallel)
        if sum(c_ops["calls"].values()) != 8 or not c_err <= 1e-6:
            raise AssertionError(f"parallel_train: c_* ops {c_ops}, max "
                                 f"abs err {c_err}")
        _take_launches()
    finally:
        parallel.destroy_parallel_env()
    out = {"steps": PARALLEL_STEPS,
           "losses": [float(x) for x in losses],
           "parallel_step_ms": 1e3 * float(np.median(par_s[1:])),
           "plain_step_ms": 1e3 * float(np.median(plain_s[1:])),
           "parallel_step_s": [round(x, 4) for x in par_s],
           "plain_step_s": [round(x, 4) for x in plain_s],
           "collectives_a_step": comms["calls"],
           "collective_bytes_a_step": comms["bytes"],
           "first_step_broadcasts": broadcasts,
           "graph_state": {k: graphs[0][k] for k in (
               "graphed", "captures", "replays", "seconds", "nodes",
               "pool_gib")},
           "sharded_state": len(placed),
           "launches_a_step": {k: v // PARALLEL_STEPS
                               for k, v in launches.items()},
           "ring_attention_seq1_max_abs_err": ring_err,
           "c_ops_collectives": c_ops, "c_ops_max_abs_err": c_err}
    log(f"parallel_train: {json.dumps(out)}")
    return launches, out

#: route A's batch of 64 as this many microbatches (``phase_pipeline_train``)
PIPE_MICROBATCHES = 4
#: forward + backward steps of the pipelined route A
PIPELINE_STEPS = 3


def _bf16_grad_misses(got, want):
    """Elements of ``got`` beyond one bf16 rounding of ``want`` (numpy,
    float64): ``BF16_ATOL_SCALE`` times ``want``'s RMS plus ``BF16_RTOL``
    of each element; ``(misses, largest err / tol)``."""
    import numpy as np
    rms = float(np.sqrt(np.mean(np.square(want)))) if want.size else 0.0
    tol = BF16_ATOL_SCALE * rms + BF16_RTOL * np.abs(want)
    err = np.abs(got - want)
    ratio = float(np.max(err / np.maximum(tol, 1e-30))) if err.size else 0.0
    return int(np.sum(err > tol)), ratio


def phase_pipeline_train():
    """Route A at full width through the pipeline transpiler at one
    stage on a world-1 NCCL ``pipe`` mesh (see the module docstring,
    phase 17): losses and grads against the unsplit program's on
    ``Executor.run``, the bias-softmax launches, ``lint_pipeline`` at 2
    and 4 stages, ms a step.  The process group is destroyed at the
    end."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import analysis, parallel
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel.pipeline_transpiler import \
        pipeline_transpiler

    S = ROUTE_A_S
    mb = ROUTE_A_B // PIPE_MICROBATCHES
    hp = T.ModelHyperParams()
    hp.dropout = 0.0
    hp.max_length = max(hp.max_length, S)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, feed_names = T.transformer(mb, S, S, hp)
    main.amp = True
    cost = cost.name
    grad_main = main.clone()
    with pt.program_guard(grad_main):
        pt.append_backward(grad_main.global_block().var(cost))
    block = grad_main.global_block()
    params = sorted(p.name for p in block.all_parameters()
                    if block.has_var(p.name + "@GRAD"))
    batches = [T.fake_batch(mb, S, S, hp, seed=SEED + i)
               for i in range(PIPE_MICROBATCHES)]
    lint = {}
    for n in (2, 4):
        result = analysis.lint_pipeline(main, n, list(feed_names), [cost])
        if result.diagnostics:
            raise AssertionError(f"pipeline_train: lint_pipeline at {n} "
                                 f"stages:\n{result.format()}")
        lint[n] = "clean"
    parallel.init_parallel_env()
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"pipeline_train: {dist.get_backend()} "
                                 f"world of {dist.get_world_size()}")
        scope = pt.Scope()
        exe = pt.Executor()
        exe.run(startup, scope=scope)
        mesh = parallel.make_mesh((1,), ("pipe",))
        pp = pipeline_transpiler(main, 1, list(feed_names), [cost], mesh)
        pp.build(scope, batches[0])
        xs = pp.stack_microbatches(batches)
        run = pp.run_fn()
        _take_launches()
        step_s = []
        with _plain_bias_softmax_calls() as plain_calls:
            for _ in range(PIPELINE_STEPS):
                packed = {lane: v.detach().requires_grad_(lane != "i32")
                          for lane, v in pp.packed_params.items()}
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses = pp.select_fetch(run(packed, xs), cost)
                losses.sum().backward()
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
            launches = _take_launches()
        a_step = {k: v // PIPELINE_STEPS for k, v in launches.items()}
        want = {"bias_softmax": 18 * PIPE_MICROBATCHES * PIPELINE_STEPS,
                "bias_softmax_grad": 18 * PIPE_MICROBATCHES * PIPELINE_STEPS}
        if launches != want or any(plain_calls.values()):
            raise AssertionError(f"pipeline_train: launches {launches} != "
                                 f"{want}, plain versions {plain_calls}")
        got_losses = losses.detach().float().cpu().numpy().reshape(-1)
        got_grads = pp.unpack_grads({lane: v.grad for lane, v in
                                     packed.items() if v.grad is not None})
        if sorted(got_grads) != params:
            raise AssertionError(f"pipeline_train: grads of "
                                 f"{sorted(set(params) ^ set(got_grads))}")
        # the unsplit program, a microbatch at a time, on the same scope
        ref_losses, ref_grads = [], {n: 0.0 for n in params}
        for b in batches:
            (loss,) = exe.run(main, feed=b, fetch_list=[cost], scope=scope)
            ref_losses.append(np.asarray(loss, np.float32).reshape(()))
            vals = exe.run(grad_main, feed=b, scope=scope,
                           fetch_list=[n + "@GRAD" for n in params])
            for n, g in zip(params, vals):
                ref_grads[n] = ref_grads[n] + np.asarray(g, np.float64)
        _take_launches()
        ref_losses = np.array(ref_losses)
        if not np.all(np.isfinite(got_losses)) or not np.allclose(
                got_losses, ref_losses, rtol=BF16_RTOL, atol=0):
            raise AssertionError(f"pipeline_train: losses {got_losses} "
                                 f"against Executor.run's {ref_losses}")
        misses, worst = {}, 0.0
        for n in params:
            m, r = _bf16_grad_misses(got_grads[n], ref_grads[n])
            worst = max(worst, r)
            if m:
                misses[n] = m
        if misses:
            raise AssertionError(f"pipeline_train: grads beyond one bf16 "
                                 f"rounding: {misses} (largest err / tol "
                                 f"{worst:.3f})")
        out = {"microbatches": PIPE_MICROBATCHES, "microbatch": mb,
               "steps": PIPELINE_STEPS,
               "step_ms": 1e3 * float(np.median(step_s[1:])),
               "step_s": [round(x, 4) for x in step_s],
               "losses": [float(x) for x in got_losses],
               "executor_losses": [float(x) for x in ref_losses],
               "losses_bit_identical": got_losses.astype(np.float32)
               .tobytes() == ref_losses.astype(np.float32).tobytes(),
               "loss_max_rel": float(np.max(np.abs(got_losses - ref_losses)
                                            / np.abs(ref_losses))),
               "grads_checked": len(params),
               "grad_worst_err_over_tol": worst,
               "launches_a_step": a_step,
               "carrier_lanes": list(pp.carrier_lanes),
               "param_lanes": list(pp.param_lanes),
               "lint_pipeline": lint}
        del pp, xs, packed, losses, exe, scope
        torch.cuda.empty_cache()
    finally:
        parallel.destroy_parallel_env()
    log(f"pipeline_train: {json.dumps(out)}")
    return launches, out


def phase_sharded_tables():
    """W&D-Criteo through ``ParallelExecutor`` with
    ``plan_sharded_tables``' rules on a world-1 NCCL ``data`` mesh,
    against ``Executor.run`` bit for bit, and the sharded gather and
    scatter at the table's height (see the module docstring, phase
    17).  The process group is destroyed at the end."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.embedding import (plan_sharded_tables,
                                            sharded_gather,
                                            sharded_scatter_add)
    from paddle_tpu_torch.models import wide_and_deep as W

    B, vocab = W.CRITEO_BATCH, W.CRITEO["vocab_size"]
    main, startup, cost = _wd_program(pt, vocab, True)
    feeds = [W.fake_batch(B, SEED + i) for i in range(WD_COMPARE_STEPS)]
    parallel.init_parallel_env()
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"sharded_tables: {dist.get_backend()} "
                                 f"world of {dist.get_world_size()}")
        scope = pt.Scope()
        exe = pt.Executor()
        exe.run(startup, scope=scope)
        init = _snapshot(scope)
        plain_losses, plain_s = [], []
        for f in feeds:
            t = time.perf_counter()
            (loss,) = exe.run(main, feed=f, fetch_list=[cost], scope=scope)
            plain_s.append(time.perf_counter() - t)
            plain_losses.append(np.asarray(loss).reshape(()))
        plain_state = _snapshot(scope)
        del exe, scope
        torch.cuda.empty_cache()

        mesh = parallel.make_mesh((1,), ("data",))
        plan = plan_sharded_tables(main, mesh_axis="data", mesh=mesh)
        pscope = pt.Scope()
        for n, v in init.items():
            pscope.set_var(n, v)
        del init
        pexe = parallel.ParallelExecutor(
            loss_name=cost.name, main_program=main, mesh=mesh,
            param_shardings=plan.rules())
        _take_launches()
        losses, par_s = [], []
        for f in feeds:
            t = time.perf_counter()
            (loss,) = pexe.run(feed=f, fetch_list=[cost], scope=pscope)
            par_s.append(time.perf_counter() - t)
            losses.append(np.asarray(loss).reshape(()))
        _no_launches("sharded_tables")
        if [x.tobytes() for x in losses] != \
                [x.tobytes() for x in plain_losses]:
            raise AssertionError(f"sharded_tables: losses {losses} != "
                                 f"Executor.run's {plain_losses}")
        placed = {n: [p.dim if p.is_shard() else None
                      for p in pscope.find_var(n).placements]
                  for n in plan.all_placements()}
        if any(p != [0] for p in placed.values()) or len(placed) < 6:
            raise AssertionError(f"sharded_tables: placements {placed}")
        holder = pt.Scope()
        for n, v in _tensors(pscope).items():
            holder.set_var(n, v.full_tensor() if hasattr(v, "full_tensor")
                           else v)
        bad = _bit_equal(holder, plain_state)
        if bad:
            raise AssertionError(f"sharded_tables: {len(bad)} persistables "
                                 f"differ from Executor.run's: {bad[:5]}")
        table = pscope.find_var("wide_deep_emb").to_local()
        ids = torch.from_numpy(feeds[0]["slot_ids"]).cuda().reshape(-1)
        gathered = sharded_gather(table, ids, "data", mesh)
        if not torch.equal(gathered, table[ids]):
            raise AssertionError("sharded_tables: sharded_gather differs "
                                 "from dense indexing")
        rows = torch.unique(ids)
        vals = torch.randn((rows.numel(), table.shape[1]), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               SEED))
        scattered = sharded_scatter_add(table, rows, vals, "data", mesh)
        dense = table.clone()
        dense[rows] += vals
        if not torch.equal(scattered, dense):
            raise AssertionError("sharded_tables: sharded_scatter_add "
                                 "differs from dense indexing")
        out = {"steps": WD_COMPARE_STEPS, "vocab": vocab,
               "losses": [float(x) for x in losses],
               # the first step eager, the second captured, the rest
               # replays: ms a step of the replays
               "parallel_replay_ms": 1e3 * float(np.median(par_s[2:])),
               "plain_replay_ms": 1e3 * float(np.median(plain_s[2:])),
               "parallel_step_s": [round(x, 5) for x in par_s],
               "plain_step_s": [round(x, 5) for x in plain_s],
               "sharded": sorted(placed),
               "graphs": [{k: g[k] for k in ("graphed", "reason")
                           if k in g} for g in pexe.graph_stats()],
               "gather_ids": int(ids.numel()),
               "scatter_rows": int(rows.numel())}
        del pexe, pscope, holder, table, scattered, dense
        torch.cuda.empty_cache()
    finally:
        parallel.destroy_parallel_env()
    log(f"sharded_tables: {json.dumps(out)}")
    return out


def _trace_kernel_seconds(path, substring):
    """Seconds of the trace's kernels whose name contains ``substring``,
    summed straight from the Chrome trace JSON."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(float(e["dur"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and substring in str(e.get("name", ""))) / 1e6


def phase_perf(serving):
    """The live MFU, the HBM census and device time on route A at full
    width (dropout 0.1, bf16 AMP, graphed): ``train.mfu`` after the
    graphed steps equals the record's ``flops / (step s x peak)`` at the
    card's bf16 peak (``gpu-peak``); the census's ``params + optimizer``
    equals the byte sum of the scope's tensors, ``total`` is at most
    ``memory_allocated()`` and ``high_watermark`` at least ``total``;
    ``measure_device_seconds`` over 3 graphed replays is at most their
    wall time, and a trace of 3 more gives the kernels' union, their plain
    sum and ``scope_device_seconds(..., "bias_softmax")`` equal to the
    sum of that kernel's events.  ``profile op`` lists ``softmax`` and
    ``softmax_grad``; ``profile memory --json`` and ``profile compile
    --json`` pass ``validate_report``.  Then the paged serving bundle's
    decode: ``gen.decode_mfu`` set, ``train.mfu`` untouched, the census's
    ``kv_pages`` equal to the predictor's pool bytes."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import cli, profiler
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.obs import perf
    from paddle_tpu_torch.profiler import runtime_metrics as m

    B, S, kernels = ROUTES["A"]
    hp = T.ModelHyperParams()
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = T.fake_batch(B, S, S, hp, seed=SEED)
    _take_launches()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)
    rec = exe._last_compiled.perf_record
    peak, basis = perf.peak_flops_info(exe.device)
    mfu = m.gauge("train.mfu")
    want_mfu = rec["flops"] / (rec["last_step_seconds"] * peak)
    if basis != "gpu-peak" or peak != 989e12 or rec["steps"] != TRAIN_STEPS \
            or abs(mfu - want_mfu) > 1e-12 * want_mfu:
        raise AssertionError(f"perf: train.mfu {mfu} != {want_mfu} "
                             f"({basis}, {rec})")

    # the census
    census = perf.hbm_census(scope)
    allocated = torch.cuda.memory_allocated()
    storages = {}
    for v in _tensors(scope).values():
        st = v.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    state_bytes = sum(storages.values())
    if census["params"] + census["optimizer"] != state_bytes or \
            not census["total"] <= allocated or \
            not census["high_watermark"] >= census["total"] or \
            census["limit"] != torch.cuda.mem_get_info()[1]:
        raise AssertionError(f"perf: census {census} against the state's "
                             f"{state_bytes} bytes, allocated {allocated}")

    # device time: 3 graphed replays under measure_device_seconds, 3 more
    # under a trace read three ways
    wall = []

    def three():
        t = time.perf_counter()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        wall.append(time.perf_counter() - t)

    busy = profiler.measure_device_seconds(three)
    if not 0 < busy <= wall[0]:
        raise AssertionError(f"perf: device busy {busy} s over 3 replays "
                             f"of {wall[0]} s wall")
    td = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        profiler.start_profiler("All", td)
        try:
            three()
        finally:
            path = profiler.stop_profiler(profile_path=td)
        union = profiler.device_busy_seconds(path)
        plain_sum = sum(d for _, d in profiler.iter_trace_events(
            path, device_only=True)) / 1e12
        scoped = profiler.scope_device_seconds(path, "bias_softmax")
        direct = _trace_kernel_seconds(path, "bias_softmax")
    finally:
        shutil.rmtree(td, ignore_errors=True)
    if abs(scoped - direct) > 1e-9 * max(direct, 1e-9) + 1e-12 or \
            not direct > 0 or not union <= wall[1]:
        raise AssertionError(f"perf: scope_device_seconds {scoped} against "
                             f"the trace's bias_softmax events {direct}; "
                             f"union {union}, wall {wall[1]}")
    launches = _take_launches()
    runs = TRAIN_STEPS + 6
    want = {k: 18 * runs for k in kernels}
    if launches != want:
        raise AssertionError(f"perf: launches {launches} != {want}")
    _graphs("perf", exe, True)
    exe.close()
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI: profile op (the eager step with op ranges), memory, compile
    def run_cli(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        if rc != 0:
            raise AssertionError(f"{' '.join(argv)}: exit {rc}")
        return buf.getvalue()

    table = run_cli("profile", "op", "--steps", "1")
    ops = {line.split()[0] for line in table.splitlines()[1:] if line}
    if not {"softmax", "softmax_grad"} <= ops:
        raise AssertionError(f"profile op: no softmax rows in\n{table}")
    mem = json.loads(run_cli("profile", "memory", "--json"))
    comp = json.loads(run_cli("profile", "compile", "--json"))
    problems = perf.validate_report(comp)
    if problems or not mem["params"] > 0 or mem["total"] is None:
        raise AssertionError(f"profile memory/compile: {problems} {mem}")
    cli_launches = _take_launches()

    # the paged decode feeds gen.decode_mfu, not train.mfu; its pool is
    # the census's kv_pages (beside any predictor still alive)
    gc.collect()
    kv0 = perf.hbm_census(pt.Scope())["kv_pages"]
    pred = GenPredictor(serving["bundle"])
    train_mfu = m.gauge("train.mfu")
    m.set_gauge("gen.decode_mfu", -1.0)
    sched = GenScheduler(pred)
    toks = list(sched.submit(serving["prompts"][0], max_new_tokens=8))
    sched.close()
    decode_mfu = m.gauge("gen.decode_mfu")
    kv = perf.hbm_census(pt.Scope())
    pool = sum(pred._scope.find_var(n).untyped_storage().nbytes()
               for n in pred.cache_vars)
    if toks != serving["streams"][0][:8] or not decode_mfu > 0 or \
            m.gauge("train.mfu") != train_mfu or \
            kv["kv_pages"] - kv0 != pool:
        raise AssertionError(f"perf[decode]: tokens {toks}, decode_mfu "
                             f"{decode_mfu}, train.mfu {m.gauge('train.mfu')}"
                             f" (was {train_mfu}), kv_pages "
                             f"{kv['kv_pages']} - {kv0} (pool {pool})")
    decode_launches = _take_launches()
    del pred
    gc.collect()

    gib = 2 ** 30
    out = dict(
        train_mfu=mfu, flops_per_step=rec["flops"],
        flops_source=rec["flops_source"],
        cost_estimate_s=rec["cost_seconds"],
        mfu_step_ms=1e3 * rec["last_step_seconds"],
        mfu_at_median=rec["flops"] / (float(np.median(step_s[2:])) * peak),
        step_ms_median=1e3 * float(np.median(step_s[2:])),
        peak_flops=peak, mfu_basis=basis,
        first_run=dict(rec["phases"], temp_gib=(rec["memory"]["temp_bytes"]
                                                or 0) / gib),
        census_gib={k: (v / gib if isinstance(v, (int, float)) else v)
                    for k, v in census.items()},
        busy_3_replays_s=busy, wall_3_replays_s=wall[0],
        trace_union_s=union, trace_kernel_sum_s=plain_sum,
        trace_wall_s=wall[1], bias_softmax_s=scoped,
        profile_op_rows=len(ops), gen_decode_mfu=decode_mfu,
        kv_pages_gib=pool / gib,
        replays_running=sum(p.returncode is None for p in REPLAYS),
        card=card_line())
    log("perf[A]: " + json.dumps(out))
    torch.cuda.empty_cache()
    return launches, cli_launches, decode_launches, out


GEN_TRAIN_B, GEN_TRAIN_T, GEN_TRAIN_STEPS = 8, 256, 4


def phase_gen_lm_train():
    """The causal LM of ``gen_lm_train_program`` at ``GenLongConfig`` takes
    a few Adam steps on the card (float32): loss finite and falling, one
    bias-softmax forward and backward a layer a step (its attention is
    composed, masked by a ``[1, 1, T, T]`` causal plane)."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import gen_lm
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig

    hp = GenLongConfig()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, feeds = gen_lm.gen_lm_train_program(GEN_TRAIN_B, GEN_TRAIN_T,
                                                  hp)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED % (2 ** 31))
    ids = rng.randint(0, hp.vocab_size, (GEN_TRAIN_B, GEN_TRAIN_T + 1))
    feed = {"gen_ids": ids[:, :-1].astype("int32"),
            "gen_labels": ids[:, 1:].astype("int32")}
    for kern in ALL_KERNELS:
        kern.launches = 0
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0].reshape(()))
              for _ in range(GEN_TRAIN_STEPS)]
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    n = int(hp.n_layer) * GEN_TRAIN_STEPS
    if launches != {"bias_softmax": n, "bias_softmax_grad": n}:
        raise AssertionError(f"gen_lm train: launches {launches}, want {n} "
                             f"of each bias-softmax kernel")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gen_lm train: losses {losses} not finite "
                             f"and falling")
    _graphs("gen_lm_train", exe, True)
    log(f"gen_lm train: B={GEN_TRAIN_B} T={GEN_TRAIN_T} feeds {feeds} "
        f"losses {[round(x, 5) for x in losses]}; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the conv zoo: the 3x3 kernel, ResNet-50, VGG-16 and MNIST
# ---------------------------------------------------------------------------

#: ResNet-50's 3x3 bodies ``(H, C, Co)``, all stride 1 (the reference's
#: ``SHAPES_3X3``, ``exp_resnet_conv.py:36``), at ``bench_resnet.py``'s
#: batch
CONV3X3_SHAPES = ((56, 64, 64), (28, 128, 128), (14, 256, 256),
                  (7, 512, 512))
CONV3X3_N = 256


def _conv3x3_case(N, H, C, Co, dtype, g):
    import torch
    x = torch.randn(N, H, H, C, generator=g).to(dtype).cuda()
    w = (torch.randn(3, 3, C, Co, generator=g) * (2.0 / (9 * C)) ** 0.5)
    scale = torch.rand(Co, generator=g) + 0.5
    bias = torch.randn(Co, generator=g) * 0.1
    return x, w.to(dtype).cuda(), scale.cuda(), bias.cuda()


def assert_conv3x3_f32(got, want, x, w, scale, what):
    """float32 ``conv3x3_bn_act`` outputs against each other: the two sum
    the 9 * C products in different orders, so each element is held to
    ``kernels.conv3x3.f32_tolerance`` (8 sqrt(K) roundings of the sum of
    magnitudes), plus ``F32_TOL`` of itself for an epilogue that rounds
    otherwise (a batch norm's own, on the inference path)."""
    import torch
    from paddle_tpu_torch.kernels.conv3x3 import f32_tolerance
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    tol = f32_tolerance(x, w, scale) + F32_TOL * want.float().abs()
    if not bool((err <= tol).all()):
        worst = float((err / tol).max())
        raise AssertionError(f"{what}: max error {float(err.max()):.3e} is "
                             f"{worst:.2f} x its bound")


def phase_conv3x3():
    """``conv3x3_bn_act`` against its plain version at ResNet-50's four
    3x3 shapes, N = 256, bf16 (what AMP would hand it; the tensor-core
    body), ReLU on and off, and once in float32 (the CUDA-core body);
    then each shape's bf16 times beside the plain version's, cuDNN's
    (``F.conv2d`` in NCHW and in ``channels_last``, the faster, plus the
    same epilogue; a yardstick), cuDNN's bf16 ``channels_last``
    ``F.conv2d`` alone (no epilogue: the bare convolution) and the
    bound: the products at the bf16 tensor-core peak, x and out written
    once, w, scale and bias read once."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.conv3x3 import (conv3x3_bn_act,
                                                  conv3x3_bn_act_reference)
    g = torch.Generator().manual_seed(SEED + 5)
    worst, rows = 0.0, {}
    for H, C, Co in CONV3X3_SHAPES:
        x, w, scale, bias = _conv3x3_case(CONV3X3_N, H, C, Co,
                                          torch.bfloat16, g)
        for relu in (True, False):
            got = conv3x3_bn_act(x, w, scale, bias, relu)
            torch.cuda.synchronize()
            want = conv3x3_bn_act_reference(x, w, scale, bias, relu)
            err = max_err(got, want)
            what = (f"conv3x3 [{CONV3X3_N}, {H}, {H}, {C}] -> {Co} bf16 "
                    f"relu={relu}")
            assert_matches(got, want, what)
            worst = max(worst, err)
            log(f"{what}: max_abs_err={err:.3e}")
            del got, want
        nbytes = 2 * (x.numel() + w.numel() + CONV3X3_N * H * H * Co) \
            + 8 * Co
        ops = 2 * CONV3X3_N * H * H * C * Co * 9
        b, by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
        ms = time_ms(lambda: conv3x3_bn_act(x, w, scale, bias), iters=10,
                     warmup=2)
        plain = time_ms(lambda: conv3x3_bn_act_reference(x, w, scale, bias),
                        iters=3, warmup=1)
        lib = {}
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        for layout, fmt in (("nchw", torch.contiguous_format),
                            ("channels_last", torch.channels_last)):
            xl, wl = (t.contiguous(memory_format=fmt) for t in (xn, wn))
            lib[layout] = time_ms(lambda: torch.relu(
                F.conv2d(xl, wl, padding=1).float()
                * scale[:, None, None] + bias[:, None, None]).to(x.dtype),
                iters=20, warmup=3)
        library = min(lib.values())
        xl, wl = (t.contiguous(memory_format=torch.channels_last)
                  for t in (xn, wn))
        cudnn = time_ms(lambda: F.conv2d(xl, wl, padding=1), iters=20,
                        warmup=3)
        log(f"conv3x3[{H}x{H}x{C}->{Co}, N={CONV3X3_N}, bf16] kernel_ms="
            f"{ms:.5f} ({ops / ms / 1e9:.2f} TFLOP/s) plain_ms={plain:.5f} "
            f"library_ms={library:.5f} (cuDNN F.conv2d + epilogue: nchw "
            f"{lib['nchw']:.5f}, channels_last {lib['channels_last']:.5f}; "
            f"{library / ms:.2f} x the kernel's time) cudnn_conv_ms="
            f"{cudnn:.5f} (F.conv2d channels_last alone, "
            f"{ops / cudnn / 1e9:.2f} TFLOP/s; {cudnn / ms:.2f} x) "
            f"bound_ms={b:.6f} ({by}; {100 * b / ms:.1f}% of it)")
        rows[(H, C, Co)] = dict(ms=ms, plain_ms=plain, library_ms=library,
                                bound_ms=b, bound_by=by, cudnn_conv_ms=cudnn)
        del x, w, xn, wn, xl, wl
        torch.cuda.empty_cache()
    # float32: the products summed in another order than the plain version
    x, w, scale, bias = _conv3x3_case(64, 28, 128, 128, torch.float32, g)
    got = conv3x3_bn_act(x, w, scale, bias)
    torch.cuda.synchronize()
    want = conv3x3_bn_act_reference(x, w, scale, bias)
    assert_conv3x3_f32(got, want, x, w, scale, "conv3x3 f32")
    err = max_err(got, want)
    worst = max(worst, err)
    log(f"conv3x3 [64, 28, 28, 128] -> 128 float32 relu=True: "
        f"max_abs_err={err:.3e}")
    torch.cuda.empty_cache()
    return worst, rows


#: ``bench_resnet.py``'s batch (its ``PADDLE_TPU_BENCH_BATCH`` default)
RESNET_B = 256
CONV_TRAIN_STEPS = 5
#: batch per model; VGG-16 and MNIST at the reference builders' own
#: image sizes (32x32x3 with 10 classes, 1x28x28)
CONV_MODELS = {"resnet50": RESNET_B, "vgg16": 128, "mnist": 128}
RESNET_INFER_B = 32


def _conv_program(pt, model, B, optimize=True):
    """``(main, startup, test clone, cost, predict, feed names)`` of a conv
    model's train program, built inside one name scope so that programs
    of other batches share its parameter names."""
    from paddle_tpu_torch.framework import unique_name_scope
    from paddle_tpu_torch.models import mnist, resnet, vgg
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name_scope(f"{model}_"), pt.program_guard(main, startup):
        if model == "resnet50":
            cost, _, feeds = resnet.resnet_train_program(B, class_dim=1000,
                                                         depth=50)
        elif model == "vgg16":
            cost, _, feeds = vgg.vgg_train_program(B)
        else:
            cost, _, feeds = mnist.mnist_train_program(B)
        test = main.clone(for_test=True)
        if optimize:
            pt.optimizer.Momentum(learning_rate=0.01,
                                  momentum=0.9).minimize(cost)
    ce = next(op for op in main.global_block().ops
              if op.type == "cross_entropy")
    predict = main.global_block().var(ce.input("X")[0])
    return main, startup, test, cost, predict, feeds


def _conv_feed(main, feeds, classes, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    shape = tuple(main.global_block().var(feeds[0]).shape)
    return {feeds[0]: rng.rand(*shape).astype("float32"),
            feeds[1]: rng.randint(0, classes, (shape[0], 1)).astype("int64")}


def phase_train_conv(model):
    """A conv model trains on the card through ``resnet_train_program`` /
    ``vgg_train_program`` / ``mnist_train_program``, ``Momentum(0.01,
    0.9).minimize`` and ``Executor.run``, bf16 AMP, a few steps on one
    fixed seeded batch: loss finite and falling, and no hand-written
    kernel launched (the convs are cuDNN's, as the reference's are
    XLA's).  Returns the launches, the numbers, and for ResNet-50 the
    trained state."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.flops import program_matmul_flops
    from paddle_tpu_torch.kernels import ALL_KERNELS

    B = CONV_MODELS[model]
    main, startup, test, cost, predict, feeds = _conv_program(pt, model, B)
    main.amp = True
    fwd_flops = program_matmul_flops(main.global_block())
    scope, exe = pt.Scope(), pt.Executor()
    if exe.device.type != "cuda":
        raise AssertionError(f"Executor landed on {exe.device}")
    exe.run(startup, scope=scope)
    classes = 1000 if model == "resnet50" else 10
    feed = _conv_feed(main, feeds, classes, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in ALL_KERNELS:
        kern.launches = 0
    losses, step_s = [], []
    for _ in range(CONV_TRAIN_STEPS):
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)   # the fetch synchronizes
        losses.append(float(np.asarray(loss).reshape(())))
    launches = {k.name: k.launches for k in ALL_KERNELS}
    if any(launches.values()):
        raise AssertionError(f"train[{model}]: hand-written kernels "
                             f"launched: {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train[{model}]: losses {losses} not finite "
                             f"and falling")
    steady = _steady(step_s, True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = 3 * fwd_flops / steady / BF16_TC_OPS_PER_S
    _graphs(f"{model}_train", exe, True)
    log(f"train[{model}]: B={B} losses {[round(x, 5) for x in losses]}; "
        f"step s {[round(x, 4) for x in step_s]}; steady (the replays' "
        f"median) {1e3 * steady:.2f}"
        f" ms a step = {B / steady:.1f} images/s; MFU {100 * mfu:.2f}% "
        f"(3 x {fwd_flops / 1e9:.1f} GFLOP of conv and fc a forward over "
        f"{BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s); peak memory {peak:.2f} "
        f"GiB")
    out = dict(step_ms=1e3 * steady, images_per_s=B / steady, mfu=mfu,
               peak_gib=peak, losses=losses, batch=B)
    state = (scope, exe) if model == "resnet50" else None
    del scope, exe
    torch.cuda.empty_cache()
    return launches, out, state


def phase_infer_conv3x3(state):
    """The path that runs the kernel.  The trained ResNet-50 (its scope) is
    saved with ``save_inference_model`` (the test clone of its program at
    ``RESNET_INFER_B``, same parameter names), loaded with
    ``load_inference_model`` and run on the card in float32 (TF32 off);
    its predictions must equal the test clone's.  Then for each of the
    sixteen 3x3 ``conv2d -> batch_norm -> relu`` chains of the loaded
    program, the kernel runs on the conv's input from that run (NHWC),
    the filter (HWIO) and the batch norm folded into scale and bias, and
    must give the program's own ReLU output (``assert_conv3x3_f32``; the
    CUDA-core body), and then runs on the same inputs in bf16 (the
    tensor-core body), against the plain version: exactly 32 launches,
    16 of each, the counted path."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.kernels.conv3x3 import (
        CONV3X3, conv3x3_bn_act, conv3x3_bn_act_reference, fold_batch_norm)
    from paddle_tpu_torch.models.resnet import conv3x3_bn_relu_chains

    scope, exe = state
    _, _, test, _, predict, feeds = _conv_program(pt, "resnet50",
                                                  RESNET_INFER_B,
                                                  optimize=False)
    test.amp = False
    bundle = os.path.join(OUT_DIR, "resnet50_inference")
    with pt.scope_guard(scope):
        pt.io.save_inference_model(bundle, [feeds[0]], [predict], exe,
                                   main_program=test)
    infer_scope = pt.Scope()
    with pt.scope_guard(infer_scope):
        loaded, feed_names, fetch = pt.io.load_inference_model(bundle, exe)
    loaded.amp = False
    chains = conv3x3_bn_relu_chains(loaded)
    if len(chains) != 16:
        raise AssertionError(f"infer: {len(chains)} 3x3 conv-bn-relu chains, "
                             f"want 16")
    test_feed = _conv_feed(test, feeds, 1000, SEED + 6)
    feed = {feed_names[0]: test_feed[feeds[0]]}
    names = [fetch[0].name]
    for conv, _, relu in chains:
        names += [conv.input("Input")[0], relu.output("Out")[0]]
    # three runs on an executor of its own: eager, captured and replayed,
    # replayed; the graph's outputs are the eager run's, bit for bit
    iexe = pt.Executor()
    runs = [iexe.run(loaded, feed=feed, fetch_list=names, scope=infer_scope,
                     return_numpy=False) for _ in range(3)]
    got = runs[-1]
    if not all(torch.equal(a, b) for a, b in zip(runs[0], got)):
        raise AssertionError("infer: the graph's outputs differ from the "
                             "eager run's")
    _graphs("resnet50_infer", iexe, True)
    del runs, iexe
    (want,) = exe.run(test, feed=test_feed, fetch_list=[predict],
                      scope=scope)
    pred = got[0].cpu().numpy()
    if pred.shape != (RESNET_INFER_B, 1000) or \
            not np.isfinite(pred).all():
        raise AssertionError(f"infer: predictions {pred.shape}")
    np.testing.assert_allclose(pred, want, rtol=F32_TOL, atol=1e-7,
                               err_msg="infer: loaded vs test clone")
    pred_diff = float(np.abs(pred - want).max())

    def operands(i):
        conv, bn, _ = chains[i]
        x = got[1 + 2 * i].permute(0, 2, 3, 1).contiguous()
        w = infer_scope.find_var(conv.input("Filter")[0])
        w = w.permute(2, 3, 1, 0).contiguous()
        scale, bias = fold_batch_norm(
            *(infer_scope.find_var(bn.input(s)[0])
              for s in ("Scale", "Bias", "Mean", "Variance")),
            bn.attr("epsilon"))
        return x, w, scale, bias

    for kern in ALL_KERNELS:
        kern.launches = 0
    outs = [conv3x3_bn_act(*operands(i)) for i in range(len(chains))]
    f32_launches = CONV3X3.launches
    outs_bf16 = []
    for i in range(len(chains)):
        x, w, scale, bias = operands(i)
        outs_bf16.append(conv3x3_bn_act(x.bfloat16(), w.bfloat16(), scale,
                                        bias))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    if launches != {"conv3x3": 32} or f32_launches != 16:
        raise AssertionError(f"infer: launches {launches} ({f32_launches} "
                             f"float32), want 32 conv3x3: 16 float32 and "
                             f"16 bf16")
    worst = worst_bf16 = 0.0
    for i, out in enumerate(outs):
        x, w, scale, bias = operands(i)
        ref = got[2 + 2 * i].permute(0, 2, 3, 1)
        assert_conv3x3_f32(out, ref, x, w, scale,
                           f"infer chain {i} {tuple(x.shape)}")
        worst = max(worst, max_err(out, ref))
    for i, kb in enumerate(outs_bf16):
        x, w, scale, bias = operands(i)
        pb = conv3x3_bn_act_reference(x.bfloat16(), w.bfloat16(), scale,
                                      bias)
        assert_matches(kb, pb, f"infer chain {i} bf16")
        worst_bf16 = max(worst_bf16, max_err(kb, pb))
    log(f"infer: ResNet-50 bundle loaded and run on the card (B="
        f"{RESNET_INFER_B}, float32): predictions equal the test clone's "
        f"(max diff {pred_diff:.3e}); 16 chains through conv3x3 in float32 "
        f"(the CUDA-core body) against the program's relu'd batch norm: "
        f"max_abs_err {worst:.3e}; 16 in bf16 (the tensor-core body) "
        f"against the plain version {worst_bf16:.3e}; launches {launches} "
        f"= {f32_launches} float32 + {launches['conv3x3'] - f32_launches} "
        f"bf16")
    return launches, max(worst, worst_bf16)


#: ResNet-50 card against CPU.  A ReLU input within rounding of 0 (a
#: "kink": on one device it passes its grad, on the other not) moves every
#: leaf below it, and in ResNet-50 the batch norms' backward spreads each
#: such change over its channel and carries it through up to 52 more
#: batch norms: the ~100 kinks of B = 2 at 224x224 (of 18M ReLU inputs)
#: move those leaves by about 3% (measured on an H100, PR 4).  It is the
#: float32 computation itself: on the CPU, the port's and the JAX
#: package's float32 grads of this step lie alike 1-3% from float64
#: grads (measured, PR 4).  So every leaf is held against a float64 step
#: on the CPU from the same state: the card's float32 leaves may lie at
#: most ``CARD_CPU_F64_FACTOR`` times as far from it as the CPU's float32
#: leaves do, at the worst leaf and at the median (measured: 1.32 times,
#: at both).  The leaves whose grads pass no kinked ReLU (the forward ops
#: after the last kinked one: at least the fc) see only the forward's
#: float32 differences, which grow through 53 batch norms to about 1e-5
#: of the logits (the loss 6.6e-6 apart, measured): they are held to
#: ``CARD_CPU_TOP_GRAD_RTOL`` (measured: 2.2e-5 at the fc weights).
CARD_CPU_F64_FACTOR = 2.0
CARD_CPU_TOP_GRAD_RTOL = 1e-4
RESNET_CARD_CPU_B = 2


def _resnet50_program(pt, B, dtype):
    """``resnet_train_program``'s ResNet-50 with its image in ``dtype``
    (the model's parameters take that dtype) and Momentum, in the name
    scope of ``_conv_program``, so both dtypes share parameter names."""
    from paddle_tpu_torch.framework import unique_name_scope
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    main.amp = False
    L = pt.layers
    with unique_name_scope("resnet50_"), pt.program_guard(main, startup):
        image = L.data(name="image", shape=[B, 3, 224, 224], dtype=dtype,
                       append_batch_size=False)
        label = L.data(name="label", shape=[B, 1], dtype="int64",
                       append_batch_size=False)
        predict = resnet.resnet_imagenet(image, 1000, depth=50)
        cost = L.mean(x=L.cross_entropy(input=predict, label=label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            cost)
    return main, startup, cost


def phase_card_vs_cpu_resnet50():
    """One float32 step of ResNet-50 at full width and depth (224x224,
    1000 classes), B = 2, TF32 off, Momentum(0.01, 0.9), from one scope,
    on the card and on the CPU (and once more on the CPU in float64).
    The loss is held to ``CARD_CPU_LOSS_RTOL``, the running batch-norm
    statistics to ``F32_TOL``, and every parameter's grad, read as its
    velocity (``0.9 * 0 + grad`` after one step), to the kink rule above
    ``CARD_CPU_TOP_GRAD_RTOL`` and ``CARD_CPU_F64_FACTOR``."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.kernels import ALL_KERNELS

    B = RESNET_CARD_CPU_B
    main, startup, cost = _resnet50_program(pt, B, "float32")
    main64, _, cost64 = _resnet50_program(pt, B, "float64")
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    names = persistable_names(main)
    state = {n: to_numpy(cpu_scope.find_var(n)) for n in names}
    card_scope = scope_from_numpy(state, None, main)
    f64_scope = scope_from_numpy(state, pt.CPUPlace(), main64)
    rng = np.random.RandomState(SEED % (2 ** 31) + 7)
    image = rng.rand(B, 3, 224, 224)
    label = rng.randint(0, 1000, (B, 1)).astype("int64")
    feed = {"image": image.astype("float32"), "label": label}
    block = main.global_block()
    ops = block.ops
    relus = [i for i, op in enumerate(ops) if op.type == "relu"]
    relu_in = [ops[i].input("X")[0] for i in relus]
    t = time.perf_counter()
    cpu_loss, *cpu_relu = cpu.run(main, feed=feed,
                                  fetch_list=[cost] + relu_in,
                                  scope=cpu_scope)
    cpu_s = time.perf_counter() - t
    cpu.run(main64, feed={"image": image, "label": label},
            fetch_list=[cost64], scope=f64_scope)
    for kern in ALL_KERNELS:
        kern.launches = 0
    card_loss, *card_relu = pt.Executor().run(
        main, feed=feed, fetch_list=[cost] + relu_in, scope=card_scope)
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    if launches:
        raise AssertionError(f"card-vs-cpu[resnet50]: launches {launches}")
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[resnet50]: loss {a} vs {b}")
    stats = [n for op in ops if op.type == "batch_norm"
             for n in op.input("Mean") + op.input("Variance")]
    stats_max = 0.0
    for n in stats:
        want = to_numpy(cpu_scope.find_var(n))
        got = to_numpy(card_scope.find_var(n))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"card-vs-cpu[resnet50]: {n}")
        stats_max = max(stats_max, float(np.abs(got - want).max()))
    # kinks, and the leaves whose grads pass no kinked ReLU
    kinked = [i for i, x, y in zip(relus, cpu_relu, card_relu)
              if ((x > 0) != (y > 0)).any()]
    kinks = sum(int(((x > 0) != (y > 0)).sum())
                for x, y in zip(cpu_relu, card_relu))
    last_kink = max(kinked, default=-1)
    seed_at = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                   and op.output("Out")[0] == cost.name + "@GRAD")
    above = {n for op in ops[last_kink + 1:seed_at]
             for n in op.input_arg_names}
    velocity = {op.input("Param")[0]: op.input("Velocity")[0]
                for op in ops if op.type == "momentum"}
    if set(velocity) != {p.name for p in block.all_parameters()}:
        raise AssertionError("card-vs-cpu[resnet50]: a parameter has no "
                             "momentum op")

    def leaf_rel(scope, ref):
        out = {}
        for p, v in velocity.items():
            want = to_numpy(ref.find_var(v)).astype(np.float64)
            got = to_numpy(scope.find_var(v)).astype(np.float64)
            norm = float(np.linalg.norm(want))
            if not norm > 0:
                raise AssertionError(f"card-vs-cpu[resnet50]: {p} got no "
                                     f"grad")
            out[p] = float(np.linalg.norm(got - want)) / norm
        return out

    rel = leaf_rel(card_scope, cpu_scope)
    card64 = leaf_rel(card_scope, f64_scope)
    cpu64 = leaf_rel(cpu_scope, f64_scope)
    strict = {p: r for p, r in rel.items() if p in above}
    worst = max(rel, key=rel.get)
    med = {k: float(np.median(list(d.values())))
           for k, d in (("card", card64), ("cpu", cpu64), ("rel", rel))}
    log(f"card-vs-cpu[resnet50] B={B} 224x224 f32: loss card {a!r} cpu {b!r}"
        f" (rel {abs(a - b) / abs(b):.2e}); {kinks} of "
        f"{sum(x.size for x in cpu_relu)} ReLU inputs on different sides of "
        f"0, in {len(kinked)} of {len(relus)} ReLU ops; grads (velocities) "
        f"|card - cpu| / |cpu| worst {rel[worst]:.3e} ({worst}), median "
        f"{med['rel']:.3e}; the {len(strict)} leaves above every kink: "
        f"worst {max(strict.values(), default=0.0):.3e}; from the CPU's "
        f"float64 step: card worst {max(card64.values()):.3e} median "
        f"{med['card']:.3e}, cpu worst {max(cpu64.values()):.3e} median "
        f"{med['cpu']:.3e}; running statistics max abs diff "
        f"{stats_max:.3e} over {len(stats)}; cpu step {cpu_s:.2f}s")
    bad = {p: r for p, r in strict.items() if r > CARD_CPU_TOP_GRAD_RTOL}
    if not strict or bad:
        raise AssertionError(f"card-vs-cpu[resnet50]: leaves above every "
                             f"kink {strict} (bound "
                             f"{CARD_CPU_TOP_GRAD_RTOL})")
    if max(card64.values()) > CARD_CPU_F64_FACTOR * max(cpu64.values()) \
            or med["card"] > CARD_CPU_F64_FACTOR * med["cpu"]:
        raise AssertionError(
            f"card-vs-cpu[resnet50]: the card's float32 grads lie farther "
            f"from float64 than {CARD_CPU_F64_FACTOR} x the CPU's: worst "
            f"{max(card64.values())} vs {max(cpu64.values())}, median "
            f"{med['card']} vs {med['cpu']}")
    return dict(loss_rel=abs(a - b) / abs(b), grad_rel=rel[worst],
                strict_rel=max(strict.values()), card_f64=med["card"],
                cpu_f64=med["cpu"], stats_max=stats_max, relu_kinks=kinks)


# ---------------------------------------------------------------------------
# Wide & Deep with sparse grads (SelectedRows), W&D-Criteo
# ---------------------------------------------------------------------------

#: W&D-Criteo (``models.wide_and_deep.CRITEO``): 13 dense and 26
#: categorical features, embeddings of 32, ReLU layers of 1024, one
#: shared table of 2**23 rows (1 GiB, 3 GiB with Adam's moments), B =
#: 4096, float32, ``Adam(1e-3)``; its ids (``fake_batch``) lie below
#: 2**20, so the same ids also train a table of 2**20 rows (the
#: sparse-update scaling line)
WD_LR = 1e-3
WD_STEPS = 10
WD_COMPARE_STEPS = 4
#: graphed against eager W&D steps from one state: the largest parameter
#: difference allowed after ``WD_STEPS`` steps where they are not equal
#: (an Adam step moves a parameter by about the learning rate, 1e-3)
WD_GRAPH_ATOL = 1e-6
#: the card-vs-CPU step: the same layout and batch at a vocab the CPU
#: takes in a second
WD_CARD_CPU_VOCAB = 65536


def _launch_counts():
    from paddle_tpu_torch.kernels import ALL_KERNELS
    return {k.name: k.launches for k in ALL_KERNELS if k.launches}


def _no_launches(where):
    launches = _launch_counts()
    if launches:
        raise AssertionError(f"{where}: hand-written kernels launched: "
                             f"{launches}")


#: every CUDA graph of the paths' executors (``Executor.graph_stats``), by
#: path: the ``{"graphs": [...]}`` line
GRAPHS = []


def _graphs(path, exe, expect):
    """Record ``exe``'s CUDA graphs under ``path`` and return their
    replays.  ``expect=True``: the path must have run as a graph (a
    replay); False: it must have none (the capture rule keeps its blocks
    eager); None: either."""
    stats = exe.graph_stats()
    GRAPHS.extend({"path": path, **{k: s[k] for k in (
        "signature", "captures", "replays", "seconds", "nodes",
        "pool_gib")}} for s in stats)
    replays = sum(s["replays"] for s in stats)
    if expect is True and not replays:
        raise AssertionError(f"{path}: no CUDA graph replayed ({stats})")
    if expect is False and stats:
        raise AssertionError(f"{path}: {len(stats)} CUDA graphs, but the "
                             f"capture rule keeps the path eager")
    return replays


def _wd_program(pt, vocab, sparse=True):
    """``(main, startup, cost)``: ``wide_and_deep_train_program`` at
    W&D-Criteo's widths and ``vocab`` rows, ``Adam(WD_LR)``; with
    ``sparse=False`` both tables take dense grads (``is_sparse`` off on
    their lookups before the backward is built)."""
    from paddle_tpu_torch.framework import unique_name_scope
    from paddle_tpu_torch.models import wide_and_deep as W
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name_scope("wd_"), pt.program_guard(main, startup):
        cost, _, _ = W.wide_and_deep_train_program(
            W.CRITEO_BATCH, **dict(W.CRITEO, vocab_size=vocab))
        for op in main.global_block().ops:
            if op.type == "lookup_table":
                op.attrs["is_sparse"] = sparse
        pt.optimizer.Adam(learning_rate=WD_LR).minimize(cost)
    return main, startup, cost


def _timed_steps(exe, main, cost, scope, feed, steps):
    """``steps`` runs on one batch: losses, step seconds (host clock; the
    loss's fetch synchronizes) and each step's peak allocation above
    what was allocated just before it, in bytes."""
    import numpy as np
    import torch
    losses, step_s, peaks = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        losses.append(float(np.asarray(loss).reshape(())))
    return losses, step_s, peaks


def _wd_table_grads(pt, main, scope, feed, device):
    """Run the main block once through ``lower_block`` with an env of its
    own (one more training step) and return ``{table: its grad as it
    reaches adam}`` and the names of the non-persistable tensors with a
    leading dim of the vocab (a dense table grad would be one)."""
    import torch
    from paddle_tpu_torch.convert import persistable_names, to_tensor
    from paddle_tpu_torch.executor import lower_block
    block = main.global_block()
    persist = persistable_names(main)
    env = {n: scope.find_var(n) for n in persist}
    env.update({k: to_tensor(v, device, block.var(k).dtype)
                for k, v in feed.items()})
    with torch.no_grad():
        lower_block(block, env, {"device": device, "amp": False,
                                 "rng_seed": SEED})
    grads = {op.input("Param")[0]: env[op.input("Grad")[0]]
             for op in block.ops if op.type == "adam"}
    vocab = block.var("wide_deep_emb").shape[0]
    dense = [n for n, v in env.items() if n not in persist and
             isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == vocab]
    return {t: grads[t] for t in ("wide_deep_emb", "wide_lr_w")}, dense


def phase_wide_deep():
    """W&D-Criteo trains on the card through ``wide_and_deep_train_program``,
    ``Adam.minimize`` and ``Executor.run``, ``WD_STEPS`` steps on one
    seeded batch: the loss finite and falling, no hand-written kernel
    launched (the sparse updates are torch indexing ops), both tables'
    grads SelectedRows of B * slots slots at height vocab (never a dense
    ``[vocab, dim]`` tensor), and a steady step's peak allocation above
    the state under the deep table's bytes (a densified grad or an
    out-of-place table or moment update would each exceed it).  Every
    route's step is a CUDA graph (the SelectedRows keep their static
    slot count); the sparse route's ``WD_STEPS`` steps run again eagerly
    (a clone with ``_opt_interpret``) from the same startup state: the
    losses and every persistable equal, or within ``WD_GRAPH_ATOL``.
    Printed: steady step ms graphed and eager, examples/s, peak memory,
    unique rows a step, the same ids' sparse step at a table of 2**20
    rows and the dense route (``is_sparse=False``) at 2**23 for
    comparison."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.opt import clone_program
    from paddle_tpu_torch.convert import persistable_names
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import wide_and_deep as W
    from paddle_tpu_torch.selected_rows import SelectedRows

    B, slots, emb = W.CRITEO_BATCH, W.CRITEO["num_slots"], W.CRITEO["emb_dim"]
    vocab_max = W.CRITEO["vocab_size"]

    exe = pt.Executor()
    if exe.device != torch.device("cuda", 0):
        raise AssertionError(f"Executor landed on {exe.device}")
    feed = W.fake_batch(B, SEED)
    unique_rows = int(np.unique(feed["slot_ids"]).size)
    table_bytes = vocab_max * emb * 4
    out = {"unique_rows": unique_rows, "ids": B * slots}

    for kern in ALL_KERNELS:
        kern.launches = 0
    for name, vocab, sparse, steps in (
            ("sparse", vocab_max, True, WD_STEPS),
            ("sparse_2**20", W.FAKE_ID_RANGE, True, WD_COMPARE_STEPS),
            ("dense", vocab_max, False, WD_COMPARE_STEPS)):
        main, startup, cost = _wd_program(pt, vocab, sparse)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        state_gib = torch.cuda.memory_allocated() / 2 ** 30
        scope0 = _scope_copy(pt, scope) if name == "sparse" else None
        losses, step_s, peaks = _timed_steps(exe, main, cost, scope, feed,
                                          steps)
        _no_launches(f"wide_deep[{name}]")
        # every route runs as a CUDA graph: the SelectedRows keep their
        # static slot count and nothing is read on the host
        if exe._last_compiled.interpret:
            raise AssertionError(f"wide_deep[{name}]: the capture rule kept "
                                 f"the step eager")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"wide_deep[{name}]: losses {losses} not "
                                 f"finite and falling")
        steady = _steady(step_s, True)
        peak = max(peaks[1:])
        out[name] = dict(step_ms=1e3 * steady,
                         examples_per_s=B / steady,
                         peak_above_state_gib=peak / 2 ** 30,
                         state_gib=state_gib, losses=losses)
        log(f"wide_deep[{name}]: vocab {vocab} B={B} slots={slots} "
            f"emb={emb} hidden={W.CRITEO['hidden']}: losses "
            f"{[round(x, 6) for x in losses]}; step ms "
            f"{[round(1e3 * x, 3) for x in step_s]}; steady {1e3 * steady:.3f}"
            f" ms = {B / steady:.1f} examples/s; state "
            f"{state_gib:.3f} GiB; a step's peak above it "
            f"{[round(x / 2 ** 30, 4) for x in peaks]} GiB")
        if name == "sparse":
            if peak >= table_bytes:
                raise AssertionError(
                    f"wide_deep: a steady step allocates {peak} bytes above "
                    f"the state, not under the deep table's {table_bytes}")
            # before _wd_table_grads, which takes one more step
            out["eager"] = _wd_graph_vs_eager(
                pt, main, cost, scope, scope0, feed, losses, steady,
                clone_program, persistable_names)
            del scope0
            grads, dense = _wd_table_grads(pt, main, scope, feed,
                                           exe.device)
            for table, g in grads.items():
                if not isinstance(g, SelectedRows) or \
                        g.rows.numel() != B * slots or \
                        g.height != vocab_max or \
                        g.value.device != exe.device:
                    raise AssertionError(
                        f"wide_deep: {table}'s grad is {type(g).__name__} "
                        f"{getattr(g, 'shape', None)}, not SelectedRows of "
                        f"{B * slots} slots at height {vocab_max}")
            if dense:
                raise AssertionError(f"wide_deep: vocab-sized tensors {dense}"
                                     f" beside the state")
            log(f"wide_deep: both tables' grads reach adam as SelectedRows "
                f"of {B * slots} slots at height {vocab_max} "
                f"({unique_rows} unique rows); the peak above the state "
                f"{peak / 2 ** 30:.4f} GiB < the deep table's "
                f"{table_bytes / 2 ** 30:.2f} GiB; peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        del main, startup, scope
        torch.cuda.empty_cache()
    _graphs("wide_deep", exe, True)
    del exe
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = phase_card_vs_cpu_wide_deep()
    _no_launches("wide_deep[card-vs-cpu]")
    return out


def _wd_graph_vs_eager(pt, main, cost, scope, scope0, feed, losses, steady,
                       clone_program, persistable_names):
    """The sparse W&D-Criteo route's ``WD_STEPS`` steps again, eagerly (a
    clone of ``main`` with ``_opt_interpret``), from ``scope0``, the
    startup state the graphed run in ``scope`` began from: the losses and
    every persistable equal, or within ``WD_GRAPH_ATOL``.  Returns the
    eager steady ms, whether all is bit-identical and the largest
    difference."""
    import numpy as np
    import torch
    eager = clone_program(main)
    eager._opt_interpret = True
    exe = pt.Executor()
    e_losses, e_step_s, _ = _timed_steps(exe, eager, cost, scope0, feed,
                                         len(losses))
    if not exe._last_compiled.interpret or exe.graph_stats():
        raise AssertionError("wide_deep[eager]: the clone ran as a graph")
    worst, worst_name, identical = 0.0, None, e_losses == losses
    for n in sorted(persistable_names(main)):
        a, b = scope.find_var(n), scope0.find_var(n)
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            continue
        identical = identical and bool(torch.equal(a, b))
        d = float((a - b).abs().max()) if a.numel() else 0.0
        if d > worst:
            worst, worst_name = d, n
    loss_d = max(abs(x - y) for x, y in zip(losses, e_losses))
    e_steady = _steady(e_step_s, False)
    log(f"wide_deep[graph vs eager]: {len(losses)} steps from one state: "
        f"bit-identical {identical}; losses graphed {losses} eager "
        f"{e_losses} (max |d| {loss_d:.3e}); largest persistable "
        f"|graph - eager| {worst:.3e} ({worst_name}, bound "
        f"{WD_GRAPH_ATOL}); steady step ms graphed {1e3 * steady:.3f} vs "
        f"eager {1e3 * e_steady:.3f}")
    if not identical and (worst > WD_GRAPH_ATOL or loss_d > WD_GRAPH_ATOL):
        raise AssertionError(f"wide_deep: graphed and eager steps part by "
                             f"{worst} ({worst_name}), losses by {loss_d}")
    del exe, eager
    return dict(step_ms=1e3 * e_steady, bit_identical=identical,
                max_abs_diff=worst, losses=e_losses)


def _adam_first_step_errors(tag, adam, card_scope, cpu_scope, lr):
    """After one Adam step from one state on the card and on the CPU:
    ``|card - cpu| / |cpu|`` (2-norms) of each parameter's two moments,
    the second halved (it squares the grad), by ``(param, slot)``; and
    each parameter's worst element ``|dp|`` over what its grad's
    difference allows (see ``phase_card_vs_cpu_wide_deep``), by param."""
    import numpy as np
    from paddle_tpu_torch.convert import to_numpy
    beta1, beta2 = adam[0].attr("beta1"), adam[0].attr("beta2")
    slope = lr * np.sqrt(1.0 - beta2) / adam[0].attr("epsilon")
    eps32 = float(np.finfo(np.float32).eps)
    rel, p_ratio = {}, {}
    for op in adam:
        p = op.input("Param")[0]
        got, want = ({n: to_numpy(s.find_var(op.input(n)[0])).astype(
            np.float64) for n in ("Param", "Moment1", "Moment2")}
            for s in (card_scope, cpu_scope))
        for slot, factor in (("Moment1", 1.0), ("Moment2", 2.0)):
            norm = float(np.linalg.norm(want[slot]))
            if not norm > 0:
                raise AssertionError(f"card-vs-cpu[{tag}]: {p} got no grad")
            rel[(p, slot)] = float(np.linalg.norm(
                got[slot] - want[slot])) / norm / factor
        # the grads as the first moments hold them, within one rounding
        # of each moment
        dg = (np.abs(got["Moment1"] - want["Moment1"])
              + 2 * eps32 * np.abs(want["Moment1"])) / (1.0 - beta1)
        allow = slope * dg + 4 * eps32 * (np.abs(want["Param"]) + lr)
        p_ratio[p] = float((np.abs(got["Param"] - want["Param"])
                            / allow).max())
    return rel, p_ratio


def phase_card_vs_cpu_wide_deep():
    """One float32 W&D-Criteo step at ``WD_CARD_CPU_VOCAB`` rows, from one
    scope, on the card and on the CPU.  The loss (computed before the
    update) is held to ``CARD_CPU_LOSS_RTOL``; every parameter's grad,
    read as its first Adam moment (``(1 - beta1) * grad``), and its second
    moment to the kink rule of ``phase_card_vs_cpu``
    (``CARD_CPU_GRAD_RTOL`` of its norm, ``CARD_CPU_KINK_GRAD_RTOL`` when
    a ReLU input lies on different sides of 0; the second moment twice
    that: it squares the grad), both tables' included: their duplicate
    rows sum in another order on the card.  Every parameter element is
    held to what its grad's difference allows: Adam's first step moves
    it by ``lr * g / (|g| + eps / sqrt(1 - beta2))``, whose slope is at
    most ``lr * sqrt(1 - beta2) / eps``, so ``|dp| <= that * |dg|`` (``dg``
    read from the first moments, plus one rounding of each) plus four
    float32 roundings of ``|p| + lr``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.models import wide_and_deep as W

    main, startup, cost = _wd_program(pt, WD_CARD_CPU_VOCAB)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    names = persistable_names(main)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n)) for n in names}, None, main)
    feed = W.fake_batch(W.CRITEO_BATCH, SEED + 5, WD_CARD_CPU_VOCAB)
    block = main.global_block()
    relu_in = [op.input("X")[0] for op in block.ops if op.type == "relu"]
    t = time.perf_counter()
    cpu_loss, *cpu_relu = cpu.run(main, feed=feed,
                                  fetch_list=[cost] + relu_in,
                                  scope=cpu_scope)
    cpu_s = time.perf_counter() - t
    card_loss, *card_relu = pt.Executor().run(
        main, feed=feed, fetch_list=[cost] + relu_in, scope=card_scope)
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[wide_deep]: loss {a} vs {b}")
    kinks = sum(int(((x > 0) != (y > 0)).sum())
                for x, y in zip(cpu_relu, card_relu))
    bound = CARD_CPU_KINK_GRAD_RTOL if kinks else CARD_CPU_GRAD_RTOL
    adam = [op for op in block.ops if op.type == "adam"]
    if {op.input("Param")[0] for op in adam} != \
            {p.name for p in block.all_parameters()}:
        raise AssertionError("card-vs-cpu[wide_deep]: a parameter has no "
                             "adam op")
    rel, p_ratio = _adam_first_step_errors("wide_deep", adam, card_scope,
                                           cpu_scope, WD_LR)
    worst = max(rel, key=rel.get)
    worst_p = max(p_ratio, key=p_ratio.get)
    log(f"card-vs-cpu[wide_deep] vocab {WD_CARD_CPU_VOCAB} B={W.CRITEO_BATCH} "
        f"f32:"
        f" loss card {a!r} cpu {b!r} (rel {abs(a - b) / abs(b):.2e}); "
        f"{kinks} of {sum(x.size for x in cpu_relu)} ReLU inputs on "
        f"different sides of 0; moments |card - cpu| / |cpu| (the second "
        f"halved) worst {rel[worst]:.3e} ({worst}), tables "
        + ", ".join(f"{k}={v:.3e}" for k, v in rel.items()
                    if k[0] in ("wide_deep_emb", "wide_lr_w"))
        + f"; parameters |dp| / allowed worst {p_ratio[worst_p]:.3e} "
        f"({worst_p}); cpu step {cpu_s:.2f}s")
    if rel[worst] > bound:
        raise AssertionError(f"card-vs-cpu[wide_deep]: {worst} differs by "
                             f"{rel[worst]} relative (bound {bound}, "
                             f"{kinks} ReLU inputs straddle 0)")
    if p_ratio[worst_p] > 1.0:
        raise AssertionError(f"card-vs-cpu[wide_deep]: parameter {worst_p} "
                             f"moved {p_ratio[worst_p]} x what its grad's "
                             f"difference allows")
    return dict(loss_rel=abs(a - b) / abs(b), moment_rel=rel[worst],
                param_ratio=p_ratio[worst_p], relu_kinks=kinks)


# ---------------------------------------------------------------------------
# LoD sequences: the stacked dynamic LSTM (LSTM-IMDB-H512) and the
# sentiment book's two nets
# ---------------------------------------------------------------------------

#: LSTM-IMDB-H512 (``models.stacked_lstm.BENCHMARK_LSTM``): the
#: reference's stacked dynamic LSTM benchmark (IMDB sentiment, 2 LSTM
#: layers with peepholes, dictionary 30000, sequences of 2 ... 100 words,
#: 64 a batch) at a hidden width of 512, float32, ``Adam(1e-3)``
LSTM_STEPS = 20
LSTM_RAGGED_STEPS = 10
#: the card-vs-CPU step: the same net at a width the CPU takes in a second
LSTM_CARD_CPU = dict(dict_size=1000, emb_dim=32, hidden_dim=32, batch=8,
                     max_len=12)
#: ``tests/test_book_understand_sentiment.py``'s nets at its widths: its
#: vocabulary's size, embeddings and hidden of 32, 16 sequences of 24
#: words a batch, ``Adam(2e-3)``
BOOK = dict(dict_dim=5147, emb=32, hid=32, clip_len=24, batch=16, lr=2e-3)
BOOK_STEPS = 8


def _lstm_program(pt, cfg):
    """``(main, startup, cost)``: ``stacked_lstm_net`` at ``cfg``'s widths
    and ``Adam(cfg["lr"])``."""
    from paddle_tpu_torch.framework import unique_name_scope
    from paddle_tpu_torch.models import stacked_lstm as TS
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name_scope("lstm_"), pt.program_guard(main, startup):
        cost, _, _ = TS.stacked_lstm_net(
            cfg["dict_size"], cfg["emb_dim"], cfg["hidden_dim"],
            cfg["n_layers"], cfg["class_num"])
        pt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
    return main, startup, cost


def _lstm_lods(pt, main, scope, feed, device):
    """Run the main block once through ``lower_block`` with an env of its
    own (one more training step) and return each ``lstm``'s ``Hidden``
    LoD and the pooled features (the ``concat`` of the last and the max
    steps)."""
    import torch
    from paddle_tpu_torch.convert import persistable_names, to_tensor
    from paddle_tpu_torch.executor import lower_block
    block = main.global_block()
    env = {n: scope.find_var(n) for n in persistable_names(main)}
    words, lod = feed["words"]
    env["words"] = to_tensor(words, device, "int64")
    env["label"] = to_tensor(feed["label"], device, "int64")
    aux = {"device": device, "amp": False, "rng_seed": SEED,
           "lod": {"words": lod}}
    with torch.no_grad():
        lower_block(block, env, aux)
    hidden = [aux["lod"].get(op.output("Hidden")[0])
              for op in block.ops if op.type == "lstm"]
    concat = next(op for op in block.ops if op.type == "concat")
    return hidden, env[concat.output("Out")[0]]


def phase_stacked_lstm():
    """LSTM-IMDB-H512 trains on the card through ``stacked_lstm_net``,
    ``Adam.minimize`` and ``Executor.run`` fed ``(words, lod)``:
    ``LSTM_STEPS`` steps on one seeded batch (loss finite and falling),
    then ``LSTM_RAGGED_STEPS`` steps each on a fresh batch with new
    lengths (every loss finite, the scope holding each step's LoD), no
    hand-written kernel launched (the LSTM and sequence ops are torch
    ops).  After them one more step through ``lower_block``: each
    ``lstm``'s ``Hidden`` carries the feed's LoD and the pooled features
    are ``[B, 2 * hidden]`` on the card.  Printed: the steady step's ms
    and sequences/s (steps 2 ... of the fixed batch), the rows a step,
    the peak allocation, and the card-vs-CPU step
    (``phase_card_vs_cpu_stacked_lstm``)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import stacked_lstm as TS

    cfg = TS.BENCHMARK_LSTM
    B, L, V, H = (cfg["batch"], cfg["max_len"], cfg["dict_size"],
                  cfg["hidden_dim"])
    exe = pt.Executor()
    if exe.device != torch.device("cuda", 0):
        raise AssertionError(f"Executor landed on {exe.device}")
    main, startup, cost = _lstm_program(pt, cfg)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    feed = TS.fake_batch(B, L, V, seed=SEED)
    rows = int(feed["words"][0].shape[0])
    for kern in ALL_KERNELS:
        kern.launches = 0
    losses, step_s, peaks = _timed_steps(exe, main, cost, scope, feed,
                                         LSTM_STEPS)
    _no_launches("stacked_lstm")
    _graphs("stacked_lstm", exe, False)    # LoD tables: eager
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"stacked_lstm: losses {losses} not finite and "
                             f"falling")
    steady = float(np.mean(step_s[1:]))
    ragged_losses, ragged_s, lods = [], [], set()
    for i in range(LSTM_RAGGED_STEPS):
        f = TS.fake_batch(B, L, V, seed=SEED + 1 + i)
        lods.add(tuple(f["words"][1][0]))
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=f, fetch_list=[cost], scope=scope)
        ragged_s.append(time.perf_counter() - t)
        ragged_losses.append(float(np.asarray(loss).reshape(())))
        if scope.find_lod("words") != f["words"][1]:
            raise AssertionError(f"stacked_lstm: ragged step {i}: the scope "
                                 f"holds LoD {scope.find_lod('words')}")
    _no_launches("stacked_lstm ragged steps")
    if not all(np.isfinite(ragged_losses)) or \
            len(lods) != LSTM_RAGGED_STEPS:
        raise AssertionError(f"stacked_lstm: ragged losses {ragged_losses} "
                             f"over {len(lods)} distinct LoDs")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hidden, feat = _lstm_lods(pt, main, scope, feed, exe.device)
    _no_launches("stacked_lstm lower_block step")
    if len(hidden) != cfg["n_layers"] or \
            any(h != feed["words"][1] for h in hidden):
        raise AssertionError(f"stacked_lstm: lstm Hidden LoDs {hidden}")
    if tuple(feat.shape) != (B, 2 * H) or feat.device != exe.device:
        raise AssertionError(f"stacked_lstm: pooled features "
                             f"{tuple(feat.shape)} on {feat.device}")
    log(f"stacked_lstm[LSTM-IMDB-H512]: dict {V} emb {cfg['emb_dim']} "
        f"hidden {H} x {cfg['n_layers']} layers (peepholes) B={B} lengths "
        f"2..{L} ({rows} rows, T {max(np.diff(feed['words'][1][0]))}): "
        f"losses {[round(x, 6) for x in losses]}; step ms "
        f"{[round(1e3 * x, 3) for x in step_s]}; steady {1e3 * steady:.3f} "
        f"ms = {B / steady:.2f} sequences/s = {rows / steady:.1f} rows/s; "
        f"state {state_gib:.3f} GiB, peak allocated {peak_gib:.3f} GiB, a "
        f"step's peak above the state "
        f"{[round(x / 2 ** 30, 4) for x in peaks]} GiB")
    log(f"stacked_lstm: {LSTM_RAGGED_STEPS} ragged steps, each a new LoD: "
        f"losses {[round(x, 6) for x in ragged_losses]}, step ms "
        f"{[round(1e3 * x, 3) for x in ragged_s]}; every lstm's Hidden "
        f"carries the feed's LoD, pooled features {tuple(feat.shape)} on "
        f"{feat.device}")
    out = dict(step_ms=1e3 * steady, sequences_per_s=B / steady,
               rows_per_step=rows, peak_gib=peak_gib, state_gib=state_gib,
               losses=losses, ragged_step_ms=1e3 * float(np.mean(ragged_s)))
    del main, startup, scope
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = phase_card_vs_cpu_stacked_lstm()
    _no_launches("stacked_lstm card-vs-cpu")
    return out


def phase_card_vs_cpu_stacked_lstm():
    """One float32 Adam step of ``stacked_lstm_net`` at ``LSTM_CARD_CPU``
    (emb and hidden 32, 8 sequences of 2 ... 12 words), from one scope, on
    the card and on the CPU.  The loss is held to ``CARD_CPU_LOSS_RTOL``,
    every parameter's moments to ``CARD_CPU_GRAD_RTOL`` (summation order
    alone: tanh and sigmoid have no kink; a max pool whose two largest
    rows lie within rounding would move a grad, which this seed's batch
    has not), every parameter element to what its grad's difference
    allows (``_adam_first_step_errors``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.models import stacked_lstm as TS

    cfg = dict(TS.BENCHMARK_LSTM, **LSTM_CARD_CPU)
    main, startup, cost = _lstm_program(pt, cfg)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n))
         for n in persistable_names(main)}, None, main)
    feed = TS.fake_batch(cfg["batch"], cfg["max_len"], cfg["dict_size"],
                         seed=SEED + 7)
    (cpu_loss,) = cpu.run(main, feed=feed, fetch_list=[cost],
                          scope=cpu_scope)
    (card_loss,) = pt.Executor().run(main, feed=feed, fetch_list=[cost],
                                     scope=card_scope)
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    block = main.global_block()
    adam = [op for op in block.ops if op.type == "adam"]
    if {op.input("Param")[0] for op in adam} != \
            {p.name for p in block.all_parameters()}:
        raise AssertionError("card-vs-cpu[stacked_lstm]: a parameter has "
                             "no adam op")
    rel, p_ratio = _adam_first_step_errors("stacked_lstm", adam, card_scope,
                                           cpu_scope, cfg["lr"])
    worst = max(rel, key=rel.get)
    worst_p = max(p_ratio, key=p_ratio.get)
    log(f"card-vs-cpu[stacked_lstm] emb/hidden {cfg['hidden_dim']} "
        f"B={cfg['batch']} lengths 2..{cfg['max_len']} f32: loss card {a!r} "
        f"cpu {b!r} (rel {abs(a - b) / abs(b):.2e}, bound "
        f"{CARD_CPU_LOSS_RTOL}); moments |card - cpu| / |cpu| (the second "
        f"halved) worst {rel[worst]:.3e} ({worst}, bound "
        f"{CARD_CPU_GRAD_RTOL}); parameters |dp| / allowed worst "
        f"{p_ratio[worst_p]:.3e} ({worst_p}, bound 1)")
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[stacked_lstm]: loss {a} vs {b}")
    if rel[worst] > CARD_CPU_GRAD_RTOL:
        raise AssertionError(f"card-vs-cpu[stacked_lstm]: {worst} differs "
                             f"by {rel[worst]} relative")
    if p_ratio[worst_p] > 1.0:
        raise AssertionError(f"card-vs-cpu[stacked_lstm]: parameter "
                             f"{worst_p} moved {p_ratio[worst_p]} x what its "
                             f"grad's difference allows")
    return dict(loss_rel=abs(a - b) / abs(b), moment_rel=rel[worst],
                param_ratio=p_ratio[worst_p])


#: the bucketed LoD mode at LSTM-IMDB-H512: ``bench_lstm.py``'s windows
#: of ``WINDOW`` fresh batches, each one ``run_steps``; the last window
#: repeats the first, whose loss must then be lower
LSTM_WINDOW = 16
LSTM_WINDOWS = 2
#: a float32 loss of two runs whose only difference is the order of
#: float atomic adds (the embedding's grad) or of a matrix product over
#: another row count (the bucketed rows): relative, per step
BUCKET_LOSS_RTOL = 1e-5


def _lstm_windows(cfg):
    """``LSTM_WINDOWS`` windows of ``LSTM_WINDOW`` fresh ``fake_batch``es,
    and the first once more: ``[(feed of run_steps, batches)]``."""
    import numpy as np
    from paddle_tpu_torch.models import stacked_lstm as TS
    windows = [[TS.fake_batch(cfg["batch"], cfg["max_len"],
                              cfg["dict_size"], seed=SEED + 100 * w + i)
                for i in range(LSTM_WINDOW)] for w in range(LSTM_WINDOWS)]
    windows.append(windows[0])
    return [({"words": [b["words"] for b in w],
              "label": np.stack([b["label"] for b in w])}, w)
            for w in windows]


def _bucket_pairs(batches, name):
    """The ``(n_bucket, t_bucket)`` of ``name`` a window pads to."""
    import numpy as np
    from paddle_tpu_torch.lod import next_bucket
    rows = max(b[name][0].shape[0] for b in batches)
    maxlen = max(int(np.diff(b[name][1][0]).max()) for b in batches)
    return next_bucket(rows), next_bucket(maxlen)


def _window_run(pt, program, cost, scope, windows):
    """Every window through one ``run_steps`` on a fresh executor: the
    executor, the float32 losses, each window's seconds (host clock; the
    stacked fetch synchronizes) and the step cache's misses."""
    import numpy as np
    from paddle_tpu_torch.profiler import runtime_metrics
    exe = pt.Executor()
    misses0 = runtime_metrics.counter("jit_cache.misses")
    losses, window_s = [], []
    for feed, batches in windows:
        t = time.perf_counter()
        (out,) = exe.run_steps(program, feed=feed, fetch_list=[cost],
                               steps=len(batches), scope=scope)
        window_s.append(time.perf_counter() - t)
        losses += [np.float32(x) for x in np.asarray(out).reshape(-1)]
    return exe, losses, window_s, \
        runtime_metrics.counter("jit_cache.misses") - misses0


def phase_stacked_lstm_buckets():
    """LSTM-IMDB-H512 in the bucketed LoD mode (``main.lod_buckets``):
    ``bench_lstm.py``'s path, windows of ``LSTM_WINDOW`` fresh batches,
    each window one ``run_steps`` (every batch padded to the window's
    row and length buckets, the splits fed as ``words@lod0``), the last
    window the first one again.  From one startup state, three runs: the
    default path, where the step is a CUDA graph (first step eager,
    second captured, then replays), and the eager step (a clone with
    ``_opt_interpret``) twice; the graphed losses of the fresh windows
    within ``BUCKET_LOSS_RTOL`` of the eager ones, step by step (the
    repeated window's differences printed beside two eager runs'); the
    step cache missed no more often than the windows reach distinct
    bucket pairs; every loss finite and the repeated window's mean below
    its first pass's.  Then one bucketed
    step against one static-LoD step on the same state and batch: the
    losses within ``BUCKET_LOSS_RTOL``.  No hand-written kernel.
    Printed: ms a batch graphed and eager (windows after the first),
    capture seconds, graph nodes, peak allocated GiB."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.opt import clone_program
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import stacked_lstm as TS

    cfg = TS.BENCHMARK_LSTM
    main, startup, cost = _lstm_program(pt, cfg)
    main.lod_buckets = True
    eager = clone_program(main)
    eager.lod_buckets = True
    eager._opt_interpret = True
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    windows = _lstm_windows(cfg)
    pairs = {_bucket_pairs(w, "words") for _, w in windows}
    for kern in ALL_KERNELS:
        kern.launches = 0
    runs = {}

    def one(mode):
        program = main if mode == "graph" else eager
        scope = _scope_copy(pt, scope0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exe, losses, window_s, misses = _window_run(pt, program, cost,
                                                    scope, windows)
        stats = exe.graph_stats()
        runs[mode] = dict(
            losses=losses, misses=misses,
            ms_per_batch=1e3 * float(np.mean(window_s[1:])) / LSTM_WINDOW,
            first_window_s=window_s[0],
            peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            capture_s=sum(s["seconds"] for s in stats),
            nodes=[s["nodes"] for s in stats])
        _graphs(f"stacked_lstm_buckets_{mode}", exe, mode == "graph")
        if misses > len(pairs):
            raise AssertionError(
                f"stacked_lstm_buckets[{mode}]: {misses} cache misses for "
                f"the bucket pairs {sorted(pairs)}")
        del exe, scope

    one("graph")
    one("eager")
    one("eager2")
    _no_launches("stacked_lstm_buckets")
    graph, base = runs["graph"], runs["eager"]
    identical = graph["losses"] == base["losses"]
    # a step with float atomic adds is not deterministic, and the
    # repeated window, where the loss falls steeply, amplifies run-to-run
    # differences (two eager runs parted there by 7% on an H100 while the
    # embedding's grad still summed by atomic adds).  So the graph is
    # held to the eager step over the fresh windows, and to a falling
    # loss over the repeated one; all steps' differences are printed
    rel = _loss_rel(base["losses"], graph["losses"])
    spread = max(_loss_rel(base["losses"], runs["eager2"]["losses"]))
    fresh = LSTM_WINDOWS * LSTM_WINDOW
    rel_fresh = max(rel[:fresh])
    if rel_fresh > BUCKET_LOSS_RTOL:
        raise AssertionError(
            f"stacked_lstm_buckets: graphed losses {graph['losses']} "
            f"against eager {base['losses']} (rel {rel_fresh} over the "
            f"first {fresh} steps, bound {BUCKET_LOSS_RTOL})")
    rel = max(rel)
    losses = graph["losses"]
    first = float(np.mean(losses[:LSTM_WINDOW]))
    again = float(np.mean(losses[-LSTM_WINDOW:]))
    if not all(np.isfinite(losses)) or not again < first:
        raise AssertionError(f"stacked_lstm_buckets: losses {losses}: the "
                             f"repeated window's mean {again} against its "
                             f"first pass's {first}")
    # one bucketed and one static-LoD step from one state on one batch
    static = clone_program(main)
    static.lod_buckets = False
    feed = windows[0][1][0]
    step = {}
    for name, program in (("bucketed", main), ("static", static)):
        (loss,) = pt.Executor().run(program, feed=feed, fetch_list=[cost],
                                    scope=_scope_copy(pt, scope0))
        step[name] = float(np.asarray(loss).reshape(()))
    step_rel = abs(step["bucketed"] - step["static"]) / abs(step["static"])
    if not step_rel <= BUCKET_LOSS_RTOL:
        raise AssertionError(f"stacked_lstm_buckets: bucketed step loss "
                             f"{step['bucketed']!r} against static "
                             f"{step['static']!r}")
    _no_launches("stacked_lstm_buckets static step")
    log(f"stacked_lstm_buckets[LSTM-IMDB-H512]: {LSTM_WINDOWS} + 1 windows "
        f"of {LSTM_WINDOW} batches (the last the first again), buckets "
        f"(rows, length) {sorted(pairs)}; losses graphed "
        f"{[float(x) for x in losses]}; "
        f"bit-identical to eager: {identical} (rel max {rel_fresh:.3e} over "
        f"the fresh windows, bound {BUCKET_LOSS_RTOL}; {rel:.3e} over all, "
        f"two eager runs {spread:.3e}); repeated window mean {again:.6f} "
        f"against "
        f"{first:.6f}; ms a batch graphed {graph['ms_per_batch']:.3f} vs "
        f"eager {base['ms_per_batch']:.3f} (first window "
        f"{graph['first_window_s']:.2f} / {base['first_window_s']:.2f} s); "
        f"capture {graph['capture_s']:.3f} "
        f"s, nodes {graph['nodes']}; cache misses {graph['misses']} / "
        f"{base['misses']}; peak allocated {graph['peak_allocated_gib']:.3f} "
        f"/ {base['peak_allocated_gib']:.3f} GiB; one step bucketed "
        f"{step['bucketed']!r} vs static {step['static']!r} (rel "
        f"{step_rel:.3e}, bound {BUCKET_LOSS_RTOL})")
    out = {"bit_identical": identical, "loss_rel_fresh": rel_fresh,
           "loss_rel_max": rel, "eager_spread": spread,
           "static_step_rel": step_rel,
           "buckets": sorted(pairs), "losses": [float(x) for x in losses]}
    for mode in ("graph", "eager"):
        r = runs[mode]
        out[mode] = {k: r[k] for k in ("ms_per_batch", "first_window_s",
                                       "peak_allocated_gib", "capture_s",
                                       "nodes", "misses")}
    del runs, scope0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _book_net(pt, name):
    """``tests/test_book_understand_sentiment.py``'s ``_convolution_net``
    (``name`` "conv") or ``_stacked_lstm_net`` ("stacked_lstm": 3 layers,
    ``is_reverse`` on the even ones, no peepholes) in the port, at
    ``BOOK``'s widths; returns the mean cost."""
    layers = pt.layers
    data = layers.data(name="words", shape=[-1, 1], dtype="int64",
                       append_batch_size=False, lod_level=1)
    label = layers.data(name="label", shape=[-1, 1], dtype="int64",
                        append_batch_size=False)
    emb = layers.embedding(input=data, size=[BOOK["dict_dim"], BOOK["emb"]])
    hid = BOOK["hid"]
    if name == "conv":
        feats = [pt.nets.sequence_conv_pool(
            input=emb, num_filters=hid, filter_size=k, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
    else:
        fc1 = layers.fc(input=emb, size=hid * 4)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid * 4,
                                       use_peepholes=False)
        inputs = [fc1, lstm1]
        for i in range(2, 4):
            fc = layers.fc(input=inputs, size=hid * 4)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid * 4,
                                          is_reverse=(i % 2) == 0,
                                          use_peepholes=False)
            inputs = [fc, lstm]
        feats = [layers.sequence_pool(input=v, pool_type="max")
                 for v in inputs]
    prediction = layers.fc(input=feats, size=2, act="softmax")
    return layers.mean(layers.cross_entropy(input=prediction, label=label))


def phase_sequence_nets():
    """The sentiment book's two nets train ``BOOK_STEPS`` Adam steps each
    on the card on one seeded batch of fixed-length sequences (as the
    book clips them): the convolution net (``nets.sequence_conv_pool``:
    ``sequence_conv`` and the ``sqrt`` pool) and the 3-layer stacked
    LSTM (``is_reverse`` on even layers, ``fc`` over a list, ``max``
    pools).  Loss finite and falling, no hand-written kernel launched."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS

    B, T, V = BOOK["batch"], BOOK["clip_len"], BOOK["dict_dim"]
    rng = np.random.RandomState(SEED)
    feed = {"words": (rng.randint(0, V, (B * T, 1)).astype("int64"),
                      [list(range(0, B * T + 1, T))]),
            "label": rng.randint(0, 2, (B, 1)).astype("int64")}
    out = {}
    for name in ("conv", "stacked_lstm"):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = SEED
        with pt.program_guard(main, startup):
            cost = _book_net(pt, name)
            pt.optimizer.Adam(learning_rate=BOOK["lr"]).minimize(cost)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        for kern in ALL_KERNELS:
            kern.launches = 0
        losses, step_s, _ = _timed_steps(exe, main, cost, scope, feed,
                                         BOOK_STEPS)
        _no_launches(f"sequence_nets[{name}]")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"sequence_nets[{name}]: losses {losses} "
                                 f"not finite and falling")
        out[name] = dict(step_ms=1e3 * float(np.mean(step_s[1:])),
                         losses=losses)
        log(f"sequence_nets[{name}]: B={B} T={T} dict {V} emb/hid "
            f"{BOOK['hid']}: losses {[round(x, 6) for x in losses]}; "
            f"steady step {out[name]['step_ms']:.3f} ms")
        del main, startup, scope
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the op families: each op type of the book's tensor, math, loss, nn,
# metric, CRF and CTC families on the card against the CPU
# ---------------------------------------------------------------------------

def _fam_f(rng, *shape, scale=1.0):
    import numpy as np
    return (rng.randn(*shape) * scale).astype(np.float32)


def _ints(*values):
    import numpy as np
    return np.array(values, np.int64).reshape(-1, 1)


def _tied(r):
    """Rows with ties: the first index must win."""
    x = _fam_f(r, 3, 5)
    x[0, 1] = x[0, 3] = x[0].max() + 1.0
    x[1, 0] = x[1, 4] = x[1].min() - 1.0
    x[2] = 0.5
    return x


def _pool_mask(r):
    """``(values, mask)`` of a 2x2 max pool over 4x4 planes: each pooled
    value with its flat index in the 16-element plane (``unpool``'s
    inputs)."""
    import numpy as np
    x = _fam_f(r, 2, 3, 4, 4)
    win = x.reshape(2, 3, 2, 2, 2, 2).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(2, 3, 2, 2, 4)
    k = win.argmax(-1)
    row = np.arange(2)[:, None] * 2 + k // 2
    col = np.arange(2)[None, :] * 2 + k % 2
    return win.max(-1), (row * 4 + col).astype(np.int64)


def op_family_cases():
    """The sweep's cases without a LoD (each row its own sequence for the
    ops that read one): ``(id, op type, {slot: array, or a list of
    arrays}, output slots, attrs)``, inputs made from a seed with numpy.
    The departures of torch's library calls from the JAX package are
    cases: floor semantics of mod / floordiv with negative operands,
    lrn's alpha (not alpha / n), image_resize's corner-aligned and
    antialiased resampling, pool2d_with_index's mask within each H x W
    plane, spp's bin edges, scatter with unique ids only (the order of a
    repeated id is XLA's and undefined), a tie for each arg op (the
    first index wins).  ``tests/test_torch_ops.py`` holds the same cases
    against the JAX package on the CPU."""
    import numpy as np
    _f = _fam_f
    r = np.random.RandomState(41)
    neg = _f(r, 3, 4) * 3
    div = np.where(np.abs(_f(r, 3, 4)) < 0.5, 0.75, _f(r, 3, 4))
    div = np.where(np.abs(div) < 0.5, -0.75, div).astype(np.float32)
    ia = np.array([[7, -7, 5, -5], [0, 9, -9, 3]], np.int32)
    ib = np.array([[3, 3, -2, -2], [4, -4, 4, 2]], np.int32)
    pooled, mask = _pool_mask(r)
    diff = _f(r, 4, 3)
    smooth_y = diff + np.array([0.1, -0.2, 0.3], np.float32) * \
        np.sign(_f(r, 4, 3))
    return [
        # tensor_ops
        ("fill_zeros_like", "fill_zeros_like", {"X": _f(r, 3, 4)},
         ["Out"], {}),
        ("fill", "fill", {}, ["Out"],
         {"shape": [2, 3], "dtype": "float32",
          "value": [0.5, -1.0, 2.0, 3.25, 0.0, 1e-3]}),
        ("fill_int", "fill", {}, ["Out"],
         {"shape": [3], "dtype": "int32", "value": [4, -2, 7]}),
        ("shape", "shape", {"Input": _f(r, 2, 3, 4)}, ["Out"], {}),
        ("squeeze_axes", "squeeze", {"X": _f(r, 3, 1, 4, 1)}, ["Out"],
         {"axes": [1, -1, 0]}),
        ("squeeze_all", "squeeze", {"X": _f(r, 1, 3, 1, 4)}, ["Out"],
         {"axes": []}),
        ("unsqueeze", "unsqueeze", {"X": _f(r, 3, 4)}, ["Out"],
         {"axes": [0, 2]}),
        ("pad", "pad", {"X": _f(r, 2, 3)}, ["Out"],
         {"paddings": [1, 0, 2, 1], "pad_value": 0.5}),
        ("crop", "crop", {"X": _f(r, 4, 5)}, ["Out"],
         {"offsets": [1, 2], "shape": [2, 3]}),
        ("slice", "slice", {"Input": _f(r, 4, 5, 6)}, ["Out"],
         {"axes": [0, 2], "starts": [1, -3], "ends": [3, 100]}),
        ("scatter_unique", "scatter",
         {"X": _f(r, 6, 3), "Ids": np.array([4, -1, 2], np.int64),
          "Updates": _f(r, 3, 3)}, ["Out"], {}),
        ("multiplex", "multiplex",
         {"X": [_f(r, 4, 3), _f(r, 4, 3), _f(r, 4, 3)],
          "Ids": _ints(2, 0, 1, 2).astype(np.int32)}, ["Out"], {}),
        ("one_hot", "one_hot", {"X": _ints(0, 3, 4, 1, -1, 5)}, ["Out"],
         {"depth": 5}),
        ("argsort_ties", "argsort", {"X": _tied(r)}, ["Out", "Indices"],
         {"axis": -1}),
        ("argsort_axis0", "argsort", {"X": _tied(r)}, ["Out", "Indices"],
         {"axis": 0}),
        ("arg_max_ties", "arg_max", {"X": _tied(r)}, ["Out"], {"axis": -1}),
        ("arg_max_axis0", "arg_max", {"X": _tied(r)}, ["Out"], {"axis": 0}),
        ("arg_min_ties", "arg_min", {"X": _tied(r)}, ["Out"], {"axis": -1}),
        ("arg_min_axis0", "arg_min", {"X": _tied(r)}, ["Out"], {"axis": 0}),
        # math_ops
        ("elementwise_mod_signs", "elementwise_mod", {"X": neg, "Y": div},
         ["Out"], {"axis": -1}),
        ("elementwise_mod_int", "elementwise_mod", {"X": ia, "Y": ib},
         ["Out"], {"axis": -1}),
        ("elementwise_floordiv_signs", "elementwise_floordiv",
         {"X": neg, "Y": div}, ["Out"], {"axis": -1}),
        ("elementwise_floordiv_int", "elementwise_floordiv",
         {"X": ia, "Y": ib}, ["Out"], {"axis": -1}),
        ("minus", "minus", {"X": _f(r, 3, 4), "Y": _f(r, 3, 4)}, ["Out"],
         {}),
        ("cumsum", "cumsum", {"X": _f(r, 3, 4)}, ["Out"], {"axis": 1}),
        ("cumsum_exclusive_reverse", "cumsum", {"X": _f(r, 3, 4)},
         ["Out"], {"axis": 0, "exclusive": True, "reverse": True}),
        ("cumsum_exclusive", "cumsum", {"X": _f(r, 3, 4)}, ["Out"],
         {"axis": -1, "exclusive": True}),
        ("l1_norm", "l1_norm",
         {"X": np.concatenate([_f(r, 5), [0.0]]).astype(np.float32)},
         ["Out"], {}),
        ("norm", "norm", {"X": _f(r, 2, 3, 4)}, ["Out", "Norm"],
         {"axis": 1, "epsilon": 1e-10}),
        ("cos_sim", "cos_sim", {"X": _f(r, 4, 5), "Y": _f(r, 4, 5)},
         ["Out", "XNorm", "YNorm"], {}),
        ("cos_sim_broadcast_y", "cos_sim",
         {"X": _f(r, 4, 5), "Y": _f(r, 1, 5)}, ["Out", "XNorm", "YNorm"],
         {}),
        ("bilinear_tensor_product", "bilinear_tensor_product",
         {"X": _f(r, 3, 4), "Y": _f(r, 3, 5), "Weight": _f(r, 2, 4, 5),
          "Bias": _f(r, 1, 2)}, ["Out"], {}),
        # loss_ops
        ("squared_l2_distance", "squared_l2_distance",
         {"X": _f(r, 4, 3), "Y": _f(r, 4, 3)}, ["Out", "sub_result"], {}),
        ("squared_l2_distance_row_y", "squared_l2_distance",
         {"X": _f(r, 4, 3), "Y": _f(r, 1, 3)}, ["Out", "sub_result"], {}),
        ("smooth_l1_loss", "smooth_l1_loss",
         {"X": diff, "Y": smooth_y,
          "InsideWeight": np.abs(_f(r, 4, 3)) + 0.5,
          "OutsideWeight": np.abs(_f(r, 4, 3)) + 0.5}, ["Out", "Diff"],
         {"sigma": 2.0}),
        ("smooth_l1_loss_plain", "smooth_l1_loss",
         {"X": _f(r, 4, 3), "Y": _f(r, 4, 3)}, ["Out", "Diff"], {}),
        ("hinge_loss", "hinge_loss",
         {"Logits": _f(r, 6, 1), "Labels": (r.rand(6, 1) < 0.5)
          .astype(np.float32)}, ["Loss"], {}),
        ("huber_loss", "huber_loss", {"X": _f(r, 6, 1), "Y": _f(r, 6, 1)},
         ["Out", "Residual"], {"delta": 0.5}),
        ("log_loss", "log_loss",
         {"Predicted": r.uniform(0.05, 0.95, (6, 1)).astype(np.float32),
          "Labels": (r.rand(6, 1) < 0.5).astype(np.float32)}, ["Loss"],
         {"epsilon": 1e-4}),
        ("rank_loss", "rank_loss",
         {"Left": _f(r, 5, 1), "Right": _f(r, 5, 1),
          "Label": (r.rand(5, 1) < 0.5).astype(np.float32)}, ["Out"], {}),
        ("margin_rank_loss", "margin_rank_loss",
         {"X1": _f(r, 6, 1), "X2": _f(r, 6, 1),
          "Label": np.where(r.rand(6, 1) < 0.5, -1.0, 1.0)
          .astype(np.float32)}, ["Out", "Activated"], {"margin": 0.1}),
        ("modified_huber_loss", "modified_huber_loss",
         {"X": np.array([[-3.0], [-0.5], [0.2], [0.9], [1.5], [2.5]],
                        np.float32),
          "Y": np.array([[1], [1], [0], [1], [0], [1]], np.float32)},
         ["Out", "IntermediateVal"], {}),
        # nn_ops
        ("conv2d_transpose", "conv2d_transpose",
         {"Input": _f(r, 2, 4, 5, 5), "Filter": _f(r, 4, 3, 3, 3)},
         ["Output"], {"strides": [2, 2], "paddings": [1, 1],
                      "dilations": [1, 1], "groups": 1}),
        ("conv2d_transpose_grouped_dilated", "conv2d_transpose",
         {"Input": _f(r, 1, 4, 4, 5), "Filter": _f(r, 4, 2, 3, 2)},
         ["Output"], {"strides": [1, 2], "paddings": [0, 1],
                      "dilations": [2, 1], "groups": 2}),
        ("conv3d_transpose", "conv3d_transpose",
         {"Input": _f(r, 1, 2, 3, 4, 4), "Filter": _f(r, 2, 3, 2, 3, 3)},
         ["Output"], {"strides": [1, 2, 2], "paddings": [0, 1, 1],
                      "dilations": [1, 1, 1], "groups": 1}),
        ("conv3d", "conv3d",
         {"Input": _f(r, 2, 3, 5, 6, 6), "Filter": _f(r, 4, 3, 3, 3, 2)},
         ["Output"], {"strides": [1, 2, 1], "paddings": [1, 1, 0],
                      "dilations": [1, 1, 1], "groups": 1}),
        ("conv3d_grouped", "conv3d",
         {"Input": _f(r, 1, 4, 4, 4, 4), "Filter": _f(r, 4, 2, 2, 2, 2)},
         ["Output"], {"strides": [1, 1, 1], "paddings": [0, 0, 0],
                      "dilations": [1, 2, 1], "groups": 2}),
        ("pool2d_with_index", "pool2d_with_index", {"X": _f(r, 2, 3, 5, 5)},
         ["Out", "Mask"], {"ksize": [2, 2], "strides": [2, 2],
                           "paddings": [0, 0]}),
        ("pool2d_with_index_padded", "pool2d_with_index",
         {"X": _f(r, 1, 2, 5, 6)}, ["Out", "Mask"],
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
        ("pool2d_with_index_ties", "pool2d_with_index",
         {"X": np.repeat(np.repeat(_f(r, 1, 2, 2, 2), 2, 2), 2, 3)},
         ["Out", "Mask"], {"ksize": [2, 2], "strides": [2, 2],
                           "paddings": [0, 0]}),
        ("pool2d_with_index_global", "pool2d_with_index",
         {"X": _f(r, 2, 2, 3, 4)}, ["Out", "Mask"],
         {"ksize": [1, 1], "global_pooling": True}),
        ("lrn", "lrn", {"X": _f(r, 2, 6, 3, 3)}, ["Out", "MidOut"],
         {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}),
        ("log_softmax", "log_softmax", {"X": _f(r, 3, 7)}, ["Out"], {}),
        ("label_smooth", "label_smooth",
         {"X": np.eye(5, dtype=np.float32)[[0, 3, 4]]}, ["Out"],
         {"epsilon": 0.1}),
        ("label_smooth_prior", "label_smooth",
         {"X": np.eye(5, dtype=np.float32)[[1, 2]],
          "PriorDist": np.abs(_f(r, 1, 5))}, ["Out"], {"epsilon": 0.2}),
        ("pool3d_max", "pool3d", {"X": _f(r, 2, 2, 4, 5, 6)}, ["Out"],
         {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
          "paddings": [0, 0, 0]}),
        ("pool3d_avg_exclusive_ceil", "pool3d", {"X": _f(r, 1, 2, 5, 5, 4)},
         ["Out"], {"pooling_type": "avg", "ksize": [3, 3, 2],
                   "strides": [2, 2, 2], "paddings": [1, 1, 0],
                   "ceil_mode": True, "exclusive": True}),
        ("pool3d_avg_global", "pool3d", {"X": _f(r, 1, 3, 2, 3, 4)},
         ["Out"], {"pooling_type": "avg", "ksize": [1, 1, 1],
                   "global_pooling": True, "exclusive": False}),
        ("unpool", "unpool", {"X": pooled, "Indices": mask}, ["Out"],
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
          "unpooling_type": "max"}),
        ("spp_max", "spp", {"X": _f(r, 2, 3, 5, 7)}, ["Out"],
         {"pyramid_height": 3, "pooling_type": "max"}),
        ("spp_avg", "spp", {"X": _f(r, 2, 3, 5, 7)}, ["Out"],
         {"pyramid_height": 3, "pooling_type": "avg"}),
        ("conv_shift", "conv_shift", {"X": _f(r, 3, 7), "Y": _f(r, 3, 3)},
         ["Out"], {}),
        ("image_resize_align_corners", "image_resize",
         {"X": _f(r, 2, 3, 4, 5)}, ["Out"],
         {"out_h": 7, "out_w": 3, "method": "bilinear"}),
        ("image_resize_half_pixel", "image_resize",
         {"X": _f(r, 2, 3, 4, 5)}, ["Out"],
         {"out_h": 7, "out_w": 3, "method": "bilinear",
          "align_corners": False}),
        ("image_resize_nearest", "image_resize", {"X": _f(r, 2, 3, 4, 5)},
         ["Out"], {"out_h": 7, "out_w": 3, "method": "nearest"}),
        # metric_ops
        ("auc", "auc",
         {"Predict": np.stack([1 - (p := r.rand(20)), p], 1)
          .astype(np.float32),
          "Label": r.randint(0, 2, (20, 1)).astype(np.int64)},
         ["AUC", "StatPosOut", "StatNegOut"], {"num_thresholds": 200}),
        ("auc_accumulated", "auc",
         {"Predict": np.stack([1 - (p := r.rand(12)), p], 1)
          .astype(np.float32),
          "Label": r.randint(0, 2, (12, 1)).astype(np.int64),
          "StatPos": r.randint(0, 3, 11).astype(np.int64),
          "StatNeg": r.randint(0, 3, 11).astype(np.int64)},
         ["AUC", "StatPosOut", "StatNegOut"], {"num_thresholds": 10}),
        # scores past the int32 range saturate into the top bucket
        ("auc_saturating", "auc",
         {"Predict": np.stack([1 - (p := np.array(
             [0.1, 0.7, 2e7, 3e38, np.inf, 0.4, 0.9, 0.2], np.float32)),
             p], 1),
          "Label": np.array([0, 1, 1, 0, 1, 0, 1, 0],
                            np.int64).reshape(8, 1)},
         ["AUC", "StatPosOut", "StatNegOut"], {"num_thresholds": 200}),
        ("precision_recall", "precision_recall",
         {"MaxProbs": r.rand(8, 1).astype(np.float32),
          "Indices": r.randint(0, 4, (8, 1)).astype(np.int64),
          "Labels": r.randint(0, 4, (8, 1)).astype(np.int64)},
         ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
         {"class_number": 4}),
        ("precision_recall_weighted_states", "precision_recall",
         {"MaxProbs": r.rand(8, 1).astype(np.float32),
          "Indices": r.randint(0, 4, (8, 1)).astype(np.int64),
          "Labels": r.randint(0, 4, (8, 1)).astype(np.int64),
          "Weights": r.rand(8, 1).astype(np.float32),
          "StatesInfo": r.rand(4, 4).astype(np.float32) * 3},
         ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
         {"class_number": 4}),
        ("chunk_eval_iob", "chunk_eval",
         {"Inference": _ints(0, 1, 4, 2, 3, 3, 4, 0, 1, 1, 2, 4),
          "Label": _ints(0, 1, 4, 2, 3, 4, 4, 0, 1, 4, 2, 3)},
         ["Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"],
         {"num_chunk_types": 2, "chunk_scheme": "IOB"}),
        ("chunk_eval_iobes_excluded", "chunk_eval",
         {"Inference": _ints(0, 1, 2, 3, 4, 5, 7, 8, 4, 6, 8),
          "Label": _ints(0, 1, 2, 3, 4, 6, 7, 8, 5, 6, 8)},
         ["Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"],
         {"num_chunk_types": 2, "chunk_scheme": "IOBES",
          "excluded_chunk_types": [1]}),
        ("positive_negative_pair", "positive_negative_pair",
         {"Score": np.round(_f(r, 10, 1), 1),
          "Label": r.randint(0, 3, (10, 1)).astype(np.float32),
          "QueryID": _ints(0, 0, 0, 1, 1, 1, 1, 2, 2, 2),
          "Weight": r.rand(10, 1).astype(np.float32)},
         ["PositivePair", "NegativePair", "NeutralPair"], {}),
        # crf_ops / ctc_ops without a LoD: each row its own sequence
        ("linear_chain_crf_rows", "linear_chain_crf",
         {"Emission": _f(r, 5, 4), "Transition": _f(r, 6, 4),
          "Label": _ints(0, 3, 1, 2, 3)},
         ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"], {}),
        ("crf_decoding_rows", "crf_decoding",
         {"Emission": _f(r, 5, 4), "Transition": _f(r, 6, 4)},
         ["ViterbiPath"], {}),
        ("crf_decoding_rows_label", "crf_decoding",
         {"Emission": _f(r, 5, 4), "Transition": _f(r, 6, 4),
          "Label": _ints(0, 3, 1, 2, 3)}, ["ViterbiPath"], {}),
        ("warpctc_rows", "warpctc",
         {"Logits": _f(r, 4, 5), "Label": _ints(1, 4, 2, 3)}, ["Loss"],
         {"blank": 0, "norm_by_times": False}),
        ("ctc_align_rows", "ctc_align", {"Input": _ints(0, 2, 2, 0, 3)},
         ["Output"], {"blank": 0}),
        ("edit_distance_rows", "edit_distance",
         {"Hyps": _ints(1, 2, 3, 4), "Refs": _ints(1, 5, 3, 0)},
         ["Out", "SequenceNum"], {"normalized": False}),
    ]

def op_family_lod_cases():
    """The ops that read a LoD, over LoDs with a sequence of length 1
    and an empty one where the op takes it: ``(id, op type, {slot:
    array}, output slots, attrs, {slot: LoD})``."""
    import numpy as np
    _f = _fam_f
    r = np.random.RandomState(47)
    lod = [[0, 3, 4, 4, 9]]
    n, k = 9, 6
    labels = r.randint(0, k, (n, 1)).astype(np.int64)
    logit_lod, label_lod = [[0, 4, 9, 10]], [[0, 2, 4, 5]]
    chunk_lod = [[0, 5, 5, 12]]
    return [
        ("linear_chain_crf_lod", "linear_chain_crf",
         {"Emission": _f(r, n, k), "Transition": _f(r, k + 2, k) * 0.5,
          "Label": labels},
         ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"], {},
         {"Emission": lod, "Label": lod}),
        ("crf_decoding_lod", "crf_decoding",
         {"Emission": _f(r, n, k), "Transition": _f(r, k + 2, k) * 0.5},
         ["ViterbiPath"], {}, {"Emission": lod}),
        ("crf_decoding_lod_label", "crf_decoding",
         {"Emission": _f(r, n, k), "Transition": _f(r, k + 2, k) * 0.5,
          "Label": labels}, ["ViterbiPath"], {},
         {"Emission": lod, "Label": lod}),
        ("warpctc_lod", "warpctc",
         {"Logits": _f(r, 10, 5), "Label": _ints(1, 1, 2, 4, 3)},
         ["Loss"], {"blank": 0, "norm_by_times": False},
         {"Logits": logit_lod, "Label": label_lod}),
        ("warpctc_lod_norm", "warpctc",
         {"Logits": _f(r, 10, 5), "Label": _ints(2, 3, 3, 1, 4)},
         ["Loss"], {"blank": 0, "norm_by_times": True},
         {"Logits": logit_lod, "Label": label_lod}),
        ("ctc_align_lod", "ctc_align",
         {"Input": _ints(0, 1, 1, 0, 2, 2, 3, 0, 0, 4, 4, 1)}, ["Output"],
         {"blank": 0}, {"Input": chunk_lod}),
        ("edit_distance_lod", "edit_distance",
         {"Hyps": _ints(1, 2, 3, 4, 5), "Refs": _ints(1, 3, 3, 9)},
         ["Out", "SequenceNum"], {"normalized": True},
         {"Hyps": [[0, 3, 5]], "Refs": [[0, 2, 4]]}),
        ("chunk_eval_lod", "chunk_eval",
         {"Inference": _ints(0, 1, 4, 2, 3, 3, 4, 0, 1, 1, 2, 4),
          "Label": _ints(0, 1, 4, 2, 3, 4, 4, 0, 1, 4, 2, 3)},
         ["Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"],
         {"num_chunk_types": 2, "chunk_scheme": "IOB"},
         {"Inference": chunk_lod, "Label": chunk_lod}),
    ]


def repaired_op_cases():
    """The ops whose NaN grads and integer inputs were repaired (the
    max-like family at a NaN, ties beside it; ``mean``, ``reduce_mean``,
    ``sign`` and ``reduce_sum`` of an int32), in the form of
    :func:`op_family_lod_cases`."""
    import numpy as np
    nan = np.nan
    rows = np.array([[1, 3, 3, 2], [nan, 1, 2, 0]], np.float32)
    pair = {"X": np.array([nan, 1, 2, 3], np.float32),
            "Y": np.array([1, nan, 2, 1], np.float32)}
    act = {"X": np.array([nan, 0.5, -0.5, 0.0, 0.25], np.float32)}
    ints = np.array([1, 2, 4, 2147483647, 1, 0], np.int32)
    red = {"dim": [1], "keep_dim": False, "reduce_all": False}
    return [
        ("reduce_max_nan", "reduce_max", {"X": rows}, ["Out"], red, {}),
        ("reduce_min_nan", "reduce_min", {"X": rows}, ["Out"], red, {}),
        ("maxout_nan", "maxout",
         {"X": np.array([1, nan, 2, 3, 4, 4], np.float32)
          .reshape(1, 6, 1, 1)}, ["Out"], {"groups": 2}, {}),
        ("pool2d_max_nan", "pool2d",
         {"X": np.array([1, nan, 2, 3, 5, 0, 7, 1, 9, 4, 4, 8, 2, 2, 6, 6],
                        np.float32).reshape(1, 1, 4, 4)}, ["Out"],
         {"ksize": [2, 2], "strides": [2, 2], "pooling_type": "max"}, {}),
        ("sequence_pool_max_nan", "sequence_pool",
         {"X": np.array([[1, 2], [nan, 0], [3, 3], [1, 3]], np.float32)},
         ["Out", "MaxIndex"], {"pooltype": "MAX"}, {"X": [[0, 2, 4]]}),
        ("elementwise_max_nan", "elementwise_max", pair, ["Out"],
         {"axis": -1}, {}),
        ("elementwise_min_nan", "elementwise_min", pair, ["Out"],
         {"axis": -1}, {}),
        ("relu_nan", "relu", act, ["Out"], {}, {}),
        ("relu6_nan", "relu6", act, ["Out"], {"threshold": 6.0}, {}),
        ("brelu_nan", "brelu", act, ["Out"],
         {"t_min": -1.0, "t_max": 0.25}, {}),
        ("clip_nan", "clip", act, ["Out"], {"min": -0.5, "max": 0.0}, {}),
        ("hard_sigmoid_nan", "hard_sigmoid", act, ["Out"],
         {"slope": 0.25, "offset": 0.5}, {}),
        ("mean_int", "mean", {"X": ints}, ["Out"], {}, {}),
        ("reduce_mean_int", "reduce_mean", {"X": ints}, ["Out"],
         {"dim": [0], "keep_dim": False, "reduce_all": True}, {}),
        ("sign_int", "sign", {"X": np.array([-7, 0, 3], np.int32)},
         ["Out"], {}, {}),
        ("reduce_sum_int", "reduce_sum", {"X": ints}, ["Out"],
         {"dim": [0], "keep_dim": False, "reduce_all": False}, {}),
    ]


#: the modules of the sweep's families
FAMILY_MODULES = ("tensor_ops", "math_ops", "loss_ops", "nn_ops",
                  "metric_ops", "crf_ops", "ctc_ops", "detection_ops")
#: the op types of those modules that earlier slices ported, which their
#: own phases run on the card
EARLIER_FAMILY_OPS = frozenset((
    "assign", "assign_value", "cast", "concat", "expand", "fill_constant",
    "fill_constant_batch_size_like", "gather", "gaussian_random",
    "lookup_table", "reshape", "split", "top_k", "transpose",
    "uniform_random", "clip", "clip_by_norm", "elementwise_add",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_mul", "elementwise_pow", "elementwise_sub", "matmul",
    "mean", "mul", "reduce_max", "reduce_mean", "reduce_min",
    "reduce_prod", "reduce_sum", "scale", "sign", "squared_l2_norm", "sum",
    "cross_entropy", "sigmoid_cross_entropy_with_logits",
    "softmax_with_cross_entropy", "batch_norm", "conv2d",
    "depthwise_conv2d", "dropout", "layer_norm", "pool2d", "softmax",
    "accuracy"))
#: the random ops of the families: checked by range, moments and seeding
RNG_FAMILY_OPS = ("uniform_random_batch_size_like",
                  "gaussian_random_batch_size_like", "sampling_id")


def family_ops():
    """The op types the sweep must cover, from the port's registry: every
    forward op type registered by ``FAMILY_MODULES`` that no earlier slice
    ported."""
    from paddle_tpu_torch.ops import registry
    ops = registry.all_ops()
    return sorted(t for t, d in ops.items()
                  if d.lower is not None and
                  d.lower.__module__.rsplit(".", 1)[-1] in FAMILY_MODULES
                  and not (t.endswith("_grad") and t[:-5] in ops)
                  and t not in EARLIER_FAMILY_OPS)


def _fam_named(inputs):
    named = {}
    for slot, arr in inputs.items():
        if isinstance(arr, list):
            named.update({f"in_{slot}_{i}": a for i, a in enumerate(arr)})
        else:
            named[f"in_{slot}"] = arr
    return named


def _fam_program(pt, op_type, inputs, out_slots, attrs, lods, cot=False):
    """One ``op_type`` op over input variables ``in_<slot>`` (LoD level 1
    where ``lods`` has the slot) into ``out_<slot>``; with ``cot``, then
    ``loss = reduce_sum(out * cot)`` of the first output and the
    cotangent ``cot`` a feed, every float input a data variable that
    takes a grad."""
    vars_, ins = [], {}
    for slot, arr in inputs.items():
        named = _fam_named({slot: arr})
        ins[slot] = list(named)
        for name, a in named.items():
            vars_.append({"name": name, "shape": list(a.shape),
                          "dtype": str(a.dtype), "persistable": False,
                          "lod_level": 1 if slot in lods else 0,
                          "is_data": True,
                          "stop_gradient": a.dtype.kind != "f"})
    outs = {s: [f"out_{s}"] for s in out_slots}
    vars_ += [{"name": f"out_{s}", "shape": None, "dtype": "float32"}
              for s in out_slots]
    ops = [{"type": op_type, "inputs": ins, "outputs": outs,
            "attrs": dict(attrs)}]
    if cot:
        vars_ += [{"name": "cot", "shape": None, "dtype": "float32",
                   "is_data": True, "stop_gradient": True},
                  {"name": "prod", "shape": None, "dtype": "float32"},
                  {"name": "loss", "shape": [1], "dtype": "float32"}]
        ops += [{"type": "elementwise_mul",
                 "inputs": {"X": [f"out_{out_slots[0]}"], "Y": ["cot"]},
                 "outputs": {"Out": ["prod"]}, "attrs": {"axis": -1}},
                {"type": "reduce_sum", "inputs": {"X": ["prod"]},
                 "outputs": {"Out": ["loss"]},
                 "attrs": {"dim": [0], "keep_dim": False,
                           "reduce_all": True}}]
    return pt.Program.from_dict({"blocks": [{
        "idx": 0, "parent_idx": -1, "vars": vars_, "ops": ops}]})


def _fam_feed(inputs, lods):
    return {n: (a, lods[n[3:]]) if n[3:] in lods else a
            for n, a in _fam_named(inputs).items()}


def _fam_forward(pt, case, device, seed=SEED):
    """``{output name: numpy}`` of one op run through ``lower_block`` on
    ``device``."""
    import torch
    from paddle_tpu_torch.convert import to_numpy, to_tensor
    from paddle_tpu_torch.executor import lower_block
    _, op_type, inputs, out_slots, attrs, lods = case
    prog = _fam_program(pt, op_type, inputs, out_slots, attrs, lods)
    block = prog.global_block()
    env = {n: to_tensor(a, device) for n, a in _fam_named(inputs).items()}
    aux = {"device": device, "rng_seed": seed, "amp": False,
           "generator": torch.Generator().manual_seed(seed),
           "lod": {f"in_{s}": lod for s, lod in lods.items()}}
    with torch.no_grad():
        lower_block(block, env, aux)
    return {n: to_numpy(env[n]) for n in block.ops[0].output_arg_names
            if n in env}


def _fam_grads(pt, case, place, cot):
    """The input grads of one op at the cotangent ``cot`` of its first
    output, through ``append_backward`` and ``Executor.run`` on
    ``place``."""
    import numpy as np
    _, op_type, inputs, out_slots, attrs, lods = case
    prog = _fam_program(pt, op_type, inputs, out_slots, attrs, lods,
                        cot=True)
    pt.append_backward(prog.global_block().var("loss"))
    grads = sorted(n for n in prog.global_block().vars
                   if n.startswith("in_") and n.endswith("@GRAD"))
    feed = _fam_feed(inputs, lods)
    feed["cot"] = cot
    vals = pt.Executor(place).run(prog, feed=feed, fetch_list=grads,
                                  scope=pt.Scope())
    return dict(zip(grads, [np.asarray(v) for v in vals]))


def _fam_compare(got, want, what):
    """Float32 within ``F32_TOL`` (NaN where NaN), anything else
    equal; returns the largest float difference."""
    import numpy as np
    if set(got) != set(want):
        raise AssertionError(f"op_families[{what}]: outputs {sorted(got)} "
                             f"!= {sorted(want)}")
    worst = 0.0
    for n in want:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        if g.shape != w.shape:
            raise AssertionError(f"op_families[{what}]: {n} shape {g.shape}"
                                 f" != {w.shape}")
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL,
                                       equal_nan=True,
                                       err_msg=f"op_families[{what}] {n}")
            live = ~np.isnan(w)
            if live.any():
                worst = max(worst, float(np.abs(g[live] - w[live]).max()))
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"op_families"
                                                        f"[{what}] {n}")
    return worst


def _fam_rng(pt, device):
    """The random ops on ``device``: each draw repeats under its seed and
    RNG slot and changes with either; ``U[min, max)`` within range at its
    mean, ``N(mean, std**2)`` at its moments, ``sampling_id`` in ``[0,
    C)`` at the row's probabilities (a zero one never)."""
    import numpy as np
    base = np.zeros((64, 3), np.float32)
    attrs = {"shape": [-1, 512], "input_dim_idx": 0, "output_dim_idx": 0,
             "dtype": "float32", "min": -0.5, "max": 0.25, "mean": 1.5,
             "std": 0.5}
    probs = np.tile(np.array([0.1, 0.0, 0.6, 0.3], np.float32), (8192, 1))
    cases = {
        "uniform_random_batch_size_like": ({"Input": base}, attrs),
        "gaussian_random_batch_size_like": ({"Input": base}, attrs),
        "sampling_id": ({"X": probs}, {})}
    out = {}
    for op_type, (inputs, at) in cases.items():
        case = (op_type, op_type, inputs, ["Out"], at, {})
        draws = [_fam_forward(pt, case, device, seed)["out_Out"]
                 for seed in (SEED, SEED, SEED + 1)]
        if not np.array_equal(draws[0], draws[1]) or \
                np.array_equal(draws[0], draws[2]):
            raise AssertionError(f"op_families[{op_type}]: not seeded")
        d = draws[0]
        if op_type.startswith("uniform"):
            ok = d.shape == (64, 512) and d.min() >= -0.5 and \
                d.max() < 0.25 and abs(d.mean() + 0.125) < 0.01
        elif op_type.startswith("gaussian"):
            ok = d.shape == (64, 512) and abs(d.mean() - 1.5) < 0.01 and \
                abs(d.std() - 0.5) < 0.01
        else:
            freq = np.bincount(d.reshape(-1), minlength=4) / len(d)
            ok = d.shape == (8192, 1) and d.dtype == np.int64 and \
                freq[1] == 0 and np.abs(freq - probs[0]).max() < 0.02
        if not ok:
            raise AssertionError(f"op_families[{op_type}]: draws out of "
                                 f"range or off their moments")
        out[op_type] = float(d.mean())
    return out


def phase_op_families():
    """Every op type of the book's families and of the detection ops
    (``family_ops``, from the registry) and every repaired op
    (``repaired_op_cases``) on ``cuda:0`` and on the CPU from the same
    seeded numpy inputs (``op_family_cases``, ``op_family_lod_cases``,
    ``detection_op_cases``):
    float32 outputs within ``F32_TOL`` (no case reduces over more than
    1024 terms), integer and host outputs equal; the input grads of each
    op that has one, through ``append_backward``, likewise (finite at
    the NaN inputs of the repaired ops); the random ops by range,
    moments and seeding (``_fam_rng``).  Fails if an op type of
    ``family_ops()`` has no case, and if a hand-written kernel
    launches."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import registry

    required = family_ops()
    cases = [c + ({},) for c in op_family_cases()] + \
        op_family_lod_cases() + repaired_op_cases() + detection_op_cases()
    covered = {c[1] for c in cases} | set(RNG_FAMILY_OPS)
    missing = sorted(set(required) - covered)
    if missing:
        raise AssertionError(f"op_families: no case for {missing}")
    card = torch.device("cuda", 0)
    t0 = time.perf_counter()
    worst, n_grads = {}, 0
    for case in cases:
        what, op_type = case[0], case[1]
        worst[what] = _fam_compare(_fam_forward(pt, case, card),
                                   _fam_forward(pt, case,
                                                torch.device("cpu")), what)
        opdef = registry.lookup(op_type)
        floats = [a for a in _fam_named(case[2]).values()
                  if a.dtype.kind == "f"]
        if not opdef.has_grad or not floats:
            continue
        out = _fam_forward(pt, case, torch.device("cpu"))
        cot = np.random.RandomState(5).randn(
            *out[f"out_{case[3][0]}"].shape).astype(np.float32)
        got = _fam_grads(pt, case, pt.CUDAPlace(0), cot)
        want = _fam_grads(pt, case, pt.CPUPlace(), cot)
        if not want or not all(np.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"op_families[{what}]: grads {got}")
        worst[what] = max(worst[what], _fam_compare(got, want,
                                                    f"{what} grad"))
        n_grads += 1
    rng = _fam_rng(pt, card)
    _no_launches("op_families")
    seconds = time.perf_counter() - t0
    top = max(worst, key=worst.get)
    log(f"op_families[{card_line()}]: {len(required)} op types of "
        f"{', '.join(FAMILY_MODULES)} ported here, {len(cases)} cases "
        f"({len({c[1] for c in cases})} op types with the repaired ones), "
        f"{n_grads} with grads, card against CPU: worst |diff| "
        f"{worst[top]:.3e} ({top}); random ops seeded and in range "
        f"{json.dumps(rng)}; {seconds:.1f} s")
    return dict(op_types=len(required), cases=len(cases), grads=n_grads,
                worst_abs_diff=worst[top], seconds=seconds)


# ---------------------------------------------------------------------------
# the book's semantic role labeling: db_lstm + linear-chain CRF
# ---------------------------------------------------------------------------

#: the Fluid book's label_semantic_roles (chapter 07) at its widths: the
#: eight features (the word, the five context words around the
#: predicate, the predicate, the mark), word_dim 32, mark_dim 5,
#: hidden_dim 512, depth 8, the CRF's transitions at lr 1e-3, batches of
#: 10, IOB over ceil((59 - 1) / 2) = 29 chunk types; the dictionaries of
#: the port's ``dataset.conll05``
SRL_WORD_FEATURES = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
                     "ctx_p2")
SRL_BOOK = dict(word_dict=44068, pred_dict=3162, label_dict=59,
                mark_dict=2, word_dim=32, mark_dim=5, hidden=512, depth=8,
                words=SRL_WORD_FEATURES, rows=None, book=True,
                crf_lr=1e-3, batch=10, chunk_types=29)
#: 5 distinct batches, 4 passes over them: the first 5 steps and the last
#: 5 see the same batches
SRL_BATCHES, SRL_EPOCHS = 5, 4
#: the card-vs-CPU step: a CPU step of the full-width net takes seconds
SRL_CARD_CPU_B = 10
#: a Viterbi token may differ between the card and the CPU only where the
#: CPU's two best final path scores lie this close (relative)
SRL_TIE_RTOL = 1e-4


def srl_net(pkg, cfg):
    """The book's ``db_lstm`` (``cfg["depth"]`` mixed ``fc`` +
    ``dynamic_lstm`` layers, the direction flipping with ``i % 2``) over
    ``cfg["words"]`` word features, the predicate and the mark, then
    ``linear_chain_crf`` ("crfw"), the mean cost, SGD, ``crf_decoding``
    on "crfw" and a streaming IOB ``ChunkEvaluator``, built with
    ``pkg``'s layers (the port's here; the JAX package's in
    ``tests/test_torch_book.py``, which holds the two against each
    other).  ``cfg["book"]``: the book's word embedding "emb" (fixed,
    ``trainable=False``), sparse predicate and mark embeddings, ``tanh``
    on every ``fc`` and the exponentially decayed learning rate;
    otherwise the cut-down net of
    ``tests/test_book_label_semantic_roles.py`` ("srl_emb", dense, no
    activation, SGD at 0.01).  Returns ``(feed names, avg_cost, crf_decode,
    evaluator)``."""
    layers = pkg.layers
    shape = [cfg["rows"], 1] if cfg["rows"] else [1]
    names = list(cfg["words"]) + ["verb", "mark", "target"]
    data = {n: layers.data(name=n, shape=shape, dtype="int64", lod_level=1,
                           append_batch_size=not cfg["rows"])
            for n in names}
    book = cfg["book"]
    pred_emb = layers.embedding(data["verb"],
                                size=[cfg["pred_dict"], cfg["word_dim"]],
                                param_attr="vemb", is_sparse=book)
    mark_emb = layers.embedding(data["mark"],
                                size=[cfg["mark_dict"], cfg["mark_dim"]],
                                is_sparse=book)
    word_attr = pkg.ParamAttr(name="emb", trainable=False) if book \
        else "srl_emb"
    embs = [layers.embedding(data[n], size=[cfg["word_dict"],
                                            cfg["word_dim"]],
                             param_attr=word_attr) for n in cfg["words"]]
    embs += [pred_emb, mark_emb]
    hid = cfg["hidden"]
    act = "tanh" if book else None
    hidden_0 = layers.sums(input=[layers.fc(input=e, size=hid, act=act)
                                  for e in embs])
    lstm_0, _ = layers.dynamic_lstm(
        hidden_0, size=hid, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid")
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, cfg["depth"]):
        mix = layers.sums(input=[
            layers.fc(input=input_tmp[0], size=hid, act=act),
            layers.fc(input=input_tmp[1], size=hid, act=act)])
        lstm, _ = layers.dynamic_lstm(
            mix, size=hid, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid",
            is_reverse=(i % 2) == 1)
        input_tmp = [mix, lstm]
    feature_out = layers.sums(input=[
        layers.fc(input=input_tmp[0], size=cfg["label_dict"], act=act),
        layers.fc(input=input_tmp[1], size=cfg["label_dict"], act=act)])
    crf_attr = pkg.ParamAttr(name="crfw", learning_rate=cfg["crf_lr"]) \
        if book else pkg.ParamAttr(name="crfw")
    crf_cost = layers.linear_chain_crf(input=feature_out,
                                       label=data["target"],
                                       param_attr=crf_attr)
    avg_cost = layers.mean(crf_cost)
    lr = layers.exponential_decay(learning_rate=0.01, decay_steps=100000,
                                  decay_rate=0.5, staircase=True) \
        if book else 0.01
    pkg.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    crf_decode = layers.crf_decoding(input=feature_out,
                                     param_attr=pkg.ParamAttr(name="crfw"))
    evaluator = pkg.evaluator.ChunkEvaluator(
        input=crf_decode, label=data["target"], chunk_scheme="IOB",
        num_chunk_types=cfg["chunk_types"])
    return names, avg_cost, crf_decode, evaluator


def srl_batches(samples, cfg, n_batches):
    """``n_batches`` feeds of ``cfg["batch"]`` sequences each from the
    ``dataset.conll05`` sample iterator ``samples``, unclipped: every
    feature ``[N, 1]`` int64 with the batch's LoD (sample fields: the six
    words, the predicate, the mark, the labels)."""
    import numpy as np
    fields = SRL_WORD_FEATURES + ("verb", "mark", "target")
    keep = [fields.index(n) for n in cfg["words"]] + [6, 7, 8]
    out = []
    for _ in range(n_batches):
        batch = [next(samples) for _ in range(cfg["batch"])]
        lod = [[0] + list(np.cumsum([len(b[0]) for b in batch]))]
        feed = {}
        for name, k in zip(list(cfg["words"]) + ["verb", "mark", "target"],
                           keep):
            feed[name] = (np.concatenate([np.asarray(b[k], np.int64)
                                          for b in batch]).reshape(-1, 1),
                          [[int(v) for v in lod[0]]])
        out.append(feed)
    return out


def iob_chunks(tags, n_types):
    """The ``(begin, end, type)`` chunks of an IOB tag sequence (tag
    ``2 t`` begins a chunk of type t, ``2 t + 1`` continues one, any
    type from ``n_types`` on is outside): a plain recount, independent
    of the port's ``chunk_eval``."""
    chunks, start, ctype = set(), None, None
    for i, lab in enumerate(list(tags) + [2 * n_types]):
        t, inside = int(lab) // 2, int(lab) // 2 < n_types
        if start is not None and (not inside or int(lab) % 2 == 0 or
                                  t != ctype):
            chunks.add((start, i - 1, ctype))
            start = None
        if inside and start is None:
            start, ctype = i, t
    return chunks


def _srl_program(pt, cfg):
    """``(main, startup, names, cost, decode, evaluator)`` of
    :func:`srl_net` in fresh programs seeded ``SEED``."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        names, cost, decode, ev = srl_net(pt, cfg)
    return main, startup, names, cost, decode, ev


def phase_label_semantic_roles():
    """The book's SRL model trains on the card at its full widths
    (``SRL_BOOK``) through ``layers``, ``SGD.minimize`` and
    ``Executor.run`` with static LoD feeds of unclipped
    ``dataset.conll05.train()`` sequences: ``SRL_BATCHES`` batches of 10,
    ``SRL_EPOCHS`` passes; the fixed word embedding is
    ``conll05.get_embedding()``.  Every loss finite, the mean of the last
    5 below the mean of the first 5; ``ChunkEvaluator.eval``'s
    precision, recall and F1 exactly those of a plain IOB recount
    (:func:`iob_chunks`) of the fetched ``crf_decoding`` paths against
    the targets over all steps; no hand-written kernel launched.  Printed:
    ms a step, tokens a second, the state's GiB and the steps' peak
    allocation above what was allocated before them; then
    ``phase_card_vs_cpu_srl``."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import to_tensor
    from paddle_tpu_torch.dataset import conll05
    from paddle_tpu_torch.kernels import ALL_KERNELS

    cfg = SRL_BOOK
    exe = pt.Executor()
    if exe.device != torch.device("cuda", 0):
        raise AssertionError(f"Executor landed on {exe.device}")
    main, startup, names, cost, decode, ev = _srl_program(pt, cfg)
    scope = pt.Scope()
    batches = srl_batches(iter(conll05.train()()), cfg, SRL_BATCHES)
    with pt.scope_guard(scope):
        exe.run(startup)
        scope.set_var("emb", to_tensor(conll05.get_embedding(), exe.device))
        ev.reset(exe)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state_gib = sum(v.numel() * v.element_size()
                        for _, v in scope.items()
                        if isinstance(v, torch.Tensor)) / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        for kern in ALL_KERNELS:
            kern.launches = 0
        losses, step_s, recount = [], [], [0, 0, 0]
        for epoch in range(SRL_EPOCHS):
            for feed in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, path, *_ = exe.run(main, feed=feed,
                                         fetch_list=[cost, decode]
                                         + ev.metrics)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(float(np.asarray(loss).reshape(())))
                path = np.asarray(path).reshape(-1)
                target, lod = feed["target"]
                target = target.reshape(-1)
                n_types = cfg["chunk_types"]
                for lo, hi in zip(lod[0][:-1], lod[0][1:]):
                    inf = iob_chunks(path[lo:hi], n_types)
                    lab = iob_chunks(target[lo:hi], n_types)
                    recount[0] += len(inf)
                    recount[1] += len(lab)
                    recount[2] += len(inf & lab)
        _no_launches("label_semantic_roles")
        precision, recall, f1 = (float(v[0]) for v in ev.eval(exe))
    # the main program stays eager (host ops: chunk_eval; LoD tables);
    # the startup and the evaluator's reset program may run as graphs
    _graphs("label_semantic_roles", exe, None)
    n_inf, n_lab, n_ok = recount
    want_p = n_ok / n_inf if n_inf else 0.0
    want_r = n_ok / n_lab if n_lab else 0.0
    want_f1 = 2 * want_p * want_r / (want_p + want_r) if n_ok else 0.0
    if (precision, recall, f1) != (want_p, want_r, want_f1):
        raise AssertionError(
            f"label_semantic_roles: ChunkEvaluator {precision, recall, f1} "
            f"!= the recount {want_p, want_r, want_f1} ({recount})")
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"label_semantic_roles: losses {losses} not "
                             f"finite and falling")
    # above what the process held before the steps (earlier phases'
    # objects included), so the figure is the steps' own
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    tokens = [int(f["target"][0].shape[0]) for f in batches]
    steady = float(np.mean(step_s[SRL_BATCHES:]))
    tokens_per_s = float(np.mean(tokens)) / steady
    lens = [int(d) for f in batches for d in np.diff(f["target"][1][0])]
    log(f"label_semantic_roles[book, {card_line()}]: words {cfg['word_dict']}"
        f" x {cfg['word_dim']} (fixed), {len(cfg['words'])} word features, "
        f"hidden {cfg['hidden']} x depth {cfg['depth']}, {cfg['label_dict']} "
        f"labels, B={cfg['batch']} lengths {min(lens)}..{max(lens)} "
        f"({tokens} tokens a batch): losses {[round(x, 4) for x in losses]}; "
        f"step ms {[round(1e3 * x, 2) for x in step_s]}; steady (passes "
        f"2..) {1e3 * steady:.3f} ms = {tokens_per_s:.1f} tokens/s; state "
        f"{state_gib:.4f} GiB, the steps' peak above what was allocated "
        f"before them {peak_gib:.4f} GiB; ChunkEvaluator P/R/F1 "
        f"{precision:.6f}/{recall:.6f}/{f1:.6f} = the recount of "
        f"{n_inf} inferred, {n_lab} labelled, {n_ok} correct chunks")
    out = dict(step_ms=1e3 * steady, tokens_per_s=tokens_per_s,
               peak_gib=peak_gib, state_gib=state_gib, losses=losses,
               first_step_ms=1e3 * step_s[0],
               chunk=dict(precision=precision, recall=recall, f1=f1))
    del main, startup, scope
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = phase_card_vs_cpu_srl()
    _no_launches("label_semantic_roles card-vs-cpu")
    return out


def _dense_grad(value):
    """``(grad, adds)``: a fetched grad as a float64 array (a sparse
    embedding's ``SelectedRows``, fetched as a 0-d object array,
    densified) and how many terms an update of each element sums (the
    count of its row among a sparse grad's rows, at least 1; 1 for a
    dense grad)."""
    import numpy as np
    from paddle_tpu_torch.convert import to_numpy
    value = np.asarray(value)
    if value.dtype != object:
        return value.astype(np.float64), 1
    sr = value.item()
    dense = to_numpy(sr.to_dense()).astype(np.float64)
    rows = to_numpy(sr.rows).reshape(-1)
    rows = rows[(rows >= 0) & (rows < dense.shape[0])]
    adds = np.bincount(rows, minlength=dense.shape[0]).clip(min=1)
    return dense, adds.reshape((-1,) + (1,) * (dense.ndim - 1))


def srl_final_scores(pt, main, state, feed):
    """Each sequence's best and second-best final Viterbi score
    (``crf_decoding``'s last scores plus the stop weights) on the CPU in
    float64, from the emissions of a forward run of ``main``'s ops before
    ``crf_decoding`` on the persistables ``state``: ``[B, 2]``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import to_tensor
    from paddle_tpu_torch.executor import lower_block
    device = torch.device("cpu")
    block = main.global_block()
    decode_op = next(op for op in block.ops if op.type == "crf_decoding")
    env = {n: to_tensor(v, device) for n, v in state.items()}
    for name, (value, _) in feed.items():
        env[name] = to_tensor(value, device, "int64")
    aux = {"device": device, "amp": False, "rng_seed": SEED,
           "lod": {n: lod for n, (_, lod) in feed.items()}}
    sub = main.clone()
    sub.global_block().ops = sub.global_block().ops[
        :block.ops.index(decode_op)]
    with torch.no_grad():
        lower_block(sub.global_block(), env, aux)
    em = env[decode_op.input("Emission")[0]].double().numpy()
    trans = env[decode_op.input("Transition")[0]].double().numpy()
    splits = feed["target"][1][0]
    out = []
    for lo, hi in zip(splits[:-1], splits[1:]):
        v = trans[0] + em[lo]
        for t in range(lo + 1, hi):
            v = (v[:, None] + trans[2:]).max(axis=0) + em[t]
        out.append(np.sort(v + trans[1])[::-1][:2])
    return np.asarray(out)


def phase_card_vs_cpu_srl():
    """One float32 SGD step of the full-width SRL net (``SRL_BOOK``,
    ``SRL_CARD_CPU_B`` sequences of ``conll05.test()``) from one startup
    state on the card and on the CPU.  The loss is held to
    ``CARD_CPU_LOSS_RTOL``; every parameter's grad (fetched; the sparse
    predicate and mark embeddings' densified) to ``CARD_CPU_GRAD_RTOL``
    of its norm; every updated parameter element to what its grad's
    difference allows (``lr |dg|`` plus two roundings of each side for
    each term of the update: a sparse row's duplicate slots).  The
    Viterbi paths must be equal token for token, except in a sequence
    whose two best final scores (the CPU's, in float64) lie within
    ``SRL_TIE_RTOL`` of each other: a near tie, counted and printed."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy,
                                          to_tensor)
    from paddle_tpu_torch.dataset import conll05

    cfg = dict(SRL_BOOK, batch=SRL_CARD_CPU_B)
    main, startup, _, cost, decode, ev = _srl_program(pt, cfg)
    block = main.global_block()
    sgd = {op.input("Param")[0]: op for op in block.ops if op.type == "sgd"}
    params = sorted(sgd)
    if set(params) != {p.name for p in block.all_parameters()} - {"emb"}:
        raise AssertionError(f"card-vs-cpu[srl]: sgd ops for {params}")
    (feed,) = srl_batches(iter(conll05.test()()), cfg, 1)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    with pt.scope_guard(cpu_scope):
        cpu.run(startup)
        cpu_scope.set_var("emb", to_tensor(conll05.get_embedding(),
                                           cpu.device))
        ev.reset(cpu)
    state = {n: to_numpy(cpu_scope.find_var(n))
             for n in persistable_names(main)}
    card_scope = scope_from_numpy(state, None, main)
    grads = [sgd[p].input("Grad")[0] for p in params]
    fetched = {}
    for tag, exe, scope in (("cpu", cpu, cpu_scope),
                            ("card", pt.Executor(), card_scope)):
        with pt.scope_guard(scope):
            fetched[tag] = exe.run(main, feed=feed,
                                   fetch_list=[cost, decode] + grads)
    a = float(np.asarray(fetched["card"][0]).reshape(()))
    b = float(np.asarray(fetched["cpu"][0]).reshape(()))
    eps32 = float(np.finfo(np.float32).eps)
    rel, p_ratio = {}, {}
    for i, p in enumerate(params):
        g_card, adds = _dense_grad(fetched["card"][2 + i])
        g_cpu, _ = _dense_grad(fetched["cpu"][2 + i])
        norm = float(np.linalg.norm(g_cpu))
        if not norm > 0:
            raise AssertionError(f"card-vs-cpu[srl]: {p} got no grad")
        rel[p] = float(np.linalg.norm(g_card - g_cpu)) / norm
        lr = 0.01 * (cfg["crf_lr"] if p == "crfw" else 1.0)
        got = to_numpy(card_scope.find_var(p)).astype(np.float64)
        want = to_numpy(cpu_scope.find_var(p)).astype(np.float64)
        # two roundings of each side (``lr * g``, then the add), as
        # ``_adam_first_step_errors`` allows, for each term of the
        # update: a sparse row sums its duplicate slots one by one (in
        # another order on the card)
        allow = lr * np.abs(g_card - g_cpu) + 4 * eps32 * adds * (
            np.abs(want) + lr * np.abs(g_cpu))
        diff = np.abs(got - want)
        p_ratio[p] = float(np.where(diff == 0, 0.0, diff / np.maximum(
            allow, np.finfo(np.float64).tiny)).max())
    worst, worst_p = max(rel, key=rel.get), max(p_ratio, key=p_ratio.get)
    path_card = np.asarray(fetched["card"][1]).reshape(-1)
    path_cpu = np.asarray(fetched["cpu"][1]).reshape(-1)
    splits = feed["target"][1][0]
    differ = [i for i, (lo, hi) in enumerate(zip(splits[:-1], splits[1:]))
              if not np.array_equal(path_card[lo:hi], path_cpu[lo:hi])]
    if differ:
        scores = srl_final_scores(pt, main, state, feed)
        for i in differ:
            best, second = scores[i]
            if not best - second <= SRL_TIE_RTOL * abs(best):
                raise AssertionError(
                    f"card-vs-cpu[srl]: sequence {i}'s Viterbi path differs "
                    f"and its final scores {best!r}, {second!r} are no tie")
    log(f"card-vs-cpu[srl] book widths B={cfg['batch']} "
        f"({len(path_cpu)} tokens) f32: loss card {a!r} cpu {b!r} (rel "
        f"{abs(a - b) / abs(b):.2e}, bound {CARD_CPU_LOSS_RTOL}); grads "
        f"|card - cpu| / |cpu| worst {rel[worst]:.3e} ({worst}, bound "
        f"{CARD_CPU_GRAD_RTOL}); parameters |dp| / allowed worst "
        f"{p_ratio[worst_p]:.3e} ({worst_p}, bound 1); Viterbi paths equal "
        f"in {len(splits) - 1 - len(differ)} of {len(splits) - 1} "
        f"sequences, {len(differ)} near ties")
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[srl]: loss {a} vs {b}")
    if rel[worst] > CARD_CPU_GRAD_RTOL:
        raise AssertionError(f"card-vs-cpu[srl]: {worst}'s grad differs by "
                             f"{rel[worst]} relative")
    if p_ratio[worst_p] > 1.0:
        raise AssertionError(f"card-vs-cpu[srl]: parameter {worst_p} moved "
                             f"{p_ratio[worst_p]} x what its grad's "
                             f"difference allows")
    return dict(loss_rel=abs(a - b) / abs(b), grad_rel=rel[worst],
                param_ratio=p_ratio[worst_p], viterbi_near_ties=len(differ))


# ---------------------------------------------------------------------------
# detection: the detection ops' cases, MobileNet-SSD on Pascal VOC
# ---------------------------------------------------------------------------

def _boxes(r, n, lo=0.0, span=0.5):
    """``n`` corner boxes ``[x1, y1, x2, y2]`` inside the unit square."""
    import numpy as np
    x1 = lo + r.rand(n) * span
    y1 = lo + r.rand(n) * span
    x2 = x1 + 0.05 + r.rand(n) * (1.0 - span - lo - 0.05)
    y2 = y1 + 0.05 + r.rand(n) * (1.0 - span - lo - 0.05)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def detection_op_cases():
    """The detection ops' cases (``ops/detection_ops.py``), in the form
    of :func:`op_family_lod_cases`: every op type, both ``box_coder``
    codes, ``bipartite_match`` over a LoD, with ``per_prediction`` and on
    a matrix of ties (the row-major first maximum wins), ``target_assign``
    with both ``NegIndices`` forms, both mining types over tied losses,
    ``multiclass_nms`` with suppression, ``keep_top_k``, ``nms_eta`` and
    nothing kept, ``roi_pool`` at two scales, ``detection_map`` in both
    AP versions, with difficult boxes and with carried state.
    ``tests/test_torch_detection.py`` holds them against the JAX package
    on the CPU."""
    import numpy as np
    _f = _fam_f
    r = np.random.RandomState(43)
    prior, target = _boxes(r, 6), _boxes(r, 3)
    pvar = (r.rand(6, 4) * 0.3 + 0.1).astype(np.float32)
    ties = (np.floor(r.rand(6, 9) * 4) / 4).astype(np.float32)
    feat = np.zeros((1, 4, 3, 4), np.float32)
    img = np.zeros((1, 3, 24, 32), np.float32)
    match = np.array([[0, -1, 1, -1, 0], [-1, 0, -1, -1, -1]], np.int32)
    dense_neg = np.array([[3, 1, -1, -1, -1], [2, 4, 0, -1, -1]], np.int32)
    flat_neg = np.array([[3], [1], [2], [4]], np.int32)
    tied_loss = np.array([[0.5, 0.9, 0.5, 0.3, 0.9, 0.5, 0.1, 0.5],
                          [0.2, 0.2, 0.2, 0.2, 0.7, 0.7, 0.2, 0.2]],
                         np.float32)
    mine_match = np.array([[0, -1, -1, -1, -1, -1, 1, -1],
                           [-1, -1, 0, -1, -1, -1, -1, -1]], np.int32)
    mine_dist = (r.rand(2, 8) * 0.6).astype(np.float32)
    nms_boxes = np.stack([np.concatenate([_boxes(r, 6, 0.0, 0.6),
                                          _boxes(r, 6, 0.2, 0.3)])
                          for _ in range(2)])
    nms_scores = r.rand(2, 3, 12).astype(np.float32)
    x = _f(r, 2, 3, 6, 6)
    det = np.array([[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                    [1, 0.8, 0.6, 0.6, 0.9, 0.9],
                    [2, 0.7, 0.12, 0.1, 0.45, 0.42],
                    [1, 0.95, 0.5, 0.5, 0.8, 0.85],
                    [2, 0.6, 0.05, 0.5, 0.3, 0.9],
                    [1, 0.4, 0.52, 0.5, 0.8, 0.82]], np.float32)
    label = np.array([[1, 0, 0.1, 0.1, 0.4, 0.4],
                      [2, 1, 0.1, 0.1, 0.45, 0.4],
                      [1, 0, 0.5, 0.5, 0.8, 0.8],
                      [2, 0, 0.0, 0.5, 0.3, 0.9],
                      [1, 1, 0.6, 0.1, 0.9, 0.3]], np.float32)
    det_lod, lab_lod = [[0, 3, 6]], [[0, 2, 5]]
    state = {"HasState": np.array([1], np.int32),
             "PosCount": np.array([[0], [2], [1]], np.int32),
             "TruePos": np.array([[0.85, 1], [0.3, 0], [0.5, 1]],
                                 np.float32),
             "FalsePos": np.array([[0.85, 0], [0.3, 1], [0.5, 0]],
                                  np.float32)}
    map_out = ["MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"]
    prior_attrs = {"min_sizes": [8.0, 14.0], "max_sizes": [12.0, 20.0],
                   "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
                   "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
                   "step_h": 0.0, "offset": 0.5}
    nms = {"background_label": 0, "nms_threshold": 0.3, "nms_top_k": 8,
           "keep_top_k": 10, "score_threshold": 0.2, "nms_eta": 1.0}
    mine = {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
            "mining_type": "max_negative", "sample_size": 0}
    return [
        ("iou_similarity", "iou_similarity",
         {"X": _boxes(r, 5), "Y": _boxes(r, 7)}, ["Out"], {}, {}),
        ("box_coder_encode", "box_coder",
         {"PriorBox": prior, "PriorBoxVar": pvar, "TargetBox": target},
         ["OutputBox"], {"code_type": "encode_center_size"}, {}),
        ("box_coder_decode", "box_coder",
         {"PriorBox": prior, "TargetBox": _f(r, 2, 6, 4) * 0.5},
         ["OutputBox"], {"code_type": "decode_center_size"}, {}),
        ("prior_box", "prior_box", {"Input": feat, "Image": img},
         ["Boxes", "Variances"], prior_attrs, {}),
        ("prior_box_steps", "prior_box", {"Input": feat, "Image": img},
         ["Boxes", "Variances"],
         dict(prior_attrs, max_sizes=[], aspect_ratios=[2.0], flip=False,
              clip=False, step_w=9.0, step_h=7.0, offset=0.25), {}),
        ("bipartite_match_lod", "bipartite_match",
         {"DistMat": r.rand(11, 7).astype(np.float32)},
         ["ColToRowMatchIndices", "ColToRowMatchDist"],
         {"match_type": None, "dist_threshold": None},
         {"DistMat": [[0, 5, 11]]}),
        ("bipartite_match_per_prediction", "bipartite_match",
         {"DistMat": r.rand(4, 10).astype(np.float32)},
         ["ColToRowMatchIndices", "ColToRowMatchDist"],
         {"match_type": "per_prediction", "dist_threshold": 0.5}, {}),
        ("bipartite_match_ties", "bipartite_match", {"DistMat": ties},
         ["ColToRowMatchIndices", "ColToRowMatchDist"],
         {"match_type": "per_prediction", "dist_threshold": 0.25},
         {"DistMat": [[0, 2, 6]]}),
        ("target_assign", "target_assign",
         {"X": _f(r, 3, 5, 4), "MatchIndices": match},
         ["Out", "OutWeight"], {"mismatch_value": 9}, {"X": [[0, 2, 3]]}),
        ("target_assign_dense_neg", "target_assign",
         {"X": np.array([[[1]], [[2]], [[3]]], np.int32),
          "MatchIndices": match, "NegIndices": dense_neg},
         ["Out", "OutWeight"], {"mismatch_value": 0}, {"X": [[0, 2, 3]]}),
        ("target_assign_flat_neg", "target_assign",
         {"X": _f(r, 3, 1, 2), "MatchIndices": match,
          "NegIndices": flat_neg},
         ["Out", "OutWeight"], {"mismatch_value": 0},
         {"X": [[0, 2, 3]], "NegIndices": [[0, 1, 4]]}),
        ("mine_max_negative_ties", "mine_hard_examples",
         {"ClsLoss": tied_loss, "MatchIndices": mine_match,
          "MatchDist": mine_dist},
         ["NegIndices", "UpdatedMatchIndices"], mine, {}),
        ("mine_hard_example", "mine_hard_examples",
         {"ClsLoss": tied_loss, "LocLoss": _f(r, 2, 8) * 0.1,
          "MatchIndices": mine_match, "MatchDist": mine_dist},
         ["NegIndices", "UpdatedMatchIndices"],
         dict(mine, mining_type="hard_example", sample_size=3), {}),
        ("multiclass_nms", "multiclass_nms",
         {"BBoxes": nms_boxes, "Scores": nms_scores}, ["Out"], nms, {}),
        ("multiclass_nms_keep_top_k", "multiclass_nms",
         {"BBoxes": nms_boxes, "Scores": nms_scores}, ["Out"],
         dict(nms, nms_threshold=0.6, keep_top_k=3, nms_top_k=-1), {}),
        ("multiclass_nms_eta", "multiclass_nms",
         {"BBoxes": nms_boxes, "Scores": nms_scores}, ["Out"],
         dict(nms, nms_threshold=0.7, nms_eta=0.8), {}),
        ("multiclass_nms_none", "multiclass_nms",
         {"BBoxes": nms_boxes, "Scores": nms_scores * 0.1}, ["Out"], nms,
         {}),
        ("roi_pool", "roi_pool",
         {"X": x, "ROIs": np.array([[0, 0, 0, 3, 3], [1, 2, 2, 5, 5],
                                    [1, 1, 0, 4, 2]], np.int64)},
         ["Out", "Argmax"],
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}, {}),
        ("roi_pool_scaled", "roi_pool",
         {"X": x, "ROIs": np.array([[0, 1.0, 2.0, 9.0, 11.0],
                                    [1, 0.0, 0.0, 11.0, 6.0]], np.float32)},
         ["Out", "Argmax"],
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}, {}),
        ("detection_map_integral", "detection_map",
         {"DetectRes": det, "Label": label}, map_out,
         {"class_num": 3, "overlap_threshold": 0.5,
          "evaluate_difficult": True, "ap_type": "integral",
          "background_label": 0},
         {"DetectRes": det_lod, "Label": lab_lod}),
        ("detection_map_11point_state", "detection_map",
         dict({"DetectRes": det, "Label": label}, **state), map_out,
         {"class_num": 3, "overlap_threshold": 0.5,
          "evaluate_difficult": False, "ap_type": "11point",
          "background_label": 0},
         {"DetectRes": det_lod, "Label": lab_lod,
          "TruePos": [[0, 0, 2, 3]], "FalsePos": [[0, 0, 2, 3]]}),
        ("scale_sub_region", "scale_sub_region",
         {"X": _f(r, 3, 4, 5, 6),
          "Indices": np.array([[1, 2, 1, 3, 2, 4], [2, 4, 2, 5, 1, 6],
                               [3, 3, 1, 1, 1, 1]], np.float32)},
         ["Out"], {"value": 2.5}, {}),
    ]


#: MobileNet-SSD on Pascal VOC as PaddlePaddle's 2018 models repo
#: trains it (``fluid/object_detection/mobilenet_ssd.py``, ``train.py``):
#: 3 x 300 x 300 images, 21 classes, the published widths (``scale``
#: 1), ``ssd_loss`` with its defaults summed, RMSProp at 0.001 under
#: ``piecewise_decay`` (boundaries 40000 and 60000, halving), L2Decay
#: 5e-5, NMS at 0.45; B 32 a step (the script's default batch); 1 to
#: ``max_boxes`` ground-truth boxes an image, about ``difficult`` of them
#: marked difficult
SSD_VOC = dict(image=300, classes=21, scale=1.0, batch=32, lr=0.001,
               boundaries=(40000, 60000), l2=5e-5, nms_threshold=0.45,
               max_boxes=8, difficult=0.1)
#: the prior sizes at 300 x 300 (scaled with the image elsewhere)
SSD_MIN_SIZES = (60.0, 105.0, 150.0, 195.0, 240.0, 285.0)
SSD_MAX_SIZES = (None, 150.0, 195.0, 240.0, 285.0, 300.0)
SSD_PRIORS = 1917
#: training: batches, passes over them; evaluation: held-out batches
SSD_BATCHES, SSD_PASSES, SSD_EVAL_BATCHES = 5, 4, 2
#: the card-vs-CPU step's batch, and its grad bound: a deep conv net with
#: batch norms and ReLUs, as ResNet-50's card-vs-CPU step
SSD_CARD_CPU_B = 4
SSD_CARD_CPU_GRAD_RTOL = 1e-4
#: a near tie of two priors' mining losses (relative), where the card's
#: and the CPU's negatives may differ
SSD_TIE_RTOL = 1e-5


def mobilenet_ssd(pkg, cfg):
    """MobileNet-SSD (``mobilenet_ssd.py``'s ``mobile_net``: a 3x3/2
    ``conv_bn`` of 32, thirteen depthwise-separable blocks, module11 at
    19 x 19 and module13 at 10 x 10, four extra blocks down to 1 x 1,
    ``multi_box_head`` over the six maps) and its ``ssd_loss`` summed,
    built with ``pkg``'s layers at ``cfg["image"]`` and widths x
    ``cfg["scale"]`` (the prior sizes scaled with the image).  Returns
    the data variables, the head's outputs and the loss by name."""
    L = pkg.layers
    scale, size = cfg["scale"], cfg["image"]

    def conv_bn(x, filter_size, num_filters, stride, padding, groups=1):
        attr = pkg.ParamAttr(learning_rate=0.1,
                             initializer=pkg.initializer.MSRA())
        conv = L.conv2d(input=x, num_filters=num_filters,
                        filter_size=filter_size, stride=stride,
                        padding=padding, groups=groups, act=None,
                        use_cudnn=groups == 1, param_attr=attr,
                        bias_attr=False)
        return L.batch_norm(input=conv, act="relu")

    def depthwise_separable(x, f1, f2, groups, stride):
        dw = conv_bn(x, 3, int(f1 * scale), stride, 1, int(groups * scale))
        return conv_bn(dw, 1, int(f2 * scale), 1, 0)

    def extra_block(x, f1, f2, groups, stride):
        pw = conv_bn(x, 1, int(f1 * scale), 1, 0, int(groups * scale))
        return conv_bn(pw, 3, int(f2 * scale), stride, 1,
                       int(groups * scale))

    image = L.data(name="image", shape=[3, size, size], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[4], dtype="float32", lod_level=1)
    gt_label = L.data(name="gt_label", shape=[1], dtype="int32",
                      lod_level=1)
    difficult = L.data(name="difficult", shape=[1], dtype="int32",
                       lod_level=1)
    tmp = conv_bn(image, 3, int(32 * scale), 2, 1)
    tmp = depthwise_separable(tmp, 32, 64, 32, 1)
    tmp = depthwise_separable(tmp, 64, 128, 64, 2)
    tmp = depthwise_separable(tmp, 128, 128, 128, 1)
    tmp = depthwise_separable(tmp, 128, 256, 128, 2)
    tmp = depthwise_separable(tmp, 256, 256, 256, 1)
    tmp = depthwise_separable(tmp, 256, 512, 256, 2)
    for _ in range(5):
        tmp = depthwise_separable(tmp, 512, 512, 512, 1)
    module11 = tmp
    tmp = depthwise_separable(tmp, 512, 1024, 512, 2)
    module13 = depthwise_separable(tmp, 1024, 1024, 1024, 1)
    module14 = extra_block(module13, 256, 512, 1, 2)
    module15 = extra_block(module14, 128, 256, 1, 2)
    module16 = extra_block(module15, 128, 256, 1, 2)
    module17 = extra_block(module16, 64, 128, 1, 2)
    k = size / 300.0
    locs, confs, box, box_var = L.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=image, num_classes=cfg["classes"], min_ratio=20,
        max_ratio=90, min_sizes=[s * k for s in SSD_MIN_SIZES],
        max_sizes=[[] if s is None else s * k for s in SSD_MAX_SIZES],
        aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, base_size=size,
        offset=0.5, flip=True)
    loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                   box_var))
    return dict(image=image, gt_box=gt_box, gt_label=gt_label,
                difficult=difficult, locs=locs, confs=confs, box=box,
                box_var=box_var, loss=loss)


def ssd_programs(pkg, cfg, optimize=True):
    """``(main, startup, test, net, nmsed, map_eval)``: ``main`` the
    training step (:func:`mobilenet_ssd`, then RMSProp as ``train.py``
    has it), ``test`` its clone for test taken before the optimizer, with
    ``detection_output`` and ``evaluator.DetectionMAP`` (11-point,
    difficult boxes not evaluated).  ``train.py`` builds
    ``detection_output`` into the training program too; here it is the
    test program's only, since no training step fetches it and its NMS
    is a host op."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with pkg.program_guard(main, startup):
        net = mobilenet_ssd(pkg, cfg)
        test = main.clone(for_test=True)
        with pkg.program_guard(test, startup):
            nmsed = L.detection_output(
                net["locs"], net["confs"], net["box"], net["box_var"],
                nms_threshold=cfg["nms_threshold"])
            map_eval = pkg.evaluator.DetectionMAP(
                nmsed, net["gt_label"], net["gt_box"], net["difficult"],
                cfg["classes"], overlap_threshold=0.5,
                evaluate_difficult=False, ap_version="11point")
        if optimize:
            lr = cfg["lr"]
            pkg.optimizer.RMSProp(
                learning_rate=L.piecewise_decay(
                    list(cfg["boundaries"]), [lr, lr * 0.5, lr * 0.25]),
                regularization=pkg.regularizer.L2Decay(cfg["l2"])).minimize(
                    net["loss"])
    return main, startup, test, net, nmsed, map_eval


def ssd_batches(cfg, n_batches, seed):
    """``n_batches`` feeds of ``cfg["batch"]`` seeded images (standard
    normal) with 1 to ``cfg["max_boxes"]`` boxes each (corners in the
    unit square, sides 0.1 to 0.6), labels 1 to ``classes - 1``, about
    ``cfg["difficult"]`` of them difficult: ``gt_box``, ``gt_label`` and
    ``difficult`` share the batch's LoD."""
    import numpy as np
    r = np.random.RandomState(seed)
    size, out = cfg["image"], []
    for _ in range(n_batches):
        counts = r.randint(1, cfg["max_boxes"] + 1, cfg["batch"])
        n = int(counts.sum())
        wh = 0.1 + r.rand(n, 2) * 0.5
        xy = r.rand(n, 2) * (1.0 - wh)
        boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
        lod = [[0] + [int(v) for v in np.cumsum(counts)]]
        out.append({
            "image": r.randn(cfg["batch"], 3, size, size).astype(
                np.float32),
            "gt_box": (boxes, lod),
            "gt_label": (r.randint(1, cfg["classes"], (n, 1)).astype(
                np.int32), lod),
            "difficult": ((r.rand(n, 1) < cfg["difficult"]).astype(
                np.int32), lod)})
    return out


def voc_map_recount(batches, overlap=0.5):
    """The 11-point VOC mAP of the detections of ``batches`` (``[(feed,
    detections, lod)]``: ``[No, 6]`` rows of label, score and box, their
    image splits) over each feed's ground truth, difficult boxes
    ignored, in plain numpy: a detection is a true positive when its box
    (clipped to the unit square) overlaps its class's best ground truth
    in its image by more than ``overlap`` and no higher-scored detection
    took that box; a class counts where it has positives and detections.
    Independent of the port's ``detection_map``."""
    import numpy as np
    scored, positives = {}, {}   # class -> [(score, tp)]; class -> count
    for feed, dets_all, lod in batches:
        boxes, glod = feed["gt_box"]
        labels = feed["gt_label"][0].reshape(-1)
        hard = feed["difficult"][0].reshape(-1).astype(bool)
        for img in range(len(glod[0]) - 1):
            lo, hi = glod[0][img], glod[0][img + 1]
            for c in np.unique(labels[lo:hi]):
                n = int(((labels[lo:hi] == c) & ~hard[lo:hi]).sum())
                positives[int(c)] = positives.get(int(c), 0) + n
            dets = dets_all[lod[img]:lod[img + 1]]
            if dets.shape[-1] != 6:
                continue                      # nothing detected
            for c in np.unique(dets[:, 0]).astype(int):
                mine = dets[dets[:, 0] == c]
                mine = mine[np.argsort(-mine[:, 1], kind="stable")]
                own = labels[lo:hi] == c
                gts = boxes[lo:hi][own].astype(np.float64)
                g_hard, taken = hard[lo:hi][own], np.zeros(own.sum(), bool)
                for row in mine:
                    tp = 0
                    if len(gts):
                        b = np.clip(row[2:6].astype(np.float64), 0.0, 1.0)
                        iw = np.minimum(b[2], gts[:, 2]) - \
                            np.maximum(b[0], gts[:, 0])
                        ih = np.minimum(b[3], gts[:, 3]) - \
                            np.maximum(b[1], gts[:, 1])
                        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
                        union = (b[2] - b[0]) * (b[3] - b[1]) + \
                            (gts[:, 2] - gts[:, 0]) * \
                            (gts[:, 3] - gts[:, 1]) - inter
                        iou = np.where(union > 0, inter / np.where(
                            union > 0, union, 1), 0)
                        j = int(np.argmax(iou))
                        if iou[j] > overlap:
                            if g_hard[j]:
                                continue      # neither a hit nor a miss
                            tp, taken[j] = int(not taken[j]), True
                    scored.setdefault(int(c), []).append((row[1], tp))
    aps = []
    for c in sorted(positives):
        if c == 0 or not positives[c] or not scored.get(c):
            continue
        pairs = sorted(scored[c], key=lambda p: -p[0])
        tp = np.cumsum([t for _, t in pairs])
        fp = np.cumsum([1 - t for _, t in pairs])
        precision = tp / np.maximum(tp + fp, 1e-12)
        recall = tp / float(positives[c])
        best = np.array([precision[recall >= j / 10.0].max()
                         if (recall >= j / 10.0).any() else 0.0
                         for j in range(11)])
        aps.append(float(np.sum(best) / 11.0))
    return float(np.mean(aps)) if aps else 0.0


def _ssd_priors(main):
    """The prior count of ``main``'s ``prior_box`` ops (from their
    inferred ``[h, w, priors, 4]`` shapes)."""
    import numpy as np
    block = main.global_block()
    return sum(int(np.prod(block.var(op.output("Boxes")[0]).shape[:3]))
               for op in block.ops if op.type == "prior_box")


def _capi_rows(place_name, dirname, image):
    """The detection rows of ``image`` through the port's C inference
    ABI (``native.load_capi``, called with ``ctypes``): a predictor made
    by ``pd_tpu_create`` (no place: ``cuda:0``) or, with ``place_name``,
    ``pd_tpu_create_on``."""
    import ctypes
    import numpy as np
    from paddle_tpu_torch import native
    lib = native.load_capi()
    if lib.pd_tpu_init() != 0:
        raise AssertionError(f"capi: {lib.pd_tpu_last_error()}")
    h = lib.pd_tpu_create(dirname.encode()) if place_name is None else \
        lib.pd_tpu_create_on(dirname.encode(), place_name.encode())
    if not h:
        raise AssertionError(f"capi: {lib.pd_tpu_last_error()}")
    try:
        data = np.ascontiguousarray(image)
        shape = (ctypes.c_longlong * data.ndim)(*data.shape)
        res = lib.pd_tpu_run(
            h, 1, (ctypes.c_char_p * 1)(b"image"),
            (ctypes.c_void_p * 1)(data.ctypes.data_as(ctypes.c_void_p)),
            (ctypes.c_longlong * 1)(data.nbytes),
            (ctypes.POINTER(ctypes.c_longlong) * 1)(shape),
            (ctypes.c_int * 1)(data.ndim), (ctypes.c_char_p * 1)(b"float32"))
        if not res:
            raise AssertionError(f"capi: {lib.pd_tpu_last_error()}")
        try:
            if lib.pd_tpu_result_count(res) != 1:
                raise AssertionError("capi: one result a fetch expected")
            dims = tuple(lib.pd_tpu_result_dim(res, 0, d)
                         for d in range(lib.pd_tpu_result_rank(res, 0)))
            blen = ctypes.c_longlong()
            ptr = lib.pd_tpu_result_data(res, 0, ctypes.byref(blen))
            return np.frombuffer(ctypes.string_at(ptr, blen.value),
                                 lib.pd_tpu_result_dtype(res, 0).decode()
                                 ).reshape(dims)
        finally:
            lib.pd_tpu_free_result(res)
    finally:
        lib.pd_tpu_destroy(h)


def phase_ssd(cfg=SSD_VOC, place=None):
    """MobileNet-SSD on Pascal VOC (``SSD_VOC``: 300 x 300, 21 classes,
    the published widths, ``SSD_PRIORS`` priors, B 32) trains on
    ``place`` (the card) through ``layers``, ``RMSProp.minimize`` and
    ``Executor.run``: ``SSD_BATCHES`` seeded batches (static LoD feeds of
    1 to 8 boxes an image), ``SSD_PASSES`` passes, eager (the matching
    ops' LoD tables); every loss finite and the last pass's mean below
    the first's; no hand-written kernel.  Then ``detection_output`` and
    ``evaluator.DetectionMAP`` (11-point, difficult boxes not evaluated)
    over ``SSD_EVAL_BATCHES`` held-out batches: the streamed mAP equal to
    ``voc_map_recount`` of the fetched detections.  Then the test
    program's inference bundle (``save_inference_model``): the rows of
    ``load_inference_model`` + ``Executor.run``, of ``serving.Predictor``
    and of the C inference ABI (``native.load_capi``, ``ctypes``) on the
    same images identical.  Printed: ms a step, images/s, the state's
    GiB, the steps' peak above it."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import ALL_KERNELS

    place = place or pt.CUDAPlace(0)
    exe = pt.Executor(place)
    card = exe.device.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize()

    main, startup, test, net, nmsed, map_eval = ssd_programs(pt, cfg)
    priors = _ssd_priors(main)
    if cfg is SSD_VOC and priors != SSD_PRIORS:
        raise AssertionError(f"ssd: {priors} priors, not {SSD_PRIORS}")
    batches = ssd_batches(cfg, SSD_BATCHES, SEED)
    held = ssd_batches(cfg, SSD_EVAL_BATCHES, SEED + 1)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        sync()
        state_gib = sum(v.numel() * v.element_size()
                        for _, v in scope.items()
                        if isinstance(v, torch.Tensor)) / 2 ** 30
        if card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        for kern in ALL_KERNELS:
            kern.launches = 0
        losses, step_s = [], []
        for _ in range(SSD_PASSES):
            for feed in batches:
                sync()
                t = time.perf_counter()
                (loss,) = exe.run(main, feed=feed,
                                  fetch_list=[net["loss"]])
                sync()
                step_s.append(time.perf_counter() - t)
                losses.append(float(np.asarray(loss).reshape(())))
        _no_launches("ssd")
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 \
            if card else float("nan")
        map_eval.reset(exe)
        evaluated, t = [], time.perf_counter()
        for feed in held:
            dets, cur, accum = (np.asarray(v) for v in exe.run(
                test, feed=feed, fetch_list=[nmsed] + map_eval.metrics))
            evaluated.append((feed, dets, exe.last_fetch_lods[nmsed.name][0]))
        eval_s = time.perf_counter() - t
        _no_launches("ssd eval")
        dirname = os.path.join(OUT_DIR, "ssd_bundle")
        pt.io.save_inference_model(dirname, ["image"], [nmsed], exe,
                                   main_program=test)
    _graphs("ssd", exe, None)
    recount = voc_map_recount(evaluated)
    streamed = float(accum.reshape(()))
    if np.float32(recount) != np.float32(streamed):
        raise AssertionError(f"ssd: streamed mAP {streamed!r} != the "
                             f"recount {recount!r}")
    first, last = np.mean(losses[:SSD_BATCHES]), np.mean(losses[-SSD_BATCHES:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"ssd: losses {losses} not finite and falling")
    # serve the same images three ways
    image = held[0]["image"][:8]
    infer = pt.Executor(place)
    with pt.scope_guard(pt.Scope()):
        prog, _, fetches = pt.io.load_inference_model(dirname, infer)
        rows_exe = np.asarray(infer.run(prog, feed={"image": image},
                                        fetch_list=fetches)[0])
    rows_pred = np.asarray(serving.Predictor(dirname, place=place).run(
        {"image": image})[0])
    rows_capi = _capi_rows(None if card else "cpu", dirname, image)
    for what, rows in (("Predictor", rows_pred), ("C ABI", rows_capi)):
        if rows.shape != rows_exe.shape or not np.array_equal(rows,
                                                              rows_exe):
            raise AssertionError(f"ssd: {what} rows {rows.shape} differ from "
                                 f"Executor.run's {rows_exe.shape}")
    _no_launches("ssd serving")
    steady = float(np.mean(step_s[SSD_BATCHES:]))
    n_dets = sum(len(d) for _, d, _ in evaluated)
    log(f"ssd[MobileNet-SSD, VOC widths, {card_line() if card else 'cpu'}]:"
        f" {cfg['image']}x{cfg['image']}, {cfg['classes']} classes, "
        f"{priors} priors, B={cfg['batch']}, {SSD_BATCHES} batches x "
        f"{SSD_PASSES} passes: losses {[round(x, 3) for x in losses]} "
        f"(pass means {first:.3f} -> {last:.3f}); step ms "
        f"{[round(1e3 * x, 1) for x in step_s]}; steady (passes 2..) "
        f"{1e3 * steady:.3f} ms = {cfg['batch'] / steady:.1f} images/s; "
        f"state {state_gib:.4f} GiB, the steps' peak above what was "
        f"allocated before them {peak_gib:.4f} GiB; eval {len(held)} x "
        f"{cfg['batch']} images in {eval_s:.2f} s, {n_dets} detections, "
        f"streamed mAP {streamed:.6f} = the recount; served "
        f"{len(image)} images: {len(rows_exe)} rows identical through "
        f"Executor.run, Predictor and the C ABI")
    return dict(step_ms=1e3 * steady, images_per_s=cfg["batch"] / steady,
                state_gib=state_gib, peak_gib=peak_gib, losses=losses,
                first_step_ms=1e3 * step_s[0], map=streamed,
                detections=n_dets, served_rows=len(rows_exe),
                priors=priors, eval_s=eval_s)


def phase_card_vs_cpu_ssd(cfg=SSD_VOC, card_place=None):
    """One float32 RMSProp step of MobileNet-SSD at its full widths
    (``SSD_CARD_CPU_B`` images) from one startup state on the card and
    on the CPU, and on the CPU in float64.  The loss is held to
    ``CARD_CPU_LOSS_RTOL``; every parameter's grad, read against the
    float64 step, as ResNet-50's: the card's at most
    ``CARD_CPU_F64_FACTOR`` times as far from it as the CPU's, at the
    worst parameter and at the median.  The match indices must be equal;
    each image's negatives (``mine_hard_examples``) the same set, but
    where a prior that differs has a mining loss within ``SSD_TIE_RTOL``
    of the last one taken: a near tie, counted and printed."""
    import json as _json
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)

    cfg = dict(cfg, batch=SSD_CARD_CPU_B)
    main, startup, _, net, _, _ = ssd_programs(pt, cfg)
    main64 = pt.Program.from_dict(_json.loads(
        _json.dumps(main.to_dict()).replace('"float32"', '"float64"')))
    block = main.global_block()
    grads = sorted(op.input("Grad")[0] for op in block.ops
                   if op.type == "rmsprop")
    match = next(op for op in block.ops if op.type == "bipartite_match")
    mine = next(op for op in block.ops if op.type == "mine_hard_examples")
    extra = [match.output("ColToRowMatchIndices")[0],
             mine.output("NegIndices")[0], mine.input("ClsLoss")[0]]
    (feed,) = ssd_batches(cfg, 1, SEED + 2)
    def f64(v):
        if isinstance(v, tuple):
            return (f64(v[0]), v[1])
        return v.astype(np.float64) if v.dtype == np.float32 else v

    feed64 = {k: f64(v) for k, v in feed.items()}
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    state = {n: to_numpy(cpu_scope.find_var(n))
             for n in persistable_names(main)}
    state64 = {n: f64(v) for n, v in state.items()}
    fetch = [net["loss"].name] + extra + grads
    t = time.perf_counter()
    got = {"cpu": cpu.run(main, feed=feed, fetch_list=fetch,
                          scope=cpu_scope)}
    cpu_s = time.perf_counter() - t
    got["f64"] = cpu.run(main64, feed=feed64, fetch_list=fetch,
                         scope=scope_from_numpy(state64, pt.CPUPlace(),
                                                main64))
    got["card"] = pt.Executor(card_place).run(
        main, feed=feed, fetch_list=fetch,
        scope=scope_from_numpy(state, card_place, main))
    a, b = (float(np.asarray(got[k][0]).reshape(())) for k in ("card", "cpu"))
    if not np.array_equal(got["card"][1], got["cpu"][1]):
        raise AssertionError("card-vs-cpu[ssd]: match indices differ")
    ties = 0
    for i, (nc, nu, loss) in enumerate(zip(got["card"][2], got["cpu"][2],
                                            got["cpu"][3])):
        sc, su = set(nc[nc >= 0].tolist()), set(nu[nu >= 0].tolist())
        if sc == su:
            continue
        edge = float(loss[nu[nu >= 0][-1]])
        if any(abs(float(loss[p]) - edge) > SSD_TIE_RTOL * abs(edge)
               for p in sc ^ su):
            raise AssertionError(f"card-vs-cpu[ssd]: image {i}'s negatives "
                                 f"differ off a near tie: {sorted(sc ^ su)}")
        ties += 1

    def rel(x, y):
        """Each grad's distance from ``y``'s over its norm (0 where both
        are zero: a head no prior of the batch was matched to)."""
        out = []
        for g, w in zip(x[4:], y[4:]):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            norm = float(np.linalg.norm(w))
            diff = float(np.linalg.norm(g - w))
            if not norm > 0 and diff:
                raise AssertionError("card-vs-cpu[ssd]: a zero grad is "
                                     "nonzero on the other side")
            out.append(diff / norm if norm > 0 else 0.0)
        return np.asarray(out)

    r = rel(got["card"], got["cpu"])
    card64, cpu64 = rel(got["card"], got["f64"]), rel(got["cpu"], got["f64"])
    worst = int(np.argmax(r))
    log(f"card-vs-cpu[ssd] full widths B={cfg['batch']} f32: loss card "
        f"{a!r} cpu {b!r} (rel {abs(a - b) / abs(b):.2e}, bound "
        f"{CARD_CPU_LOSS_RTOL}); {len(grads)} grads |card - cpu| / |cpu| "
        f"worst {r[worst]:.3e} ({grads[worst]}), median {np.median(r):.3e};"
        f" from the CPU's float64 step: card worst {card64.max():.3e} "
        f"median {np.median(card64):.3e}, cpu worst {cpu64.max():.3e} "
        f"median {np.median(cpu64):.3e} (factor {CARD_CPU_F64_FACTOR}); "
        f"match indices equal; negatives equal in "
        f"{cfg['batch'] - ties} of {cfg['batch']} images, {ties} near ties;"
        f" cpu step {cpu_s:.2f} s")
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[ssd]: loss {a} vs {b}")
    if card64.max() > CARD_CPU_F64_FACTOR * cpu64.max() or \
            np.median(card64) > CARD_CPU_F64_FACTOR * np.median(cpu64):
        raise AssertionError(
            f"card-vs-cpu[ssd]: the card's float32 grads lie farther from "
            f"float64 than {CARD_CPU_F64_FACTOR} x the CPU's")
    return dict(loss_rel=abs(a - b) / abs(b), grad_rel=float(r[worst]),
                grad_rel_median=float(np.median(r)),
                card_f64=float(np.median(card64)),
                cpu_f64=float(np.median(cpu64)), negative_near_ties=ties)


#: a CSP program's run, joined within this many seconds (else the phase
#: fails)
CSP_TIMEOUT_S = 120


#: the CSP programs of ``tests/test_concurrency.py``, built with either
#: package's ``Go`` / ``Select`` / channels (``tests/test_torch_concurrency.py``
#: runs them in both, ``phase_csp`` on the card)

def _csp_var(pkg, hint, dtype="int64", persistable=False):
    block = pkg.default_main_program().current_block()
    v = block.create_var(name=pkg.unique_name(hint), dtype=dtype)
    v.persistable = persistable
    return v


def csp_simple_routine(pkg):
    L = pkg.layers
    ch = pkg.make_channel(dtype="float64")
    result = _csp_var(pkg, "return_value", "float64")
    with pkg.Go():
        pkg.channel_send(ch, L.fill_constant(shape=[1], dtype="float64",
                                             value=1234))
    result, _ = pkg.channel_recv(ch, result)
    pkg.channel_close(ch)
    return [result]


def csp_daisy_chain(pkg, n=20):
    """Go daisy chain (talks.golang.org/2012/concurrency.slide#39)."""
    L = pkg.layers
    leftmost = pkg.make_channel(dtype="int64")
    left = leftmost
    for _ in range(n):
        right = pkg.make_channel(dtype="int64")
        with pkg.Go():
            one = L.fill_constant(shape=[1], dtype="int64", value=1)
            result, _ = pkg.channel_recv(right, _csp_var(pkg, "return_value"))
            pkg.channel_send(left, L.elementwise_add(x=one, y=result))
        left = right
    with pkg.Go():
        pkg.channel_send(right, L.fill_constant(shape=[1], dtype="int64",
                                                value=1))
    out, _ = pkg.channel_recv(leftmost, _csp_var(pkg, "return_value"))
    return [out]


def csp_select_buffered_send(pkg):
    L = pkg.layers
    ch1 = pkg.make_channel(dtype="float64", capacity=1)
    result1 = _csp_var(pkg, "return_value", "float64")
    value = L.fill_constant(shape=[1], dtype="float64", value=10)
    with pkg.Select() as select:
        with select.case(pkg.channel_send, ch1, value):
            pass
        with select.default():
            pass
    result1, _ = pkg.channel_recv(ch1, result1)
    pkg.channel_close(ch1)
    return [result1]


def csp_fibonacci(pkg):
    """Go Fibonacci select example (tour.golang.org/concurrency/5)."""
    L = pkg.layers
    quit_input = _csp_var(pkg, "quit_ch_input", "int32", persistable=True)
    L.fill_constant(shape=[1], dtype="int32", value=0, out=quit_input)
    result = _csp_var(pkg, "result", "int32", persistable=True)
    L.fill_constant(shape=[1], dtype="int32", value=0, out=result)
    x = L.fill_constant(shape=[1], dtype="int32", value=0)
    y = L.fill_constant(shape=[1], dtype="int32", value=1)
    while_cond = L.fill_constant(shape=[1], dtype="bool", value=True)
    while_false = L.fill_constant(shape=[1], dtype="bool", value=False)
    x_tmp = L.fill_constant(shape=[1], dtype="int32", value=0)
    ch1 = pkg.make_channel(dtype="int32")
    quit_ch = pkg.make_channel(dtype="int32")
    with pkg.Go():
        for _ in range(10):
            pkg.channel_recv(ch1, result)
        pkg.channel_send(quit_ch, quit_input)
    while_op = L.While(cond=while_cond)
    with while_op.block():
        result2 = L.fill_constant(shape=[1], dtype="int32", value=0)
        with pkg.Select() as select:
            with select.case(pkg.channel_send, ch1, x, is_copy=True):
                L.assign(x, output=x_tmp)
                L.assign(y, output=x)
                L.assign(L.elementwise_add(x=x_tmp, y=y), output=y)
            with select.case(pkg.channel_recv, quit_ch, result2):
                L.assign(while_false, output=while_cond)
    pkg.channel_close(ch1)
    pkg.channel_close(quit_ch)
    return [result]


def csp_device_routine(pkg):
    """A routine that receives a tensor, runs device ops on it and sends
    the result back."""
    L = pkg.layers
    to_go = pkg.make_channel(dtype="float32")
    back = pkg.make_channel(dtype="float32")
    x = L.fill_constant(shape=[2, 3], dtype="float32", value=1.5)
    with pkg.Go():
        got, _ = pkg.channel_recv(to_go, _csp_var(pkg, "got", "float32"))
        pkg.channel_send(back, L.scale(L.elementwise_mul(got, got),
                                       scale=2.0))
    pkg.channel_send(to_go, x)
    out, _ = pkg.channel_recv(back, _csp_var(pkg, "out", "float32"))
    pkg.channel_close(to_go)
    pkg.channel_close(back)
    return [out]


def csp_run(pkg, build, place=None, timeout=60, return_numpy=True):
    """``build(pkg)`` in fresh programs, run once on ``place`` (the CPU
    by default) in a worker thread joined within ``timeout`` seconds:
    ``(fetches, main)``, the fetches numpy arrays (or, without
    ``return_numpy``, as the executor returns them); a routine that
    never ends fails."""
    import threading
    import numpy as np
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        fetch = build(pkg)
    exe = pkg.Executor(place or pkg.CPUPlace())
    out = {}

    def run():
        try:
            out["value"] = exe.run(main, fetch_list=fetch,
                                   scope=pkg.Scope(),
                                   return_numpy=return_numpy)
        except Exception as e:  # re-raised in the caller's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"{build.__name__}: no result in {timeout} s")
    if "error" in out:
        raise out["error"]
    if not return_numpy:
        return out["value"], main
    return [np.asarray(v) for v in out["value"]], main


def phase_csp(place=None):
    """The CSP programs of ``tests/test_concurrency.py`` (``csp_*``: the
    simple routine, the daisy chain of 20, ``select`` on a buffered
    channel, the fibonacci with ``select`` in a ``while``) and a ``go``
    body that runs device ops on a tensor it received through an
    unbuffered channel, on ``place`` (the card) and on the CPU: the
    fetches equal, each run joined within ``CSP_TIMEOUT_S``; the device
    routine's result a tensor on the card.  Nothing is caught: a timeout
    or an error fails the run."""
    import numpy as np
    import paddle_tpu_torch as pt

    place = place or pt.CUDAPlace(0)
    builds = [csp_simple_routine, csp_daisy_chain, csp_select_buffered_send,
              csp_fibonacci, csp_device_routine]
    out, t0 = {}, time.perf_counter()
    for build in builds:
        got, _ = csp_run(pt, build, place, timeout=CSP_TIMEOUT_S)
        want, _ = csp_run(pt, build, pt.CPUPlace(), timeout=CSP_TIMEOUT_S)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"csp[{build.__name__}]: card {got} != cpu "
                                 f"{want}")
        out[build.__name__] = np.asarray(got[0]).reshape(-1).tolist()[:6]
    (tensor,), _ = csp_run(pt, csp_device_routine, place,
                           timeout=CSP_TIMEOUT_S, return_numpy=False)
    if tensor.device.type != place.torch_device().type:
        raise AssertionError(f"csp: the routine's result is on "
                             f"{tensor.device}")
    _no_launches("csp")
    seconds = time.perf_counter() - t0
    log(f"csp[{card_line()}]: {json.dumps(out)} equal to the CPU's; "
        f"{seconds:.2f} s")
    return dict(programs=len(builds), seconds=seconds)


# ---------------------------------------------------------------------------
# control flow: the attention seq2seq and its beam decode
# ---------------------------------------------------------------------------

#: Seq2Seq-NMT-512's schedule: warm-up, timed steps on one batch, then
#: steps each on a new batch (a new LoD)
S2S_WARMUP, S2S_STEPS, S2S_RAGGED_STEPS = 2, 8, 4
#: the card-vs-CPU step: the model's default width, small dictionaries
S2S_CARD_CPU = dict(src_dict_size=100, trg_dict_size=100, emb_dim=32,
                    encoder_size=32, decoder_size=32, batch=4, src_max=12,
                    trg_max=12)
#: the beam decode at full width, and at tests/test_beam_search.py's
DECODE_FULL = dict(dict_size=30000, emb=512, hid=512, batch=16, beam=4,
                   steps=50)
DECODE_TEST = dict(dict_size=64, emb=16, hid=32, batch=4, beam=3, steps=5)
DECODE_SRC_LEN = 6
#: the least log-probability gap between the k-th and (k+1)-th
#: candidate that the card-vs-CPU decode accepts
DECODE_MARGIN = 1e-4


def _s2s_program(pt, cfg):
    """``(main, startup, cost)``: ``seq_to_seq_net`` at ``cfg``'s widths
    and ``Adam(cfg["lr"])``."""
    from paddle_tpu_torch.framework import unique_name_scope
    from paddle_tpu_torch.models import seq2seq as S
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name_scope("s2s_"), pt.program_guard(main, startup):
        cost, _ = S.seq_to_seq_net(
            cfg["src_dict_size"], cfg["trg_dict_size"], cfg["emb_dim"],
            cfg["encoder_size"], cfg["decoder_size"])
        pt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
    return main, startup, cost


def _s2s_batch(cfg, seed):
    from paddle_tpu_torch.models import seq2seq as S
    return S.fake_batch(cfg["batch"], cfg["src_max"], cfg["trg_max"],
                        cfg["src_dict_size"], cfg["trg_dict_size"],
                        seed=seed)


def phase_seq2seq():
    """Seq2Seq-NMT-512 trains on the card through ``seq_to_seq_net``,
    ``Adam.minimize`` and ``Executor.run`` fed ``(ids, lod)``:
    ``S2S_WARMUP + S2S_STEPS`` steps on one batch (loss finite, lower
    after the timed steps than at the first), then ``S2S_RAGGED_STEPS``
    steps each on a new batch (every loss finite, the scope holding each
    step's LoD); no hand-written kernel launched in the whole phase.
    Printed: the timed steps' ms (host clock, each ending in the loss's
    copy), target tokens/s (the batch's target rows over the step time,
    ``bench_seq2seq.py``'s unit), the ``while`` trips a step (the
    forward's and ``while_grad``'s re-run, each T masked trips for the
    longest target T), the device reads a step (no loop condition or
    array index: the fault word and the loss's copy), the peak
    allocation above the state, the ragged steps' ms; then the
    card-vs-CPU step (``phase_card_vs_cpu_seq2seq``)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import seq2seq as S

    cfg = S.SEQ2SEQ_NMT_512
    exe = pt.Executor()
    if exe.device != torch.device("cuda", 0):
        raise AssertionError(f"Executor landed on {exe.device}")
    for kern in ALL_KERNELS:
        kern.launches = 0
    main, startup, cost = _s2s_program(pt, cfg)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    feed = _s2s_batch(cfg, SEED)
    tokens = int(feed["trg_word"][0].shape[0])
    T = int(max(np.diff(feed["trg_word"][1][0])))
    losses, step_s, peaks = _timed_steps(exe, main, cost, scope, feed,
                                         S2S_WARMUP + S2S_STEPS)
    loop = dict(exe.last_run)
    _graphs("seq2seq", exe, False)    # the static LoD's tables: eager
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"seq2seq: losses {losses} not finite and "
                             f"lower at the end")
    # T masked trips (the step array holds T) and T in while_grad's
    # re-run; the conditions and indices stay on the device
    if loop != {"while_trips": 2 * T, "host_reads": 0}:
        raise AssertionError(f"seq2seq: {loop} for {T} target steps")
    timed = step_s[S2S_WARMUP:]
    steady = float(np.mean(timed))
    ragged_losses, ragged_s = [], []
    for i in range(S2S_RAGGED_STEPS):
        f = _s2s_batch(cfg, SEED + 1 + i)
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=f, fetch_list=[cost], scope=scope)
        ragged_s.append(time.perf_counter() - t)
        ragged_losses.append(float(np.asarray(loss).reshape(())))
        if scope.find_lod("trg_word") != f["trg_word"][1]:
            raise AssertionError(f"seq2seq: ragged step {i}: the scope holds "
                                 f"LoD {scope.find_lod('trg_word')}")
    if not all(np.isfinite(ragged_losses)):
        raise AssertionError(f"seq2seq: ragged losses {ragged_losses}")
    _no_launches("seq2seq")
    reads = loop["host_reads"] + 2   # the fault word and the loss's copy
    peak_above = max(peaks[S2S_WARMUP:]) / 2 ** 30
    log(f"seq2seq[Seq2Seq-NMT-512]: dict {cfg['src_dict_size']} emb/enc/dec "
        f"{cfg['emb_dim']} B={cfg['batch']} lengths 2..{cfg['trg_max']} "
        f"({tokens} target tokens, T {T}): losses "
        f"{[round(x, 6) for x in losses]}; step ms "
        f"{[round(1e3 * x, 3) for x in step_s]}; timed {1e3 * steady:.3f} ms "
        f"= {tokens / steady:.1f} target tokens/s; while trips a step "
        f"{loop['while_trips']}; device reads a step {reads} "
        f"(the fault word, the loss; {loop['host_reads']} loop conditions "
        f"and array indices); state "
        f"{state_gib:.3f} GiB, a step's peak above it "
        f"{[round(x / 2 ** 30, 4) for x in peaks]} GiB")
    log(f"seq2seq: {S2S_RAGGED_STEPS} ragged steps, each a new LoD: losses "
        f"{[round(x, 6) for x in ragged_losses]}, step ms "
        f"{[round(1e3 * x, 3) for x in ragged_s]}")
    out = dict(step_ms=1e3 * steady, target_tokens_per_s=tokens / steady,
               target_tokens=tokens, while_trips=loop["while_trips"],
               host_reads=reads, state_gib=state_gib,
               peak_above_state_gib=peak_above, losses=losses,
               ragged_step_ms=1e3 * float(np.mean(ragged_s)))
    del main, startup, scope
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = phase_card_vs_cpu_seq2seq()
    _no_launches("seq2seq card-vs-cpu")
    return out


def phase_card_vs_cpu_seq2seq():
    """One float32 Adam step of ``seq_to_seq_net`` at ``S2S_CARD_CPU``,
    from one scope, on the card and on the CPU: the loss to relative
    ``CARD_CPU_LOSS_RTOL`` (1e-5), every parameter's moments to
    ``CARD_CPU_GRAD_RTOL`` and every parameter element to what its
    grad's difference allows (``_adam_first_step_errors``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.models import seq2seq as S

    cfg = dict(S.SEQ2SEQ_NMT_512, **S2S_CARD_CPU)
    main, startup, cost = _s2s_program(pt, cfg)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n))
         for n in persistable_names(main)}, None, main)
    feed = _s2s_batch(cfg, SEED + 7)
    (cpu_loss,) = cpu.run(main, feed=feed, fetch_list=[cost],
                          scope=cpu_scope)
    (card_loss,) = pt.Executor().run(main, feed=feed, fetch_list=[cost],
                                     scope=card_scope)
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    block = main.global_block()
    adam = [op for op in block.ops if op.type == "adam"]
    if {op.input("Param")[0] for op in adam} != \
            {p.name for p in block.all_parameters()}:
        raise AssertionError("card-vs-cpu[seq2seq]: a parameter has no "
                             "adam op")
    rel, p_ratio = _adam_first_step_errors("seq2seq", adam, card_scope,
                                           cpu_scope, cfg["lr"])
    worst = max(rel, key=rel.get)
    worst_p = max(p_ratio, key=p_ratio.get)
    log(f"card-vs-cpu[seq2seq] width {cfg['emb_dim']} dict "
        f"{cfg['src_dict_size']} B={cfg['batch']} f32: loss card {a!r} cpu "
        f"{b!r} (rel {abs(a - b) / abs(b):.2e}, bound {CARD_CPU_LOSS_RTOL}); "
        f"moments |card - cpu| / |cpu| (the second halved) worst "
        f"{rel[worst]:.3e} ({worst}, bound {CARD_CPU_GRAD_RTOL}); "
        f"parameters |dp| / allowed worst {p_ratio[worst_p]:.3e} "
        f"({worst_p}, bound 1)")
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[seq2seq]: loss {a} vs {b}")
    if rel[worst] > CARD_CPU_GRAD_RTOL:
        raise AssertionError(f"card-vs-cpu[seq2seq]: {worst} differs by "
                             f"{rel[worst]} relative")
    if p_ratio[worst_p] > 1.0:
        raise AssertionError(f"card-vs-cpu[seq2seq]: parameter {worst_p} "
                             f"moved {p_ratio[worst_p]} x what its grad's "
                             f"difference allows")
    return dict(loss_rel=abs(a - b) / abs(b), moment_rel=rel[worst],
                param_ratio=p_ratio[worst_p])


#: the bucketed LoD mode at Seq2Seq-NMT-512: ``bench_seq2seq.py``'s
#: windows of 8 fresh batches, each one ``run_steps``
S2S_WINDOW = 8
S2S_WINDOWS = 2


def phase_seq2seq_buckets():
    """Seq2Seq-NMT-512 in the bucketed LoD mode: ``S2S_WINDOWS`` windows
    of ``S2S_WINDOW`` fresh batches (``bench_seq2seq.py``'s path), each
    one ``run_steps`` (the three LoD feeds padded to the window's
    buckets), then the first window again, from one startup state
    twice: the default path, where each
    bucket pair's step is a CUDA graph (its ``while`` a bounded loop of
    T_bucket masked trips, its tensor arrays device buffers; the first
    step eager, the second captured, then replays), and the eager step (a
    clone with ``_opt_interpret``).  The graphed losses equal the eager
    ones step by step or lie within ``BUCKET_LOSS_RTOL`` (the sequence
    ops' segment sums, ``lod.segment_sum``, add rows by float atomics),
    every loss finite, the repeated window's mean below its first
    pass's; no host read; the last step's ``while`` trips twice the
    repeated window's target length bucket (the loop and its grad's
    re-run); the step cache missed and the graphs number no more than
    the bucket pairs; the first window's batches once more as per-batch
    bucketed ``run``s of the eager step (each batch in its own buckets)
    from the same state, their losses within ``BUCKET_LOSS_RTOL`` of the
    window's; no hand-written kernel.  Printed: ms a batch both
    ways over the repeated window (graphed: replays only; a fresh
    bucket pair's window also pays an eager step and the capture),
    target tokens/s, capture seconds, graph nodes, peak allocated
    GiB."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.opt import clone_program
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import seq2seq as S

    cfg = S.SEQ2SEQ_NMT_512
    main, startup, cost = _s2s_program(pt, cfg)
    main.lod_buckets = True
    eager = clone_program(main)
    eager.lod_buckets = True
    eager._opt_interpret = True
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    batches = [[_s2s_batch(cfg, SEED + 50 * w + i)
                for i in range(S2S_WINDOW)] for w in range(S2S_WINDOWS)]
    batches.append(batches[0])
    windows = [({k: [b[k] for b in w]
                 for k in ("src_word", "trg_word", "label")}, w)
               for w in batches]
    pairs = {(_bucket_pairs(w, "src_word"), _bucket_pairs(w, "trg_word"))
             for w in batches}
    t_bucket = _bucket_pairs(batches[-1], "trg_word")[1]
    for kern in ALL_KERNELS:
        kern.launches = 0
    runs = {}
    for mode, program in (("graph", main), ("eager", eager)):
        scope = _scope_copy(pt, scope0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exe, losses, window_s, misses = _window_run(pt, program, cost,
                                                    scope, windows)
        stats = exe.graph_stats()
        runs[mode] = dict(
            losses=losses, misses=misses, graphs=len(stats),
            ms_per_batch=1e3 * window_s[-1] / S2S_WINDOW,
            first_window_s=window_s[0],
            peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            capture_s=sum(g["seconds"] for g in stats),
            nodes=[g["nodes"] for g in stats], loop=dict(exe.last_run))
        _graphs(f"seq2seq_buckets_{mode}", exe, mode == "graph")
        if misses > len(pairs) or len(stats) > len(pairs):
            raise AssertionError(
                f"seq2seq_buckets[{mode}]: {misses} cache misses and "
                f"{len(stats)} graphs for the bucket pairs {sorted(pairs)}")
        if runs[mode]["loop"] != {"while_trips": 2 * t_bucket,
                                  "host_reads": 0}:
            raise AssertionError(
                f"seq2seq_buckets[{mode}]: {runs[mode]['loop']} for the "
                f"target length bucket {t_bucket}")
        del exe, scope
    # the first window's batches as per-batch bucketed runs (each in its
    # own buckets), eager, from the same state: a fault in the slicing
    # of the ragged windows that the graphed and eager windows share
    exe = pt.Executor()
    scope = _scope_copy(pt, scope0)
    run_losses = []
    for b in batches[0]:
        (loss,) = exe.run(eager, feed=b, fetch_list=[cost], scope=scope)
        run_losses.append(np.float32(np.asarray(loss).reshape(())))
    _graphs("seq2seq_buckets_runs", exe, False)
    del exe, scope
    _no_launches("seq2seq_buckets")
    graph, base = runs["graph"], runs["eager"]
    run_rel = max(_loss_rel(run_losses, base["losses"][:S2S_WINDOW]))
    if run_rel > BUCKET_LOSS_RTOL:
        raise AssertionError(f"seq2seq_buckets: per-batch runs "
                             f"{run_losses} against the first window "
                             f"{base['losses'][:S2S_WINDOW]} (rel "
                             f"{run_rel}, bound {BUCKET_LOSS_RTOL})")
    identical = graph["losses"] == base["losses"]
    rel = max(_loss_rel(base["losses"], graph["losses"]))
    if rel > BUCKET_LOSS_RTOL:
        raise AssertionError(f"seq2seq_buckets: graphed losses "
                             f"{graph['losses']} against eager "
                             f"{base['losses']} (rel {rel}, bound "
                             f"{BUCKET_LOSS_RTOL})")
    losses = graph["losses"]
    first = float(np.mean(losses[:S2S_WINDOW]))
    again = float(np.mean(losses[-S2S_WINDOW:]))
    if not all(np.isfinite(losses)) or not again < first:
        raise AssertionError(f"seq2seq_buckets: losses {losses}: the "
                             f"repeated window's mean {again} against its "
                             f"first pass's {first}")
    last_tokens = sum(int(b["trg_word"][0].shape[0]) for b in batches[-1])
    for r in runs.values():
        r["target_tokens_per_s"] = last_tokens / (S2S_WINDOW *
                                                  r["ms_per_batch"] / 1e3)
    log(f"seq2seq_buckets[Seq2Seq-NMT-512]: {S2S_WINDOWS} + 1 windows of "
        f"{S2S_WINDOW} batches (the last the first again), buckets (src, "
        f"trg) {sorted(pairs)}: losses graphed {[float(x) for x in losses]};"
        f" bit-identical to eager: {identical} (rel max {rel:.3e}, bound "
        f"{BUCKET_LOSS_RTOL}); repeated window mean {again:.6f} against "
        f"{first:.6f}; the first window's batches as per-batch runs: rel "
        f"max {run_rel:.3e}; the repeated window: ms a batch graphed "
        f"{graph['ms_per_batch']:.3f} vs eager {base['ms_per_batch']:.3f} "
        f"= {graph['target_tokens_per_s']:.1f} vs "
        f"{base['target_tokens_per_s']:.1f} target tokens/s (first window "
        f"{graph['first_window_s']:.2f} / {base['first_window_s']:.2f} s); "
        f"capture {graph['capture_s']:.3f} s, nodes {graph['nodes']}; cache "
        f"misses {graph['misses']} / {base['misses']}; peak allocated "
        f"{graph['peak_allocated_gib']:.3f} / "
        f"{base['peak_allocated_gib']:.3f} GiB; last step: while trips "
        f"{graph['loop']['while_trips']}, host reads "
        f"{graph['loop']['host_reads']} (T_bucket {t_bucket})")
    out = {"bit_identical": identical, "loss_rel_max": rel,
           "runs_loss_rel_max": run_rel,
           "buckets": sorted(pairs), "t_bucket": t_bucket,
           "losses": [float(x) for x in losses]}
    for mode in ("graph", "eager"):
        r = runs[mode]
        out[mode] = {k: r[k] for k in (
            "ms_per_batch", "target_tokens_per_s", "first_window_s",
            "peak_allocated_gib", "capture_s", "nodes", "misses", "graphs",
            "loop")}
    del runs, scope0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def build_decode(pt, dict_size, emb, hid, batch, beam, steps):
    """``tests/test_beam_search.py``'s ``_build_decode`` with ``pt.layers``
    (an unrolled beam decode: reversed GRU encoder, the beams' memories
    tiled with ``expand`` and reordered with ``gather``, ``topk``,
    ``beam_search``, the step arrays and ``beam_search_decode``);
    returns ``(sentence ids, sentence scores)``."""
    import numpy as np
    layers, attr = pt.layers, pt.ParamAttr
    src = layers.data(name="src", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb],
                               param_attr=attr("src_emb_w"))
    enc_proj = layers.fc(input=src_emb, size=hid * 3,
                         param_attr=attr("enc_proj_w"), bias_attr=False)
    enc = layers.dynamic_gru(input=enc_proj, size=hid, is_reverse=True,
                             param_attr=attr("enc_gru_w"),
                             bias_attr=attr("enc_gru_b"))
    enc_last = layers.sequence_first_step(enc)
    mem = layers.reshape(
        layers.expand(layers.reshape(enc_last, shape=[batch, 1, hid]),
                      expand_times=[1, beam, 1]),
        shape=[batch * beam, hid])
    pre_ids = layers.assign(np.full((batch, beam), 1, "int64"))
    pre_scores = layers.assign(np.tile(
        np.array([[0.0] + [-1e9] * (beam - 1)], "float32"), (batch, 1)))
    beam_offset = layers.assign(
        (np.arange(batch, dtype="int64")[:, None] * beam).repeat(beam, 1))
    layers.zeros(shape=[1], dtype="int64")
    ids_arr = par_arr = None
    for t in range(steps):
        cur = layers.embedding(
            input=layers.reshape(pre_ids, shape=[batch * beam, 1]),
            size=[dict_size, emb], param_attr=attr("trg_emb_w"))
        dec_h = layers.fc(input=[cur, mem], size=hid, act="tanh",
                          param_attr=[attr("dec_fc_w_x"),
                                      attr("dec_fc_w_h")],
                          bias_attr=attr("dec_fc_b"))
        out = layers.fc(input=dec_h, size=dict_size, act="softmax",
                        param_attr=attr("dec_out_w"),
                        bias_attr=attr("dec_out_b"))
        probs = layers.reshape(out, shape=[batch, beam, dict_size])
        topk_scores, topk_idx = layers.topk(probs, k=beam)
        acc = layers.ops.log(topk_scores) + layers.reshape(
            pre_scores, shape=[batch, beam, 1])
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, topk_idx, acc, beam, end_id=0)
        mem = layers.gather(dec_h, layers.reshape(parent + beam_offset,
                                                  shape=[batch * beam]))
        it = layers.fill_constant(shape=[1], dtype="int64", value=t)
        if ids_arr is None:
            ids_arr = layers.array_write(sel_ids, i=it)
            par_arr = layers.array_write(parent, i=it)
        else:
            layers.array_write(sel_ids, i=it, array=ids_arr)
            layers.array_write(parent, i=it, array=par_arr)
        pre_ids, pre_scores = sel_ids, sel_scores
    return layers.beam_search_decode(ids_arr, par_arr, pre_scores,
                                     max_len=steps)


def _decode_program(pt, cfg):
    from paddle_tpu_torch.framework import unique_name_scope
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name_scope("dec_"), pt.program_guard(main, startup):
        sent, scores = build_decode(pt, **cfg)
    return main, startup, sent, scores


def _decode_probes(main):
    """Each step's ``top_k`` input and ``beam_search`` inputs."""
    ops = main.global_block().ops
    return ([op.input("X")[0] for op in ops if op.type == "top_k"],
            [[op.input(s)[0] for s in ("pre_ids", "pre_scores", "ids",
                                       "scores")]
             for op in ops if op.type == "beam_search"])


def beam_margins(probs, searches, k, end_id=0):
    """The least gap over the steps between the k-th and (k+1)-th largest
    log-probability of a row (``top_k``) and between the k-th and
    (k+1)-th candidate score of a batch row as ``beam_search`` ranks them
    (a finished beam offers its score once; exact -1e9 ties are broken
    by index on both devices and do not count)."""
    import numpy as np
    gap = np.inf
    for p in probs:
        top = np.log(-np.sort(-p.reshape(-1, p.shape[-1]), axis=1))
        gap = min(gap, float((top[:, k - 1] - top[:, k]).min()))
    for pre_ids, pre_scores, _, scores in searches:
        cand = scores.astype(np.float64).copy()
        done = pre_ids == end_id
        cand[done] = -1e9
        cand[done, 0] = pre_scores[done]
        flat = -np.sort(-cand.reshape(cand.shape[0], -1), axis=1)
        a, b = flat[:, k - 1], flat[:, k]
        real = a > -1e8
        if real.any():
            gap = min(gap, float((a - b)[real].min()))
    return gap


def _check_hypotheses(ids, scores, cfg, what):
    """Ids in the dictionary, ``end_id`` (0) on every step after a
    beam's first one, scores finite and best first."""
    import numpy as np
    B, K, T = cfg["batch"], cfg["beam"], cfg["steps"]
    if ids.shape != (B, K, T) or scores.shape != (B, K):
        raise AssertionError(f"{what}: shapes {ids.shape} {scores.shape}")
    if ids.min() < 0 or ids.max() >= cfg["dict_size"]:
        raise AssertionError(f"{what}: ids outside the dictionary")
    ended = np.cumsum(ids == 0, axis=2) > 0
    after = np.concatenate([np.zeros((B, K, 1), bool), ended[:, :, :-1]], 2)
    if np.any(after & (ids != 0)):
        raise AssertionError(f"{what}: a token after end_id")
    if not np.all(np.isfinite(scores)) or \
            np.any(np.diff(scores, axis=1) > 0):
        raise AssertionError(f"{what}: scores not finite and best first: "
                             f"{scores[:2]}")
    return int(ended[:, :, -1].sum())


def _decode_runs(pt, main, sent, scores, feed, scope_state, runs):
    """The decode ``runs`` times on a fresh card executor from
    ``scope_state`` (a scope, or numpy arrays for one): the last run's
    ``(ids, scores)``, each run's seconds (host clock; the fetch
    synchronizes) and the executor."""
    import torch
    from paddle_tpu_torch.convert import scope_from_numpy
    scope = scope_state if not isinstance(scope_state, dict) else \
        scope_from_numpy(scope_state, None, main)
    exe = pt.Executor()
    seconds, got = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = exe.run(main, feed=feed, fetch_list=[sent, scores],
                      scope=scope)
        seconds.append(time.perf_counter() - t)
    return got, seconds, exe


def phase_beam_decode():
    """The port's transcription of ``_build_decode`` (``build_decode``)
    two ways: with a static LoD on its source (the GRU encoder copies its
    tables from the host, so the decode stays eager), and with the source
    fed bucketed (``lod_buckets``: the encoder builds its tables on the
    device), so that the whole decode (50 unrolled steps of
    ``beam_search``, the step arrays as device buffers and
    ``beam_search_decode``'s gathers) is one CUDA graph.  At
    ``DECODE_FULL`` from a startup-initialised scope on the card: 3
    static decodes (eager, no graph), 4 bucketed decodes graphed (eager,
    captured, two replays) and 3 bucketed eager (a clone with
    ``_opt_interpret``): well-formed hypotheses every way, the same
    sentences and scores bucketed graphed and eager, ms a decode each
    way.  Then at ``DECODE_TEST`` from one scope (the output layer's
    weights scaled until the CPU's static decode has a least gap between
    the k-th and (k+1)-th candidate above ``DECODE_MARGIN`` at every
    step), the static decode on the CPU against the card's static,
    bucketed graphed and bucketed eager decodes: the same
    ``SentenceIds``, ``SentenceScores`` to relative 1e-5.  No
    hand-written kernel launched."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.opt import clone_program
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.kernels import ALL_KERNELS

    for kern in ALL_KERNELS:
        kern.launches = 0

    def programs(cfg):
        main, startup, sent, scores = _decode_program(pt, cfg)
        static = clone_program(main)
        main.lod_buckets = True
        eager = clone_program(main)
        eager.lod_buckets = True
        eager._opt_interpret = True
        return {"static": static, "graph": main, "eager": eager}, \
            startup, sent, scores

    cfg = DECODE_FULL
    progs, startup, sent, scores = programs(cfg)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    state = {n: to_numpy(scope.find_var(n))
             for n in persistable_names(progs["graph"])}
    del scope
    src = _s2s_batch(dict(src_dict_size=cfg["dict_size"],
                          trg_dict_size=cfg["dict_size"],
                          batch=cfg["batch"], src_max=50, trg_max=2),
                     SEED)["src_word"]
    feed = {"src": src}
    full = {}
    for mode, runs in (("static", 3), ("graph", 4), ("eager", 3)):
        (ids, sc), seconds, exe = _decode_runs(
            pt, progs[mode], sent, scores, feed, state, runs)
        _graphs(f"beam_decode_{mode}", exe, mode == "graph")
        ended = _check_hypotheses(ids, sc, cfg, f"beam_decode[full {mode}]")
        full[mode] = dict(ids=ids, scores=sc, seconds=seconds, ended=ended,
                          stats=exe.graph_stats(),
                          reads=exe.last_run["host_reads"])
        del exe
    graph, base = full["graph"], full["eager"]
    if graph["reads"] or not np.array_equal(graph["ids"], base["ids"]) or \
            not np.array_equal(graph["scores"], base["scores"]):
        raise AssertionError(
            f"beam_decode[full]: graphed sentences {graph['ids'][0]} scores "
            f"{graph['scores'][0]} against eager {base['ids'][0]} "
            f"{base['scores'][0]} ({graph['reads']} host reads)")
    (stats,) = graph["stats"]
    ms = {mode: 1e3 * float(np.mean(r["seconds"][-2:]))
          for mode, r in full.items()}
    static_same = bool(np.array_equal(full["static"]["ids"], graph["ids"]))
    del progs, startup, state

    cfg = DECODE_TEST
    progs, startup, sent, scores = programs(cfg)
    cpu, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    rng = np.random.RandomState(SEED)
    feed = {"src": (rng.randint(2, cfg["dict_size"], size=(
        cfg["batch"] * DECODE_SRC_LEN, 1)).astype("int64"),
        [list(range(0, cfg["batch"] * DECODE_SRC_LEN + 1,
                    DECODE_SRC_LEN))])}
    static = progs["static"]
    probs, searches = _decode_probes(static)
    fetch = [sent.name, scores.name] + probs + sum(searches, [])
    n = len(probs)
    state = {v: to_numpy(cpu_scope.find_var(v))
             for v in persistable_names(static)}
    w0, factor = state["dec_out_w"], 1.0
    for factor in (1.0, 4.0, 8.0, 16.0, 32.0):
        cpu_scope.set_var("dec_out_w",
                          torch.as_tensor(w0 * np.float32(factor)))
        want = cpu.run(static, feed=feed, fetch_list=fetch, scope=cpu_scope)
        gap = beam_margins(want[2:2 + n], [want[2 + n + 4 * i:6 + n + 4 * i]
                                           for i in range(len(searches))],
                           cfg["beam"])
        if gap > DECODE_MARGIN:
            break
    else:
        raise AssertionError(f"beam_decode: the CPU decode's least candidate "
                             f"gap is {gap} at every output scale")
    state["dec_out_w"] = w0 * np.float32(factor)
    rel = {}
    for mode, runs in (("static", 1), ("graph", 3), ("eager", 1)):
        program = progs[mode]
        got, _, exe = _decode_runs(pt, program, sent, scores, feed,
                                   scope_from_numpy(state, None, program),
                                   runs)
        _graphs(f"beam_decode_test_{mode}", exe, mode == "graph")
        _check_hypotheses(got[0], got[1], cfg, f"beam_decode[test {mode}]")
        if not np.array_equal(got[0], want[0]):
            raise AssertionError(f"beam_decode[{mode}]: card sentences "
                                 f"{got[0][0]} vs cpu {want[0][0]}")
        rel[mode] = float(np.max(np.abs(got[1] - want[1]) /
                                 np.abs(want[1])))
        if not rel[mode] <= 1e-5:
            raise AssertionError(f"beam_decode[{mode}]: scores differ by "
                                 f"{rel[mode]} relative")
    _no_launches("beam_decode")
    log(f"beam_decode[full]: dict {DECODE_FULL['dict_size']} emb/hid "
        f"{DECODE_FULL['emb']} B={DECODE_FULL['batch']} beam "
        f"{DECODE_FULL['beam']} {DECODE_FULL['steps']} steps: decode ms "
        f"static (eager) "
        f"{[round(1e3 * x, 3) for x in full['static']['seconds']]}, "
        f"bucketed graphed "
        f"{[round(1e3 * x, 3) for x in graph['seconds']]} (capture "
        f"{stats['seconds']:.3f} s, {stats['nodes']} nodes), bucketed "
        f"eager {[round(1e3 * x, 3) for x in base['seconds']]}; the last "
        f"two's means {ms['static']:.3f} / {ms['graph']:.3f} / "
        f"{ms['eager']:.3f}; beams ended {full['static']['ended']} / "
        f"{graph['ended']} / {base['ended']}; well formed, graphed equal "
        f"to eager; static sentences equal to bucketed: {static_same}")
    log(f"beam_decode[card-vs-cpu] dict {cfg['dict_size']} beam "
        f"{cfg['beam']} {cfg['steps']} steps: output weights x{factor}, CPU "
        f"static least candidate gap {gap:.3e} (bound {DECODE_MARGIN}); "
        f"sentences equal on the card static, bucketed graphed and eager, "
        f"scores rel {rel['static']:.2e} / {rel['graph']:.2e} / "
        f"{rel['eager']:.2e} (bound 1e-5)")
    return dict(decode_ms=ms["graph"], eager_decode_ms=ms["eager"],
                static_decode_ms=ms["static"], capture_s=stats["seconds"],
                nodes=stats["nodes"], beams_ended=graph["ended"],
                static_equal_bucketed=static_same, card_cpu_gap=gap,
                card_cpu_score_rel=max(rel.values()), output_scale=factor)


# ---------------------------------------------------------------------------
# phase 3: serving through the port's entry points
# ---------------------------------------------------------------------------

def phase_serving(paged=True):
    """Serve requests through ``GenScheduler`` on the card and hold the
    streams against the cache-free re-prefill: the paged decode (all of
    ``PROMPT_LENS``) or, with ``paged=False``, the dense decode (every
    third of them), whose decode step runs the bias-softmax kernel on a
    ``[S, 1, 1, L]`` row bias and no paged-decode kernel."""
    import numpy as np
    import torch
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.kernels import (ALL_KERNELS, BIAS_SOFTMAX,
                                          PAGED_DECODE)
    from paddle_tpu_torch.models import gen_lm
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig

    hp = GenLongConfig()
    tag = "serving" if paged else "dense decode"
    bundle = os.path.join(OUT_DIR, "gen_lm_long_bundle" if paged
                          else "gen_lm_long_dense_bundle")
    t0 = time.perf_counter()
    gen_lm.export_gen_model(bundle, hp, num_slots=NUM_SLOTS, paged=paged,
                            page_len=PAGE_LEN, seed=SEED)
    pred = GenPredictor(bundle)           # default place: cuda:0
    if pred.device.type != "cuda" or pred.paged != paged:
        raise AssertionError(f"GenPredictor landed on {pred.device}, "
                             f"paged={pred.paged}")
    log(f"{tag}: exported and loaded GenLongConfig bundle in "
        f"{time.perf_counter() - t0:.2f}s (max_len={hp.max_len}, "
        f"slots={NUM_SLOTS}" + (
            f", page_len={PAGE_LEN}, pages={pred.num_pages}, "
            f"buckets={pred.page_buckets})" if paged else ", dense cache)"))

    # warm the path once (first CUDA calls, library handles), outside
    # the counted run
    sched = GenScheduler(pred, queue_size=64)
    list(sched.submit([1, 2, 3], max_new_tokens=2))

    step_s = []
    decode = pred.decode_step

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = decode(*a, **kw)
        step_s.append(time.perf_counter() - t)
        return out

    pred.decode_step = timed_decode
    rng = np.random.RandomState(SEED)
    prompt_lens = PROMPT_LENS if paged else PROMPT_LENS[::3]
    prompts = [[int(t) for t in rng.randint(0, hp.vocab_size, n)]
               for n in prompt_lens]

    pre0, dec0 = pred.prefills, pred.decode_steps
    for kern in ALL_KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    streams = [sched.submit(p, max_new_tokens=MAX_NEW_TOKENS)
               for p in prompts]
    deadline = time.monotonic() + 300
    outs = []
    for st in streams:
        toks = []
        while True:
            ev = st.next_event(timeout=max(0.0, deadline - time.monotonic()))
            if ev is None:
                raise AssertionError(f"{tag}: a stream timed out")
            kind, value = ev
            if kind == "token":
                toks.append(value)
            elif kind == "done":
                break
            else:
                raise AssertionError(f"{tag}: stream failed: {value!r}")
        outs.append(toks)
    wall = time.perf_counter() - t0
    launches = {"bias_softmax": BIAS_SOFTMAX.launches,
                "paged_decode": PAGED_DECODE.launches}
    others = {k.name: k.launches for k in ALL_KERNELS
              if k.name not in launches and k.launches}
    prefills = pred.prefills - pre0
    steps = pred.decode_steps - dec0
    pred.decode_step = decode
    failed, crashes = sched.failed, sched.crashes
    sched.close()

    if failed is not None or crashes:
        raise AssertionError(f"{tag}: scheduler failed={failed!r} "
                             f"crashes={crashes}")
    bad = [st.error for st in streams if st.error is not None]
    if bad:
        raise AssertionError(f"{tag}: failed streams {bad!r}")
    if any(len(o) != MAX_NEW_TOKENS for o in outs):
        raise AssertionError(f"{tag}: token counts "
                             f"{[len(o) for o in outs]}")
    n_layer = int(hp.n_layer)
    # a prefill runs one bias softmax a layer; a decode step one paged
    # decode a layer, or (dense) one more bias softmax a layer
    want = {"bias_softmax": n_layer * (prefills if paged
                                       else prefills + steps),
            "paged_decode": n_layer * steps if paged else 0}
    if prefills != len(prompts) or steps <= 0 or launches != want or \
            others:
        raise AssertionError(
            f"{tag}: launches {launches} (and {others}) != expected {want} "
            f"(prefills={prefills}, decode steps={steps})")
    tokens = sum(len(o) for o in outs)
    log(f"{tag}: {len(prompts)} requests, prompt lens {list(prompt_lens)},"
        f" {tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tokens/s; "
        f"{steps} decode steps, mean step {1e3 * np.mean(step_s):.3f} ms "
        f"(median {1e3 * np.median(step_s):.3f} ms); launches {launches}")

    # acceptance: greedy streams equal the cache-free re-prefill
    for prompt, out in zip(prompts, outs):
        seq = list(prompt)
        for i, tok in enumerate(out):
            logits, _ = pred.prefill(seq)
            if logits.shape != (hp.vocab_size,) or \
                    not np.all(np.isfinite(logits)):
                raise AssertionError(f"{tag}: bad prefill logits")
            ref = int(np.argmax(logits))
            if ref != tok:
                raise AssertionError(
                    f"{tag}: prompt of {len(prompt)} diverges from the "
                    f"cache-free re-prefill at token {i}: {tok} != {ref}")
            seq.append(tok)
    _graphs(tag, pred._exe, True)
    log(f"{tag}: all {len(prompts)} streams token-identical to the "
        f"cache-free re-prefill (max total length "
        f"{max(len(p) for p in prompts) + MAX_NEW_TOKENS} of "
        f"{hp.max_len})")
    torch.cuda.synchronize()
    return launches, dict(tokens_per_s=tokens / wall,
                          decode_step_ms=1e3 * float(np.mean(step_s)),
                          bundle=bundle, prompts=prompts, streams=outs)


# ---------------------------------------------------------------------------
# phase 3b: the serving front over HTTP (InferenceServer, ServingClient,
# the MicroBatcher and the command line), on the card
# ---------------------------------------------------------------------------

#: every wait on a server (ready, a stream, a subprocess) is bounded
HTTP_WAIT_S = 300
#: ``bench_serving.py:28``'s model: feature 32, 12 ``fc`` 2048 + ReLU,
#: ``fc`` 4 (46.2 M parameters), float32; 8 closed-loop clients of one
#: row a request
PREDICT_FEATURE, PREDICT_HIDDEN, PREDICT_DEPTH = 32, 2048, 12
PREDICT_CLIENTS, PREDICT_REQUESTS = 8, 64
PREDICT_TOL = 1e-5
#: rounds of the ten streams over HTTP, each followed by a round of the
#: same prompts on the server's scheduler in process
HTTP_ROUNDS = 5
#: the resume drills slow each decode step by this much (the port's
#: ``gen.decode.stall`` failpoint) so a stream is still live when its
#: owner drains or aborts
RESUME_STALL_S = 0.02


def _http_status(addr, path):
    """Status of one GET (no retries; 599 when nothing answers)."""
    import http.client
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    except OSError:
        return 599
    finally:
        conn.close()


def _wait_ready(addr, server=None, proc=None):
    """Poll ``/readyz`` until it answers 200; returns the statuses seen
    in order.  Fails on a load error, a dead subprocess or the bound."""
    seen = []
    deadline = time.monotonic() + HTTP_WAIT_S
    while True:
        st = _http_status(addr, "/readyz")
        if not seen or seen[-1] != st:
            seen.append(st)
        if st == 200:
            return seen
        if server is not None and server.load_error is not None:
            raise AssertionError(f"{addr}: load failed: "
                                 f"{server.load_error!r}")
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{addr}: server exited with "
                                 f"{proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{addr}: not ready in {HTTP_WAIT_S}s "
                                 f"(statuses {seen})")
        time.sleep(0.01)


def _scheduler_events(sched, prompt):
    """One in-process stream of ``sched`` as ``ServingClient.generate``
    events: ``{"token": id}`` then one ``{"done": True, ...}``."""
    st = sched.submit(prompt, max_new_tokens=MAX_NEW_TOKENS)
    deadline = time.monotonic() + HTTP_WAIT_S
    while True:
        ev = st.next_event(timeout=max(0.0, deadline - time.monotonic()))
        if ev is None:
            raise AssertionError("an in-process stream timed out")
        kind, value = ev
        if kind == "token":
            yield {"token": value}
        elif kind == "done":
            yield {"done": True, "finish_reason": value}
            return
        else:
            raise value


def _concurrent_streams(open_stream, prompts):
    """Every prompt as its own stream (``open_stream(prompt)`` yields the
    stream's events), one thread each, all started together.  Returns
    the wall seconds and per prompt ``(start, token arrival times,
    tokens, tail event)``."""
    import threading
    results = [None] * len(prompts)

    def run(i):
        try:
            t, times, toks, tail = time.perf_counter(), [], [], None
            for ev in open_stream(prompts[i]):
                if "token" in ev:
                    times.append(time.perf_counter())
                    toks.append(ev["token"])
                elif ev.get("done"):
                    tail = ev
            results[i] = (t, times, toks, tail)
        except Exception as e:          # reported by the caller
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(1.0, t0 + HTTP_WAIT_S - time.perf_counter()))
    wall = time.perf_counter() - t0
    bad = [r for r in results if not isinstance(r, tuple)]
    if bad or any(th.is_alive() for th in threads):
        raise AssertionError(f"streams failed or hung: {bad}")
    return wall, results


def _stream_metrics(wall, results):
    """tokens/s, TTFT and inter-token gap percentiles (ms) of one round
    of ``_concurrent_streams``."""
    import numpy as np
    ttft = np.asarray([times[0] - t for t, times, _, _ in results])
    gaps = np.concatenate([np.diff(times) for _, times, _, _ in results])
    tokens = sum(len(toks) for _, _, toks, _ in results)
    return dict(tokens_per_s=tokens / wall,
                ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
                ttft_over_500ms=int(np.sum(ttft > 0.5)),
                gap_p50_ms=1e3 * float(np.percentile(gaps, 50)),
                gap_p99_ms=1e3 * float(np.percentile(gaps, 99)),
                gaps_over_30ms=int(np.sum(gaps > 0.030)))


def _spread(rounds):
    """Per metric of a list of ``_stream_metrics`` dicts: the median,
    the least and the most value over the rounds."""
    import numpy as np
    return {k: dict(median=float(np.median([r[k] for r in rounds])),
                    min=float(min(r[k] for r in rounds)),
                    max=float(max(r[k] for r in rounds)))
            for k in rounds[0]}


def _warmup_key(bucket):
    """``prefill[b]`` / ``decode[P]`` of one warmup report entry: its
    prompt bucket or its page bucket."""
    sig = bucket["signature"]
    if bucket["program"] == "prefill":
        return f"prefill[{sig['gen_ids'][1]}]"
    return f"decode[{sig['gen_page_table'][1]}]"


def phase_http_generate(serving):
    """``InferenceServer(bundle, warmup=True, async_load=True)`` on
    ``cuda:0`` over the paged GenLongConfig bundle of ``phase_serving``:
    ``/readyz`` turns 200 only once the warmup report lists every prompt
    bucket and every page bucket, nothing is built afterwards, the ten
    prompts as concurrent streamed ``ServingClient.generate`` calls give
    the in-process streams token for token, the two kernels launch
    ``prefills x n_layer`` and ``decode_steps x n_layer`` times, and
    later rounds of the same requests do not raise the peak allocation.

    ``HTTP_ROUNDS`` rounds over HTTP alternate with as many rounds of the
    same prompts submitted to the server's own scheduler in process (the
    yardstick); each kind reports the median, least and most value of
    every metric over its rounds.  The first HTTP round's launches are
    the path's count."""
    import torch
    from paddle_tpu_torch.kernels import ALL_KERNELS, build
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig
    from paddle_tpu_torch.profiler import runtime_metrics
    from paddle_tpu_torch.serving import InferenceServer, ServingClient

    prompts, want = serving["prompts"], serving["streams"]
    n_layer = int(GenLongConfig().n_layer)
    t0 = time.perf_counter()
    srv = InferenceServer(serving["bundle"], host="127.0.0.1", port=0,
                          warmup=True, async_load=True)
    srv.start_background()
    try:
        addr = f"127.0.0.1:{srv.addr[1]}"
        readyz = _wait_ready(addr, server=srv)
        ready_s = time.perf_counter() - t0
        builds_at_ready = dict(build.counts)
        client = ServingClient(addr, timeout=120)
        stats = client.stats()["server"]
        pred = srv.gen_predictor
        if pred.device.type != "cuda" or not pred.paged:
            raise AssertionError(f"http: predictor on {pred.device}, "
                                 f"paged={pred.paged}")
        report = stats["warmup"] or []
        got_pre = sorted(b["signature"]["gen_ids"][1] for b in report
                         if b["program"] == "prefill")
        got_dec = sorted(b["signature"]["gen_page_table"][1]
                         for b in report if b["program"] == "decode")
        want_pre = [b for b in pred.prompt_buckets if b <= pred.max_len]
        want_dec = [b for b in pred.page_buckets
                    if b <= pred.pages_per_slot]
        if got_pre != want_pre or got_dec != want_dec or \
                readyz[-1] != 200 or any(st not in (503, 200)
                                         for st in readyz):
            raise AssertionError(
                f"http: /readyz {readyz} with warmup prefill buckets "
                f"{got_pre} (want {want_pre}), decode page buckets "
                f"{got_dec} (want {want_dec})")
        warmup = {_warmup_key(b): (b["seconds"], b["cache"])
                  for b in report}
        # every prompt and page bucket is a captured CUDA graph by now
        graphs = pred._exe.graph_stats()
        captured = sum(1 for g in graphs if g["captures"])
        captures_at_ready = sum(g["captures"] for g in graphs)
        if captured != len(want_pre) + len(want_dec):
            raise AssertionError(
                f"http: {captured} signatures captured at /readyz, want "
                f"{len(want_pre)} prefill + {len(want_dec)} decode")
        log(f"http_generate: /readyz {readyz} after {ready_s:.3f}s; "
            f"warmup (s, cache) {warmup}; kernel builds "
            f"{builds_at_ready}; {captured} graphs captured "
            f"({sum(g['seconds'] for g in graphs):.3f} s)")

        kinds = {"http": lambda p: client.generate(
                     p, max_new_tokens=MAX_NEW_TOKENS),
                 # the server's own scheduler, without HTTP
                 "in_process": lambda p: _scheduler_events(srv._gen, p)}
        rounds = {kind: [] for kind in kinds}
        for r in range(HTTP_ROUNDS):
            for kind, open_stream in kinds.items():
                # cyclic garbage (an earlier phase's tensors held by a
                # reference cycle) is freed here, not mid-rounds, so the
                # rounds' allocations compare
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                runtime_metrics.reset()
                for kern in ALL_KERNELS:
                    kern.launches = 0
                pre0, dec0 = pred.prefills, pred.decode_steps
                wall, results = _concurrent_streams(open_stream, prompts)
                launches = _launch_counts()
                prefills = pred.prefills - pre0
                steps = pred.decode_steps - dec0
                torch.cuda.synchronize()
                if runtime_metrics.counter("compile.events"):
                    raise AssertionError(f"{kind} round {r}: a CUDA graph "
                                         f"was captured after /readyz")
                for i, (_, _, toks, tail) in enumerate(results):
                    if toks != want[i] or not tail or \
                            tail.get("finish_reason") != "length":
                        raise AssertionError(
                            f"{kind} round {r}: prompt of "
                            f"{len(prompts[i])} gave {toks} ({tail}), "
                            f"in-process {want[i]}")
                expect = {"bias_softmax": n_layer * prefills,
                          "paged_decode": n_layer * steps}
                if launches != expect or prefills != len(prompts):
                    raise AssertionError(
                        f"{kind} round {r}: launches {launches} != "
                        f"{expect} (prefills {prefills}, decode steps "
                        f"{steps})")
                step_s = runtime_metrics.snapshot()["series"].get(
                    "gen.decode_step_seconds", {})
                rounds[kind].append(dict(
                    _stream_metrics(wall, results),
                    decode_step_ms=1e3 * float(step_s.get("mean") or 0.0),
                    prefills=prefills, decode_steps=steps,
                    launches=launches,
                    peak=torch.cuda.max_memory_allocated(),
                    allocated=torch.cuda.memory_allocated()))
        if dict(build.counts) != builds_at_ready:
            raise AssertionError(f"http: kernels built after /readyz: "
                                 f"{builds_at_ready} -> {build.counts}")
        if sum(g["captures"] for g in pred._exe.graph_stats()) != \
                captures_at_ready:
            raise AssertionError("http: CUDA graphs captured after "
                                 "/readyz")
        _graphs("http_generate", pred._exe, True)
        http = rounds["http"]
        for later in http[1:]:
            if later["allocated"] != http[0]["allocated"] or \
                    later["peak"] - http[0]["peak"] > 2 ** 18:
                raise AssertionError(
                    f"http: memory grew over later rounds: peaks "
                    f"{[h['peak'] for h in http]}, allocated "
                    f"{[h['allocated'] for h in http]}")
    finally:
        srv.shutdown()

    out = dict(ready_s=ready_s, warmup=warmup, rounds=HTTP_ROUNDS,
               peak_mib=[h["peak"] / 2 ** 20 for h in http],
               graphs_at_ready=captured)
    for kind, rnds in rounds.items():
        out[kind] = _spread([{k: v for k, v in rnd.items()
                              if k not in ("launches", "peak",
                                           "allocated")}
                             for rnd in rnds])
    out["http_over_in_process_tokens_per_s"] = [
        h["tokens_per_s"] / i["tokens_per_s"]
        for h, i in zip(http, rounds["in_process"])]
    log(f"http_generate: {len(prompts)} concurrent streams token-identical "
        f"to the in-process ones in {HTTP_ROUNDS} rounds over HTTP and "
        f"{HTTP_ROUNDS} in process; first round's launches "
        f"{http[0]['launches']} ({http[0]['prefills']} prefills, "
        f"{http[0]['decode_steps']} decode steps); peak MiB "
        f"{out['peak_mib']}")
    return http[0]["launches"], out


def phase_http_resume(serving):
    """Two ``InferenceServer``s over the bundle on the one card and one
    ``ServingClient`` over both: the owner of a stream aborts its streams
    (a retryable error tail) and then, on a second stream, drains with
    ``deadline_s=0`` (a migrate tail); each time the client resumes on
    the other server and the finished stream equals the uninterrupted
    one."""
    from paddle_tpu_torch.fault import chaos
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.profiler import runtime_metrics
    from paddle_tpu_torch.serving import InferenceServer, ServingClient

    prompts, want = serving["prompts"], serving["streams"]
    servers = [InferenceServer(serving["bundle"], host="127.0.0.1",
                               port=0, warmup=True) for _ in range(2)]
    for srv in servers:
        srv.start_background()
    addrs = [f"127.0.0.1:{srv.addr[1]}" for srv in servers]
    preds = [srv.gen_predictor for srv in servers]
    for kern in ALL_KERNELS:
        kern.launches = 0
    pre0 = sum(p.prefills for p in preds)
    dec0 = sum(p.decode_steps for p in preds)
    drills = {}
    chaos.inject("gen.decode.stall", delay=RESUME_STALL_S)
    try:
        for kill, i in (("abort", 0), ("drain", 1)):
            client = ServingClient(addrs, timeout=120)
            resumes = runtime_metrics.counter("gen.session.resumes")
            events, killed = [], None
            t0 = time.perf_counter()
            for ev in client.generate(prompts[i],
                                      max_new_tokens=MAX_NEW_TOKENS):
                events.append(ev)
                if killed is None and \
                        sum("token" in e for e in events) == 4:
                    live = [k for k, s in enumerate(servers)
                            if s._gen.active_slots]
                    if len(live) != 1:
                        raise AssertionError(f"{kill} drill: live slots "
                                             f"on servers {live}")
                    killed = live[0]
                    owner = servers[killed]
                    if kill == "abort":
                        owner.abort_streams()
                    elif len(owner.drain_sessions(deadline_s=0)) != 1:
                        raise AssertionError("drain migrated no stream")
                if time.perf_counter() - t0 > HTTP_WAIT_S:
                    raise AssertionError(f"{kill} drill hung")
            toks = [e["token"] for e in events if "token" in e]
            idxs = [e["index"] for e in events if "token" in e]
            resumed = runtime_metrics.counter("gen.session.resumes") - \
                resumes
            if toks != want[i] or idxs != list(range(MAX_NEW_TOKENS)) or \
                    resumed != 1 or killed is None or \
                    events[-1].get("finish_reason") != "length":
                raise AssertionError(
                    f"{kill} drill: tokens {toks} (want {want[i]}), "
                    f"indices {idxs}, resumes {resumed}, tail "
                    f"{events[-1]}")
            drills[kill] = dict(owner=addrs[killed],
                                seconds=time.perf_counter() - t0)
    finally:
        chaos.clear("gen.decode.stall")
        for srv in servers:
            srv.shutdown()
    launches = _launch_counts()
    prefills = sum(p.prefills for p in preds) - pre0
    steps = sum(p.decode_steps for p in preds) - dec0
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig
    n_layer = int(GenLongConfig().n_layer)
    expect = {"bias_softmax": n_layer * prefills,
              "paged_decode": n_layer * steps}
    if launches != expect:
        raise AssertionError(f"http_resume: launches {launches} != "
                             f"{expect}")
    log(f"http_resume: abort and drain drills resumed on the other "
        f"server, token-identical ({drills}); launches {launches}")
    return launches, drills


def _predict_bundle(dirname):
    """``bench_serving.py``'s MLP, exported by the port from ``SEED``."""
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[PREDICT_FEATURE], dtype="float32")
        h = x
        for _ in range(PREDICT_DEPTH):
            h = pt.layers.fc(h, PREDICT_HIDDEN, act="relu")
        y = pt.layers.fc(h, 4)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(startup)
        pt.io.save_inference_model(dirname, ["x"], [y], exe, main)
    return dirname


def _closed_loop(addr, clients, requests):
    """``clients`` threads, each ``requests`` one-row ``/predict`` calls
    on its own keep-alive connection.  Returns the wall seconds and every
    ``(row, output)`` pair."""
    import http.client
    import threading

    import numpy as np
    host, port = addr.rsplit(":", 1)
    pairs = [None] * clients

    def run(c):
        rng = np.random.RandomState(SEED + c)
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        got = []
        try:
            for _ in range(requests):
                row = rng.randn(1, PREDICT_FEATURE).astype(np.float32)
                conn.request("POST", "/predict", json.dumps(
                    {"feeds": {"x": row.tolist()}}).encode(),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                if resp.status != 200:
                    raise AssertionError(f"/predict {resp.status}: {body}")
                got.append((row, np.asarray(body["outputs"][0],
                                            np.float32)))
            pairs[c] = got
        except Exception as e:      # reported by the caller
            pairs[c] = e
        finally:
            conn.close()

    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(1.0, t0 + HTTP_WAIT_S - time.perf_counter()))
    wall = time.perf_counter() - t0
    bad = [p for p in pairs if not isinstance(p, list)]
    if bad or any(th.is_alive() for th in threads):
        raise AssertionError(f"/predict clients failed or hung: {bad}")
    return wall, [pr for p in pairs for pr in p]


def phase_http_predict():
    """``/predict`` through the ``MicroBatcher`` at ``bench_serving.py``'s
    width on the card (float32, TF32 off): every reply equals a local
    ``Predictor.run`` of its row, batches hold more than one request, no
    hand-written kernel runs; rows/s batched and serialized."""
    import numpy as np
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.profiler import runtime_metrics
    from paddle_tpu_torch.serving import InferenceServer, Predictor

    bundle = _predict_bundle(os.path.join(OUT_DIR, "predict_mlp"))
    local = Predictor(bundle)
    out = {}
    for kern in ALL_KERNELS:
        kern.launches = 0
    for mode, batching in (("batched", True), ("serialized", False)):
        runtime_metrics.reset()
        srv = InferenceServer(bundle, host="127.0.0.1", port=0,
                              warmup=True, batching=batching,
                              max_batch_size=32)
        srv.start_background()
        try:
            addr = f"127.0.0.1:{srv.addr[1]}"
            _wait_ready(addr, server=srv)
            wall, pairs = _closed_loop(addr, PREDICT_CLIENTS,
                                       PREDICT_REQUESTS)
            occ = runtime_metrics.snapshot()["histograms"].get(
                "serving.batch_occupancy", {})
            _graphs(f"http_predict_{mode}", srv.predictor._exe, True)
        finally:
            srv.shutdown()
        err = 0.0
        for row, got in pairs:
            (ref,) = local.run({"x": row})
            np.testing.assert_allclose(got, ref, rtol=PREDICT_TOL,
                                       atol=PREDICT_TOL,
                                       err_msg=f"/predict {mode}")
            err = max(err, float(np.max(np.abs(got - ref))))
        out[mode] = dict(rows_per_s=len(pairs) / wall, max_abs_err=err)
        if batching:
            n = sum(occ.values())
            mean = sum(int(k) * v for k, v in occ.items()) / max(n, 1)
            if mean <= 1.0:
                raise AssertionError(f"/predict batch occupancy {occ}")
            out[mode]["occupancy"] = dict(occ, mean=mean)
    _no_launches("http_predict")
    log(f"http_predict: {PREDICT_CLIENTS} clients x {PREDICT_REQUESTS} "
        f"rows, replies equal Predictor.run (max abs err "
        f"{max(o['max_abs_err'] for o in out.values()):.3e}); "
        f"rows/s batched {out['batched']['rows_per_s']:.1f} "
        f"(occupancy {out['batched']['occupancy']}), serialized "
        f"{out['serialized']['rows_per_s']:.1f}")
    return out


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


#: ``phase_cli``'s ``train --config`` script: route A at 1 layer a stack
#: (Transformer-base widths, S 256, B 64, bf16 AMP, Adam, dropout 0.1)
#: through ``run_pipeline`` with a ``RunLedger`` in the directory
#: ``--checkpoint-dir`` exports; argv: B S steps seed keys
CLI_TRAIN_SCRIPT = r'''
import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.datapipe as dp
from paddle_tpu_torch.fault import manager_from_env
from paddle_tpu_torch.kernels import ALL_KERNELS
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.obs.ledger import RunLedger

torch.backends.cuda.matmul.allow_tf32 = False
B, S, steps, seed = (int(a) for a in sys.argv[1:5])
keys = sys.argv[5].split(",")
hp = T.ModelHyperParams()
hp.max_length = max(hp.max_length, S)
hp.n_layer = 1
main, startup = pt.Program(), pt.Program()
main.random_seed = startup.random_seed = seed
with pt.program_guard(main, startup):
    cost, _ = T.transformer(B, S, S, hp)
    pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
main.amp = True
exe, scope = pt.Executor(), pt.Scope()
exe.run(startup, scope=scope)
rows = T.fake_batch(B * steps, S, S, hp, seed=seed % 2 ** 31)
samples = [{k: rows[k][i] for k in keys} for i in range(B * steps)]
pipe = (dp.InMemorySource(samples).shuffle(B, seed=seed)
        .map(dict, workers=2).batch(B, drop_last=True).prefetch(depth=2))
mgr = manager_from_env(executor=exe, main_program=main, scope=scope)
ledger = RunLedger(mgr.dirname)
mgr.datapipe, mgr.ledger = pipe, ledger
outs = []
for _ in range(int(os.environ.get("PADDLE_NUM_PASSES", "1"))):
    outs += exe.run_pipeline(
        main, pipe, fetch_list=[cost], scope=scope, ledger=ledger,
        on_step=lambda s, f: s == steps - 1 and mgr.save(len(outs) + s))
ledger.close()
print(json.dumps({
    "losses": [float(np.asarray(o[0]).reshape(())) for o in outs],
    "keep": mgr.keep, "steps": mgr.steps(),
    "launches": {k.name: k.launches for k in ALL_KERNELS if k.launches},
    "graphs": [(g["captures"], g["replays"]) for g in exe.graph_stats()]}))
'''
#: its batches a pass
CLI_TRAIN_STEPS = 4


def _cli_train_infer(env):
    """Start ``version``, ``train --config`` and ``infer --place cuda``
    as concurrent subprocesses; returns them and ``finish()``, which
    waits for them and checks: the version line names the card; the train script's
    loop (1-layer route A, ``manager_from_env``, ``run_pipeline`` and a
    ``RunLedger`` under the checkpoint directory D) launches the
    bias-softmax pair 3 times a step through one graph, and ``runs show
    D --json`` / ``runs tail D -n 3`` print its rows; the saved MLP
    (``_predict_bundle``) through ``infer`` equals this process's run of
    it to ``PREDICT_TOL``.  ``finish()`` returns the launches of the
    train script and a report."""
    import shutil
    import numpy as np
    B, S, kernels = ROUTES["A"]
    root = os.path.join(OUT_DIR, "cli_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    script = os.path.join(root, "train_route_a.py")
    with open(script, "w") as f:
        f.write(CLI_TRAIN_SCRIPT)
    model = _predict_bundle(os.path.join(root, "model"))
    x = np.random.RandomState(SEED % 2 ** 31).rand(
        8, PREDICT_FEATURE).astype("float32")
    np.save(os.path.join(root, "x.npy"), x)
    ckdir = os.path.join(root, "ckpt")
    cmd = [sys.executable, "-m", "paddle_tpu_torch"]
    jobs = {
        "version": cmd + ["version"],
        "train": cmd + ["train", "--config", script, "--num-passes", "1",
                        "--checkpoint-dir", ckdir, "--keep-checkpoints",
                        "2", str(B), str(S), str(CLI_TRAIN_STEPS),
                        str(SEED), ",".join(READER_KEYS)],
        "infer": cmd + ["infer", "--model", model, "--feed",
                        f"x={os.path.join(root, 'x.npy')}", "--output",
                        root, "--place", "cuda"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in jobs.items()}
    # each job's output and its own wall seconds, taken by a reader
    # thread (the server part runs meanwhile)
    ends = {}

    def reap(k, proc):
        try:
            out, err = proc.communicate(timeout=HTTP_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        ends[k] = (out, err, time.perf_counter() - t0)

    readers = [threading.Thread(target=reap, args=kv, daemon=True)
               for kv in procs.items()]
    for r in readers:
        r.start()
    return procs, lambda: _cli_jobs_finish(procs, readers, ends, root,
                                           model, ckdir, x, kernels)


def _cli_jobs_finish(procs, readers, ends, root, model, ckdir, x,
                     kernels):
    """The checks of :func:`_cli_train_infer`'s jobs."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import cli
    done, seconds = {}, {}
    for r in readers:
        r.join(HTTP_WAIT_S + 30)
    for k, proc in procs.items():
        if k not in ends or proc.returncode != 0:
            out, err, _ = ends.get(k, ("", "", None))
            raise AssertionError(f"cli {k} (exit {proc.returncode}): "
                                 f"{out[-2000:]!r} {err[-2000:]!r}")
        done[k], _, seconds[k] = ends[k]
    name = torch.cuda.get_device_name(0)
    if name not in done["version"] or "torch" not in done["version"]:
        raise AssertionError(f"cli version: {done['version']!r}")
    report = json.loads(done["train"].strip().splitlines()[-1])
    losses = report["losses"]
    want = {k: 3 * CLI_TRAIN_STEPS for k in kernels}
    if report["launches"] != want or report["graphs"] != \
            [[1, CLI_TRAIN_STEPS - 1]] or report["keep"] != 2 or \
            report["steps"] != [CLI_TRAIN_STEPS - 1] or \
            len(losses) != CLI_TRAIN_STEPS or \
            not np.all(np.isfinite(losses)):
        raise AssertionError(f"cli train: {report}")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc_show = cli.main(["runs", "show", ckdir, "--json"])
    show = json.loads(buf.getvalue())
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc_tail = cli.main(["runs", "tail", ckdir, "-n", "3"])
    tail = buf.getvalue().strip().splitlines()
    header = tail[0].split()
    tail_steps = [int(line.split()[0]) for line in tail[1:]]
    tail_losses = [float(line.split()[header.index("loss")])
                   for line in tail[1:]]
    if rc_show or rc_tail or show["rows"] != CLI_TRAIN_STEPS or \
            show["fields"]["loss"]["first"] != losses[0] or \
            show["fields"]["loss"]["last"] != losses[-1] or \
            tail_steps != list(range(CLI_TRAIN_STEPS))[-3:] or \
            not np.allclose(tail_losses, losses[-3:], rtol=1e-5):
        raise AssertionError(f"cli runs: show {show}, tail {tail}")
    (out_file,) = [f for f in os.listdir(root) if f.endswith(".npy")
                   and f != "x.npy"]
    got = np.load(os.path.join(root, out_file))
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        prog, _, fetches = pt.io.load_inference_model(model, exe)
        (want_y,) = exe.run(prog, feed={"x": x}, fetch_list=fetches)
    err = float(np.abs(got - want_y).max())
    if got.shape != (8, 4) or err > PREDICT_TOL:
        raise AssertionError(f"cli infer: {got.shape}, max abs err {err}")
    shutil.rmtree(root, ignore_errors=True)
    return report["launches"], dict(
        version=done["version"].strip(), train_losses=losses,
        runs_rows=show["rows"], infer_max_abs_err=err,
        seconds={k: round(v, 3) for k, v in seconds.items()})



def phase_cli(serving):
    """``python -m paddle_tpu_torch serve --model <bundle> --warmup`` in a
    subprocess, then ``generate`` against it (the first prompt's
    in-process stream) and ``stats``; the server is terminated and every
    wait bounded.  Beside them, ``version``, ``train --config`` and
    ``infer`` (:func:`_cli_train_infer`; their subprocesses start first,
    so the server's ``ready_s`` is taken beside them); ``trace dump`` and
    ``bench record`` / ``check`` run in ``phase_datapipe_train``, over
    its spans and figures."""
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    jobs, finish = _cli_train_infer(env)
    try:
        return _cli_serve(serving, addr, port, env, finish)
    finally:
        for job in jobs.values():      # a failed serve check leaves them
            if job.poll() is None:
                job.kill()
                job.wait()


def _cli_serve(serving, addr, port, env, finish):
    """``phase_cli``'s server part, then ``finish()`` of its jobs."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch"]
    log_path = os.path.join(OUT_DIR, "cli_serve.log")
    with open(log_path, "w") as server_log:
        proc = subprocess.Popen(
            cmd + ["serve", "--model", serving["bundle"], "--warmup",
                   "--port", str(port)], cwd=ROOT, env=env,
            stdout=server_log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        _wait_ready(addr, proc=proc)
        ready_s = time.perf_counter() - t0
        gen = subprocess.run(
            cmd + ["generate", "--addr", addr, "--prompt",
                   " ".join(map(str, serving["prompts"][0])), "--max-new",
                   str(MAX_NEW_TOKENS)], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=HTTP_WAIT_S)
        toks = [int(line) for line in gen.stdout.split()
                if line.lstrip("-").isdigit()]
        if gen.returncode != 0 or toks != serving["streams"][0]:
            raise AssertionError(f"cli generate (exit {gen.returncode}): "
                                 f"{gen.stdout!r} {gen.stderr!r}")
        stats = subprocess.run(
            cmd + ["stats", "--addr", addr], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=HTTP_WAIT_S)
        if stats.returncode != 0 or "gen.tokens" not in stats.stdout:
            raise AssertionError(f"cli stats (exit {stats.returncode}): "
                                 f"{stats.stdout!r} {stats.stderr!r}")
        warm = [line for line in stats.stdout.splitlines()
                if line.startswith("server:")]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    cache = sorted(set(re.findall(r"'cache': '([a-z-]+)'",
                                  warm[0] if warm else "")))
    log(f"cli: serve ready in {ready_s:.2f}s (warmup cache {cache}), "
        f"generate printed the in-process stream, stats ok, server "
        f"exited {proc.returncode}")
    launches, more = finish()
    log(f"cli: {more['version']!r}; train --config (1-layer route A "
        f"through run_pipeline, {CLI_TRAIN_STEPS} steps, losses "
        f"{more['train_losses']}) and runs show / tail agree; infer "
        f"--place cuda max abs err {more['infer_max_abs_err']:.3e}; "
        f"seconds {more['seconds']}")
    return launches, dict(ready_s=ready_s, warmup_cache=cache, **more)


# ---------------------------------------------------------------------------
# phase 11: static analysis, the optimization pipeline and the switches of
# the executor (PADDLE_TPU_OPT, PADDLE_TPU_VERIFY, check_nan_inf) on the
# card, and the serving front with a prefill budget
# ---------------------------------------------------------------------------

#: optimized and unoptimized route A losses agree step by step to this
#: (relative): the passes keep every op that runs and its RNG slot, but a
#: constant folded on the host in numpy may round apart from the card
TRAIN_OPT_LOSS_RTOL = 1e-6
#: steps a run of the check_nan_inf comparison (the first is warm-up)
NAN_CHECK_STEPS = 3
#: pairs of steps, unchecked then checked on one executor, whose medians
#: give the check's overhead (a route A step's host time moves by tens
#: of ms from one step to the next)
NAN_CHECK_TIMED_PAIRS = 8


def _scope_copy(pt, scope):
    """A new Scope holding a copy of every tensor of ``scope``."""
    import torch
    out = pt.Scope()
    for name, value in scope.items():
        out.set_var(name, value.clone() if isinstance(value, torch.Tensor)
                    else value)
    return out


def _train_run(pt, main, cost, scope, feed, steps):
    """``steps`` steps of ``main`` on a fresh ``Executor`` (so its run
    counter, and so its dropout masks, start where another run's do);
    returns the executor, the float32 losses and each step's seconds."""
    import numpy as np
    exe = pt.Executor()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)   # the fetch synchronizes
        losses.append(np.float32(np.asarray(loss).reshape(())))
    return exe, losses, step_s


def _loss_rel(a, b):
    import numpy as np
    return [float(abs(np.float64(x) - np.float64(y)) /
                  max(abs(np.float64(x)), 1e-30)) for x, y in zip(a, b)]


def phase_train_opt(route):
    """Transformer-base route ``route`` (dropout 0.1, bf16 AMP, Adam)
    from one startup state, ``TRAIN_STEPS`` steps unoptimized and
    ``TRAIN_STEPS`` under ``PADDLE_TPU_OPT=1 PADDLE_TPU_VERIFY=1`` (set
    here, restored after), each on a fresh executor: the losses agree
    step by step to ``TRAIN_OPT_LOSS_RTOL``, no pass is aborted, and each
    run launches exactly its route's kernels 18 times a step and nothing
    else.  Prints the op counts, every pass's stats, the optimize and
    verify seconds, the steady step both ways and the static FLOPs'
    share of the card's bf16 dense peak.  Returns the optimized run's
    launches and, for ``phase_check_nan_inf``, the program and its
    state."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import cost as _cost
    from paddle_tpu_torch.analysis.opt import optimize_program
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S, kernels = ROUTES[route]
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    feed = T.fake_batch(B, S, S, hp, seed=SEED)
    feeds, fetches = tuple(feed), (cost.name,)
    t = time.perf_counter()
    analysis.verify_program(main, feed_names=feeds, fetch_names=fetches)
    verify_s = time.perf_counter() - t
    t = time.perf_counter()
    optimized, report = optimize_program(main, feed_names=feeds,
                                         fetch_names=fetches)
    opt_s = time.perf_counter() - t
    if report.aborted_passes:
        raise AssertionError(f"train_opt[{route}]: passes aborted "
                             f"{report.aborted_passes}:\n{report.format()}")
    flops = _cost.estimate(main).total_flops
    types = [op.type for op in optimized.global_block().ops]
    # a softmax and its grad an attention: 3 a layer (encoder self,
    # decoder self, cross), 18 at Transformer-base's 6 + 6
    per_step = 3 * int(hp.n_layer)
    if types.count("softmax") != per_step or \
            types.count("softmax_grad") != per_step:
        raise AssertionError(f"train_opt[{route}]: the optimized program "
                             f"lost a softmax or its grad")
    log(f"train_opt[{route}]: ops {report.ops_before} -> "
        f"{report.ops_after}; optimize {opt_s:.3f}s, verify "
        f"{verify_s:.4f}s; static FLOPs a step {flops:,}")
    for p in report.passes:
        log(f"  pass {p['pass']}: {p['status']} ops {p['ops_before']} -> "
            f"{p['ops_after']} {p['stats']}")
    log(f"  aborted passes: {report.aborted_passes}")

    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    want = {k: TRAIN_STEPS * per_step for k in kernels}
    runs = {}
    saved = {k: os.environ.get(k) for k in ("PADDLE_TPU_OPT",
                                            "PADDLE_TPU_VERIFY")}
    try:
        for mode in ("plain", "opt"):
            for k in saved:
                if mode == "opt":
                    os.environ[k] = "1"
                else:
                    os.environ.pop(k, None)
            scope = _scope_copy(pt, scope0)
            torch.cuda.synchronize()
            for kern in ALL_KERNELS:
                kern.launches = 0
            exe, losses, step_s = _train_run(pt, main, cost, scope, feed,
                                             TRAIN_STEPS)
            launches = _launch_counts()
            if launches != want:
                raise AssertionError(f"train_opt[{route}] {mode}: launches "
                                     f"{launches} != {want}")
            if mode == "opt":
                ran = [p for k, p in exe._opt_cache.items()
                       if k[0] == id(main)]
                if len(ran) != 1 or len(ran[0].global_block().ops) != \
                        report.ops_after or not exe._verified:
                    raise AssertionError(
                        f"train_opt[{route}]: the executor did not run the "
                        f"optimized, verified program")
            _graphs(f"train_opt_{route}_{mode}", exe, True)
            runs[mode] = dict(losses=losses, step_s=step_s,
                              launches=launches)
            del scope, exe
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    plain, opt = runs["plain"], runs["opt"]
    rel = _loss_rel(plain["losses"], opt["losses"])
    if not all(np.isfinite(plain["losses"])) or \
            max(rel) > TRAIN_OPT_LOSS_RTOL:
        raise AssertionError(f"train_opt[{route}]: losses {plain['losses']} "
                             f"and optimized {opt['losses']} (rel {rel})")
    identical = [bool(a == b) for a, b in zip(plain["losses"],
                                              opt["losses"])]
    out = dict(ops_before=report.ops_before, ops_after=report.ops_after,
               passes={p["pass"]: p["stats"] for p in report.passes},
               aborted=report.aborted_passes, optimize_s=opt_s,
               verify_s=verify_s, flops=flops, loss_rel_max=max(rel),
               bit_identical=all(identical))
    for mode, r in runs.items():
        steady = _steady(r["step_s"], True)
        out[f"{mode}_step_ms"] = 1e3 * steady
        out[f"{mode}_flops_share"] = flops / steady / BF16_TC_OPS_PER_S
    log(f"train_opt[{route}]: losses {[float(x) for x in plain['losses']]}"
        f" and optimized {[float(x) for x in opt['losses']]}: rel max "
        f"{max(rel):.3e}, bit-identical {identical}; steady step "
        f"{out['plain_step_ms']:.2f} ms unoptimized, {out['opt_step_ms']:.2f}"
        f" ms optimized; static FLOPs share of "
        f"{BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s bf16: "
        f"{100 * out['plain_flops_share']:.3f}% / "
        f"{100 * out['opt_flops_share']:.3f}%; launches {opt['launches']}")
    torch.cuda.empty_cache()
    state = dict(main=main, cost=cost, feed=feed, scope=scope0,
                 kernels=kernels, per_step=per_step)
    return opt["launches"], out, state


def _tiny_program(pt, vars_, ops):
    return pt.Program.from_dict(
        {"blocks": [{"idx": 0, "parent_idx": -1, "vars": vars_,
                     "ops": ops}]})


#: float -> int casts the saturating ``cast`` must give alike on the card
#: and the CPU (and as the JAX package's XLA convert does)
SATURATING_CASTS = {
    "int32": [float("nan"), float("inf"), -float("inf"), 2.5e9, -2.5e9,
              7.9],
    "uint8": [-1.0, 300.0, 254.7, float("nan")],
}


def phase_check_nan_inf(state):
    """``check_nan_inf`` and the repaired index and cast ops on the card:
    a route A run with the mode on gives the unchecked run's losses (its
    steady step beside the plain one, and the medians of steps that
    alternate the two on one executor); ``log(x)`` at x = -1 raises naming
    the variable; ``gather`` / ``lookup_table`` at index -1 and at ``n``
    give the last row and NaN rows with no device-side assert, and the
    next ``Executor.run`` in this process still works; a saturating
    ``cast`` equals the CPU's."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS

    main, cost, feed = state["main"], state["cost"], state["feed"]
    want = {k: NAN_CHECK_STEPS * state["per_step"]
            for k in state["kernels"]}
    runs = {}
    for mode in ("plain", "check"):
        main.check_nan_inf = mode == "check"
        scope = _scope_copy(pt, state["scope"])
        torch.cuda.synchronize()
        for kern in ALL_KERNELS:
            kern.launches = 0
        _, losses, step_s = _train_run(pt, main, cost, scope, feed,
                                       NAN_CHECK_STEPS)
        launches = _launch_counts()
        if launches != want:
            raise AssertionError(f"check_nan_inf {mode}: launches "
                                 f"{launches} != {want}")
        runs[mode] = dict(losses=losses, step_ms=1e3 * float(
            _steady(step_s, True)), launches=launches)
        del scope
    main.check_nan_inf = None
    rel = _loss_rel(runs["plain"]["losses"], runs["check"]["losses"])
    if max(rel) > TRAIN_OPT_LOSS_RTOL:
        raise AssertionError(f"check_nan_inf: losses "
                             f"{runs['plain']['losses']} != "
                             f"{runs['check']['losses']}")
    scope = _scope_copy(pt, state["scope"])
    timed = {"plain": [], "check": []}
    exe = pt.Executor()
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    torch.cuda.synchronize()
    for kern in ALL_KERNELS:
        kern.launches = 0
    for _ in range(NAN_CHECK_TIMED_PAIRS):
        for mode in ("plain", "check"):
            main.check_nan_inf = mode == "check"
            t = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            timed[mode].append(1e3 * (time.perf_counter() - t))
    main.check_nan_inf = None
    want = {k: 2 * NAN_CHECK_TIMED_PAIRS * state["per_step"]
            for k in state["kernels"]}
    if _launch_counts() != want:
        raise AssertionError(f"check_nan_inf timed steps: launches "
                             f"{_launch_counts()} != {want}")
    del scope
    for kern in ALL_KERNELS:
        kern.launches = 0

    exe = pt.Executor()
    prog = _tiny_program(pt, [
        {"name": "x", "shape": [3], "dtype": "float32", "is_data": True},
        {"name": "log_0.tmp_0", "shape": [3], "dtype": "float32"}],
        [{"type": "log", "inputs": {"X": ["x"]},
          "outputs": {"Out": ["log_0.tmp_0"]}, "attrs": {}}])
    prog.check_nan_inf = True
    try:
        exe.run(prog, feed={"x": np.array([-1.0, 1.0, 2.0], np.float32)},
                fetch_list=["log_0.tmp_0"], scope=pt.Scope())
        raise AssertionError("check_nan_inf: log(-1) did not raise")
    except RuntimeError as e:
        if "'log_0.tmp_0' contains NaN/Inf" not in str(e):
            raise
        raised = str(e)

    rows = np.arange(12, dtype=np.float32).reshape(4, 3) + 1.0
    idx_prog = _tiny_program(pt, [
        {"name": "x", "shape": [4, 3], "dtype": "float32", "is_data": True},
        {"name": "i", "shape": [2], "dtype": "int64", "is_data": True},
        {"name": "ids", "shape": [2, 1], "dtype": "int64",
         "is_data": True},
        {"name": "g", "shape": [2, 3], "dtype": "float32"},
        {"name": "e", "shape": [2, 3], "dtype": "float32"}],
        [{"type": "gather", "inputs": {"X": ["x"], "Index": ["i"]},
          "outputs": {"Out": ["g"]}, "attrs": {}},
         {"type": "lookup_table", "inputs": {"W": ["x"], "Ids": ["ids"]},
          "outputs": {"Out": ["e"]}, "attrs": {"padding_idx": -1}}])
    bad = {"x": rows, "i": np.array([-1, 4], np.int64),
           "ids": np.array([[-1], [4]], np.int64)}
    g, e = exe.run(idx_prog, feed=bad, fetch_list=["g", "e"],
                   scope=pt.Scope())
    torch.cuda.synchronize()
    for name, got in (("gather", g), ("lookup_table", e)):
        if not np.array_equal(got[0], rows[-1]) or \
                not np.isnan(got[1]).all():
            raise AssertionError(f"{name} at [-1, 4] gave {got}")
    good = {"x": rows, "i": np.array([0, 2], np.int64),
            "ids": np.array([[3], [1]], np.int64)}
    g, e = exe.run(idx_prog, feed=good, fetch_list=["g", "e"],
                   scope=pt.Scope())
    if not (np.array_equal(g, rows[[0, 2]]) and
            np.array_equal(e, rows[[3, 1]])):
        raise AssertionError("the run after the out-of-range one failed")

    casts = {}
    for dtype, values in SATURATING_CASTS.items():
        x = np.asarray(values, np.float32)
        cprog = _tiny_program(pt, [
            {"name": "x", "shape": [len(values)], "dtype": "float32",
             "is_data": True},
            {"name": "y", "shape": [len(values)], "dtype": dtype}],
            [{"type": "cast", "inputs": {"X": ["x"]},
              "outputs": {"Out": ["y"]},
              "attrs": {"in_dtype": "float32", "out_dtype": dtype}}])
        (card,) = exe.run(cprog, feed={"x": x}, fetch_list=["y"],
                          scope=pt.Scope())
        (cpu,) = pt.Executor(pt.CPUPlace()).run(
            cprog, feed={"x": x}, fetch_list=["y"], scope=pt.Scope())
        if not np.array_equal(card, cpu) or card.dtype != cpu.dtype:
            raise AssertionError(f"cast to {dtype}: card {card} != cpu "
                                 f"{cpu}")
        casts[dtype] = card.tolist()
    _no_launches("check_nan_inf (small programs)")
    out = dict(plain_step_ms=runs["plain"]["step_ms"],
               check_step_ms=runs["check"]["step_ms"],
               loss_rel_max=max(rel), casts=casts)
    for mode, ms in timed.items():
        out[f"{mode}_step_ms_timed"] = _spread([{"ms": m} for m in ms])["ms"]
    spread = {mode: "{median:.2f} [{min:.2f}, {max:.2f}]".format(
        **out[f"{mode}_step_ms_timed"]) for mode in timed}
    log(f"check_nan_inf: route A losses {[float(x) for x in runs['check']['losses']]}"
        f" with the check, rel {max(rel):.3e} from the unchecked run; "
        f"steady step {out['check_step_ms']:.2f} ms checked, "
        f"{out['plain_step_ms']:.2f} ms unchecked; alternating steps, "
        f"median [least, most] of {NAN_CHECK_TIMED_PAIRS} each: checked "
        f"{spread['check']} ms, unchecked {spread['plain']} ms; log(-1) "
        f"raised "
        f"{raised!r}; gather / lookup_table at [-1, 4] gave the last row "
        f"and NaN rows and the next run worked; casts {casts} as on the "
        f"CPU")
    state["scope"] = None
    torch.cuda.empty_cache()
    return runs["check"]["launches"], out


def _budget_trace(pred, trace):
    """Record the scheduler's calls into ``pred``: prefills (``P``),
    decode steps (``D``) and the budget's cost queries (``C``).  Returns
    a function that puts the methods back."""
    saved = {n: getattr(pred, n) for n in ("prefill", "decode_step",
                                           "prefill_cost")}

    def wrap(name, tag):
        fn = saved[name]

        def traced(*a, **kw):
            trace.append(tag)
            return fn(*a, **kw)
        return traced

    pred.prefill = wrap("prefill", "P")
    pred.decode_step = wrap("decode_step", "D")
    pred.prefill_cost = wrap("prefill_cost", "C")
    return lambda: [setattr(pred, n, f) for n, f in saved.items()]


def _budget_cuts(trace):
    """Admission passes the budget cut: a cost query that admitted
    nothing (the next call is a decode step, or nothing)."""
    return sum(1 for i, tag in enumerate(trace)
               if tag == "C" and (i + 1 == len(trace) or
                                  trace[i + 1] == "D"))


def phase_serving_budget(serving, http_gen):
    """``InferenceServer(gen_prefill_budget=...)`` over the paged
    GenLongConfig bundle of ``phase_serving``, the budget the static
    prefill cost of the longest prompt (so that it binds): the ten
    prompts as concurrent streamed ``/generate`` calls in
    ``HTTP_ROUNDS`` rounds, each stream token-identical to the
    unbudgeted in-process one, exactly ``prefills x n_layer`` bias
    softmax and ``decode_steps x n_layer`` paged decode launches in every
    round, every admission observed (``gen.admission_cost``).  Prints the
    cut admission passes and TTFT beside the unbudgeted HTTP rounds', and
    the cost model's prompt and page buckets for the ten lengths."""
    import numpy as np
    import torch
    from paddle_tpu_torch.gen import GenPredictor
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig
    from paddle_tpu_torch.profiler import runtime_metrics
    from paddle_tpu_torch.serving import InferenceServer, ServingClient

    prompts, want = serving["prompts"], serving["streams"]
    n_layer = int(GenLongConfig().n_layer)
    lengths = [len(p) for p in prompts]
    planner = GenPredictor(serving["bundle"])
    budget = planner.prefill_cost(max(lengths))
    costs = [planner.prefill_cost(n) for n in lengths]
    plans = dict(prompt_buckets=planner.plan_prompt_buckets(lengths),
                 page_buckets=planner.plan_page_buckets(lengths),
                 bundle_prompt_buckets=planner.prompt_buckets,
                 bundle_page_buckets=planner.page_buckets)
    del planner
    log(f"serving_budget: prefill costs {costs} for prompts of {lengths}; "
        f"budget {budget}; cost-optimal buckets {plans}")
    srv = InferenceServer(serving["bundle"], host="127.0.0.1", port=0,
                          warmup=True, async_load=True,
                          gen_prefill_budget=budget)
    srv.start_background()
    rounds = []
    try:
        addr = f"127.0.0.1:{srv.addr[1]}"
        _wait_ready(addr, server=srv)
        if srv._gen.prefill_budget != budget:
            raise AssertionError("serving_budget: the scheduler has budget "
                                 f"{srv._gen.prefill_budget}")
        client = ServingClient(addr, timeout=120)
        pred = srv.gen_predictor
        for r in range(HTTP_ROUNDS):
            trace = []
            restore = _budget_trace(pred, trace)
            torch.cuda.synchronize()
            runtime_metrics.reset()
            for kern in ALL_KERNELS:
                kern.launches = 0
            pre0, dec0 = pred.prefills, pred.decode_steps
            try:
                wall, results = _concurrent_streams(
                    lambda p: client.generate(
                        p, max_new_tokens=MAX_NEW_TOKENS), prompts)
            finally:
                restore()
            launches = _launch_counts()
            prefills = pred.prefills - pre0
            steps = pred.decode_steps - dec0
            for i, (_, _, toks, tail) in enumerate(results):
                if toks != want[i] or not tail or \
                        tail.get("finish_reason") != "length":
                    raise AssertionError(
                        f"serving_budget round {r}: prompt of "
                        f"{len(prompts[i])} gave {toks} ({tail}), "
                        f"unbudgeted in process {want[i]}")
            expect = {"bias_softmax": n_layer * prefills,
                      "paged_decode": n_layer * steps}
            observed = runtime_metrics.snapshot()["series"].get(
                "gen.admission_cost", {}).get("count", 0)
            if launches != expect or prefills != len(prompts) or \
                    observed != len(prompts):
                raise AssertionError(
                    f"serving_budget round {r}: launches {launches} != "
                    f"{expect} (prefills {prefills}, decode steps {steps},"
                    f" admission costs observed {observed})")
            rounds.append(dict(_stream_metrics(wall, results),
                               cut_passes=_budget_cuts(trace),
                               decode_steps=steps, launches=launches,
                               observed=observed))
    finally:
        srv.shutdown()
    spread = _spread([{k: v for k, v in r.items() if k != "launches"}
                      for r in rounds])
    plain = http_gen["http"]
    if not any(r["cut_passes"] for r in rounds):
        raise AssertionError("serving_budget: the budget never cut an "
                             "admission pass")
    log(f"serving_budget: {len(prompts)} concurrent streams "
        f"token-identical to the unbudgeted in-process ones in "
        f"{HTTP_ROUNDS} rounds; admission costs observed "
        f"{[r['observed'] for r in rounds]}; passes cut "
        f"{[r['cut_passes'] for r in rounds]}; first round's launches "
        f"{rounds[0]['launches']}")
    log("serving_budget: TTFT ms (median, least, most) p50 " + ",".join(
        f"{spread['ttft_p50_ms'][k]:.3f}" for k in ("median", "min", "max"))
        + " p99 " + ",".join(f"{spread['ttft_p99_ms'][k]:.3f}"
                             for k in ("median", "min", "max"))
        + "; unbudgeted HTTP p50 " + ",".join(
            f"{plain['ttft_p50_ms'][k]:.3f}" for k in ("median", "min",
                                                       "max"))
        + " p99 " + ",".join(f"{plain['ttft_p99_ms'][k]:.3f}"
                             for k in ("median", "min", "max"))
        + f"; tokens/s median {spread['tokens_per_s']['median']:.1f} "
        f"(unbudgeted {plain['tokens_per_s']['median']:.1f})")
    return rounds[0]["launches"], dict(budget=budget, costs=costs,
                                       plans=plans, rounds=spread)


# ---------------------------------------------------------------------------

#: what the report line says beside a kernel's own fields: the second
#: TPU kernel a port stands for (``exp_smalls_attn.py`` runs the same two
#: bodies as ``attention_ops.py``), and what a redesign or a repair of its
#: first port changed
# ---------------------------------------------------------------------------
# phase 11: the executor's CUDA graphs against its eager step
# ---------------------------------------------------------------------------

def _params(pt, main, scope):
    return {p.name: scope.find_var(p.name).float().clone()
            for p in main.global_block().all_parameters()}


#: a substring of the names of each route's kernels, for counting them in
#: a profile of a graph replay
ROUTE_KERNEL_NAMES = {"A": "bias_softmax", "B": "flash_", "C": "smalls_"}


def phase_graph_train(route):
    """Route ``route`` from one startup state on two fresh executors,
    ``TRAIN_STEPS`` steps each at dropout 0.1: the default path (the first
    step eager, the second captured into a CUDA graph and replayed, the
    rest replays) and the eager baseline (a clone of the program with
    ``_opt_interpret`` set, the attribute the optimization pipeline
    sets).  The losses must be bit-identical, or, where two eager runs
    differ, within their spread; both launch exactly the route's kernels
    18 times a step.  Reports the parameters' max |diff| after the steps,
    the steady step (median of the replays; of the eager steps after the
    first), the capture seconds and graph nodes, and each run's peak
    allocated and reserved GiB."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis.opt import clone_program
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S, kernels = ROUTES[route]
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    eager = clone_program(main)
    eager._opt_interpret = True
    feed = T.fake_batch(B, S, S, hp, seed=SEED)
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    want = {k: 18 * TRAIN_STEPS for k in kernels}
    runs = {}
    # two eager runs: the spread the graph is held to where it is not
    # bit-identical, and the parameters' own run-to-run spread
    for mode, program in (("graph", main), ("eager", eager),
                          ("eager2", eager)):
        scope = _scope_copy(pt, scope0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in ALL_KERNELS:
            kern.launches = 0
        exe, losses, step_s = _train_run(pt, program, cost, scope, feed,
                                         TRAIN_STEPS)
        launches = _launch_counts()
        if launches != want:
            raise AssertionError(f"graph_train[{route}] {mode}: launches "
                                 f"{launches} != {want}")
        stats = exe.graph_stats()
        replays = _graphs(f"graph_train_{route}_{mode}", exe,
                          mode == "graph")
        if mode == "graph" and replays != TRAIN_STEPS - 1:
            raise AssertionError(f"graph_train[{route}]: replays {stats}")
        steady = step_s[2:] if mode == "graph" else step_s[1:]
        params = _params(pt, main, scope)
        profiled = {}
        if mode == "graph":
            # one more replay under torch.profiler: do the graph's kernel
            # nodes show, and how long is the device busy in a replay
            events = _device_events(lambda: exe.run(
                program, feed=feed, fetch_list=[cost], scope=scope), 1, 0)
            profiled = dict(
                device_events=len(events),
                route_kernel_events=sum(
                    1 for n, _ in events if ROUTE_KERNEL_NAMES[route] in n),
                device_busy_ms=sum(t for _, t in events) / 1e3)
        runs[mode] = dict(
            losses=losses, launches=launches, params=params,
            profiled=profiled,
            step_ms=1e3 * float(np.median(steady)),
            first_ms=1e3 * step_s[0], second_ms=1e3 * step_s[1],
            peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
            capture_s=sum(s["seconds"] for s in stats),
            nodes=[s["nodes"] for s in stats],
            pool_gib=sum(s["pool_gib"] for s in stats))
        del exe, scope
    graph, base = runs["graph"], runs["eager"]
    rel = _loss_rel(base["losses"], graph["losses"])
    identical = graph["losses"] == base["losses"]
    spread = max(_loss_rel(base["losses"], runs["eager2"]["losses"]))
    if not identical and (not spread or max(rel) > spread):
        raise AssertionError(
            f"graph_train[{route}]: graphed losses {graph['losses']} "
            f"against eager {base['losses']} (rel {rel}), two eager "
            f"runs {spread}")
    if not all(np.isfinite(graph["losses"])) or \
            not graph["losses"][-1] < graph["losses"][0]:
        raise AssertionError(f"graph_train[{route}]: losses "
                             f"{graph['losses']}")

    def dmax(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in b)
    dparam = dmax(graph["params"], base["params"])
    dparam_eager = dmax(runs["eager2"]["params"], base["params"])
    out = dict(losses=[float(x) for x in graph["losses"]],
               bit_identical=identical, loss_rel_max=max(rel),
               eager_spread=spread, param_max_abs_diff=dparam,
               eager_param_max_abs_diff=dparam_eager)
    for mode in ("graph", "eager"):
        r = runs[mode]
        out[mode] = {k: r[k] for k in (
            "step_ms", "first_ms", "second_ms", "peak_allocated_gib",
            "peak_reserved_gib", "launches")}
    out["graph"].update(capture_s=graph["capture_s"], nodes=graph["nodes"],
                        pool_gib=graph["pool_gib"], **graph["profiled"])
    if not graph["profiled"]["route_kernel_events"]:
        log(f"graph_train[{route}]: torch.profiler shows none of the "
            f"route's kernels inside a replay (the profile has "
            f"{graph['profiled']['device_events']} device events)")
    log(f"graph_train[{route}]: losses {out['losses']} graphed, "
        f"bit-identical to eager: {identical} (rel max {max(rel):.3e}, "
        f"two eager runs {spread:.3e}); params max |diff| {dparam:.3e} "
        f"(two eager runs {dparam_eager:.3e}); steady step "
        f"{graph['step_ms']:.2f} ms graphed (median of "
        f"{TRAIN_STEPS - 2} replays) vs {base['step_ms']:.2f} ms eager; "
        f"first / second step {graph['first_ms']:.1f} / "
        f"{graph['second_ms']:.1f} ms (eager / capture + replay), capture "
        f"{graph['capture_s']:.3f} s, {graph['nodes']} nodes, a profiled "
        f"replay: {graph['profiled']['device_events']} device events "
        f"({graph['profiled']['route_kernel_events']} of the route's), "
        f"device busy {graph['profiled']['device_busy_ms']:.2f} ms; pool "
        f"{graph['pool_gib']:.2f} GiB; peak allocated / reserved "
        f"{graph['peak_allocated_gib']:.2f} / "
        f"{graph['peak_reserved_gib']:.2f} GiB graphed, "
        f"{base['peak_allocated_gib']:.2f} / "
        f"{base['peak_reserved_gib']:.2f} GiB eager; launches "
        f"{graph['launches']} both")
    del runs, scope0
    gc.collect()
    torch.cuda.empty_cache()
    return graph["launches"], out


def _collect(streams, tag):
    """Every token of each stream (a failed or timed-out stream fails the
    run)."""
    deadline = time.monotonic() + HTTP_WAIT_S
    outs = []
    for st in streams:
        toks = []
        while True:
            ev = st.next_event(timeout=max(0.0, deadline - time.monotonic()))
            if ev is None:
                raise AssertionError(f"{tag}: a stream timed out")
            kind, value = ev
            if kind == "token":
                toks.append(value)
            elif kind == "done":
                break
            else:
                raise AssertionError(f"{tag}: stream failed: {value!r}")
        outs.append(toks)
    return outs


def phase_graph_serving(serving):
    """The ten prompts of ``phase_serving`` through ``GenScheduler`` on two
    predictors of the paged bundle, each warmed up first: the default
    path (every prompt bucket's prefill and every page bucket's decode a
    CUDA graph, captured by ``warmup``) and the eager baseline (both
    programs with ``_opt_interpret`` set).  The greedy streams must be
    token-identical to each other and to ``phase_serving``'s; the graphed
    predictor captures nothing after its warmup (``compile.events``) and
    the eager one nothing at all.  Reports the prefill and decode-step
    medians both ways."""
    import numpy as np
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.profiler import runtime_metrics

    prompts, want = serving["prompts"], serving["streams"]
    out = {}
    for mode in ("graph", "eager"):
        pred = GenPredictor(serving["bundle"])
        if mode == "eager":
            pred._pre_prog._opt_interpret = True
            pred._dec_prog._opt_interpret = True
        t0 = time.perf_counter()
        pred.warmup()
        warmup_s = time.perf_counter() - t0
        times = {"prefill": [], "decode_step": []}
        for name, samples in times.items():
            fn = getattr(pred, name)

            def timed(*a, _fn=fn, _samples=samples, **kw):
                t = time.perf_counter()
                result = _fn(*a, **kw)
                _samples.append(time.perf_counter() - t)
                return result
            setattr(pred, name, timed)
        sched = GenScheduler(pred, queue_size=64)
        events0 = runtime_metrics.counter("compile.events")
        try:
            got = _collect([sched.submit(p, max_new_tokens=MAX_NEW_TOKENS)
                            for p in prompts], f"graph_serving[{mode}]")
        finally:
            sched.close()
        if got != want:
            raise AssertionError(f"graph_serving[{mode}]: streams differ "
                                 f"from phase_serving's")
        if runtime_metrics.counter("compile.events") != events0:
            raise AssertionError(f"graph_serving[{mode}]: a capture after "
                                 f"warmup")
        graphs = pred._exe.graph_stats()
        buckets = len([b for b in pred.prompt_buckets if b <= pred.max_len]
                      ) + len([b for b in pred.page_buckets
                               if b <= pred.pages_per_slot])
        if mode == "graph" and \
                sum(1 for g in graphs if g["captures"]) != buckets:
            raise AssertionError(f"graph_serving: {len(graphs)} graphs for "
                                 f"{buckets} buckets")
        _graphs(f"graph_serving_{mode}", pred._exe, mode == "graph")
        out[mode] = dict(
            prefill_ms=1e3 * float(np.median(times["prefill"])),
            decode_step_ms=1e3 * float(np.median(times["decode_step"])),
            prefills=len(times["prefill"]),
            decode_steps=len(times["decode_step"]), warmup_s=warmup_s,
            graphs=len(graphs))
        del sched, pred
    log("graph_serving: the ten streams token-identical graphed and eager "
        "(and to phase_serving's); no capture after warmup; " + " ".join(
            f"{mode}: prefill {o['prefill_ms']:.3f} ms, decode step "
            f"{o['decode_step_ms']:.3f} ms (medians of {o['prefills']} / "
            f"{o['decode_steps']}), warmup {o['warmup_s']:.2f} s, "
            f"{o['graphs']} graphs;" for mode, o in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 27: the serving fleet on the card (the master's replica leases,
# FleetReplica, FleetRouter with mid-stream failover, the federation and
# the assembled fleet trace), the fleet controller under a traffic step,
# and route A fed by the master's task leases through a trainer's crash
# ---------------------------------------------------------------------------

#: the replicas' lease, the longest the JAX package's drills use; a
#: replica heartbeats every third of it (``FleetReplica``'s default)
FLEET_LEASE_TTL_S = 3.0
FLEET_HEARTBEAT_S = FLEET_LEASE_TTL_S / 3.0
#: the child replica's ``fleet.replica.kill=kill@N``: it lets N
#: heartbeats pass and exits 137 at the next one, N + 1 heartbeats after
#: its enrolment; the drill's stream on it starts ``FLEET_CHILD_LEAD_S``
#: before that
FLEET_CHILD_KILL_AFTER = 7
FLEET_CHILD_LEAD_S = 1.0
#: the child's own ``gen.decode.stall`` (seconds a decode step), so that
#: the stream it owns outlives the kill: 32 tokens take over 3 s there
FLEET_CHILD_STALL_S = 0.1
#: rounds of the ten streams straight to one replica and through a router
#: in front of it, alternating
FLEET_ROUNDS = 3


def _http_get(addr, path):
    """``(status, body bytes)`` of one GET (599, b"" when nothing
    answers)."""
    import http.client
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    except OSError:
        return 599, b""
    finally:
        conn.close()


def _stream_events(addr, prompt):
    """One streamed ``ServingClient(addr).generate`` of ``prompt``:
    ``(events, arrival times)``, each token event with its ``index``."""
    from paddle_tpu_torch.serving import ServingClient
    events, times = [], []
    t0 = time.perf_counter()
    for ev in ServingClient(addr, timeout=120).generate(
            prompt, max_new_tokens=MAX_NEW_TOKENS):
        events.append(ev)
        times.append(time.perf_counter())
        if time.perf_counter() - t0 > HTTP_WAIT_S:
            raise AssertionError(f"a stream through {addr} hung")
    return events, times


def _check_stream(tag, events, want):
    """The stream ended ``length`` with ``want``'s tokens at indices
    ``0 ... MAX_NEW_TOKENS - 1``, none lost or repeated."""
    toks = [e["token"] for e in events if "token" in e]
    idxs = [e["index"] for e in events if "token" in e]
    tail = events[-1] if events else {}
    if toks != want or idxs != list(range(MAX_NEW_TOKENS)) or \
            tail.get("finish_reason") != "length":
        raise AssertionError(f"{tag}: tokens {toks} (want {want}), "
                             f"indices {idxs}, tail {tail}")


def _largest_gap(times):
    """Seconds of the longest wait between two consecutive tokens."""
    return max(b - a for a, b in zip(times, times[1:]))


def _wait_for(what, cond, timeout, step=0.01):
    """Poll ``cond()`` until true; fails naming ``what`` after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout}s")
        time.sleep(step)


def _fleet_replica(bundle, maddr, rid):
    """A ``FleetReplica`` over ``bundle`` on ``cuda:0`` (the default
    place), warmed before it enrolls."""
    from paddle_tpu_torch.fleet import FleetReplica
    return FleetReplica(bundle, maddr, replica_id=rid,
                        lease_ttl=FLEET_LEASE_TTL_S, warmup=True)


class _Launches:
    """The kernels' launch counts of a phase's serving, banked around
    the warmups of replicas started in it (a warmup launches the kernels
    of every bucket and counts no prefill or decode step): ``warm(fn)``
    runs ``fn`` and keeps its launches apart."""

    def __init__(self):
        import collections
        self.serving = collections.Counter()
        self.warmups = []
        _take_launches()

    def warm(self, fn):
        self.serving.update(_take_launches())
        out = fn()
        self.warmups.append(_take_launches())
        return out

    def take(self):
        self.serving.update(_take_launches())
        return dict(self.serving)


def _expect_serving_launches(tag, launches, preds, extra=None):
    """``bias_softmax`` launched ``n_layer`` times a prefill and
    ``paged_decode`` ``n_layer`` times a decode step of ``preds`` (plus
    ``extra``, the launches of warmups that could not be kept apart),
    and no other kernel."""
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig
    n_layer = int(GenLongConfig().n_layer)
    prefills = sum(p.prefills for p in preds)
    steps = sum(p.decode_steps for p in preds)
    want = {"bias_softmax": n_layer * prefills,
            "paged_decode": n_layer * steps}
    for k, n in (extra or {}).items():
        want[k] = want.get(k, 0) + n
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want} "
                             f"({prefills} prefills, {steps} decode steps "
                             f"over {len(preds)} replicas)")
    return prefills, steps


def phase_fleet(serving):
    """``phase_serving``'s paged GenLongConfig bundle served by a fleet on
    the card: a ``MasterServer`` holding the replicas' leases, two
    in-process ``FleetReplica``s and a child ``python -m
    paddle_tpu_torch serve --master ... --warmup`` (a second CUDA
    context; its kernels load from the build directory), behind a
    master-discovered ``FleetRouter``.

    (a) The ten prompts as concurrent streams through the router equal
    ``phase_serving``'s streams; what each replica took shows in its
    ``/stats``.  (b) Two kill drills, each stream completing on a
    survivor token- and index-identical with one resume: the router's
    ``gen.session.kill_owner`` (``after=3``) in process, then the
    child's own ``fleet.replica.kill=kill@N`` (``PADDLE_TPU_CHAOS``)
    while it owns a stream: ``os._exit(137)``, its lease dropped by the
    master within TTL + one heartbeat, the router's live set one
    smaller, the failed-over ``X-Request-Id`` in the survivor's
    ``/trace``; meanwhile ``/metrics?fleet=1`` marks the corpse stale
    and ``trace dump --fleet`` lists it under ``fleetAssembly.failures``
    beside a process row for the router and each reachable replica.
    (c) ``master.lease.expire``: the replica answers ``/readyz`` 503
    ``lease_lost``, rejoins and answers 200.  (d) A rolling restart: one
    replica drained under a stream (migrated, completed identical), a
    warmed replacement enrolled without a kernel build, never fewer than
    N - 1 leases.  (e) ``/metrics?fleet=1`` has every live replica up
    and the least ``hbm.headroom_bytes`` they report, under the card's
    memory.  The in-process replicas' kernel launches are ``n_layer``
    times their prefills and decode steps.  Prints TTFT and tokens/s
    through a router against straight to its one replica, the failover
    gaps and the seconds from the kill to the lease drop."""
    import io
    import re
    import numpy as np
    import torch
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.fault import chaos
    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.parallel.master import MasterServer, MasterService
    from paddle_tpu_torch.profiler import runtime_metrics
    from paddle_tpu_torch.serving import ServingClient

    prompts, want = serving["prompts"], serving["streams"]
    bundle = serving["bundle"]
    out = {}
    t_phase = time.perf_counter()
    trace.enable(65536)
    trace.clear()
    svc = MasterService(replica_ttl=FLEET_LEASE_TTL_S)
    master = MasterServer(svc, port=0)
    master.start_background()
    maddr = f"127.0.0.1:{master.addr[1]}"
    # the child first: it takes longest to serve (a new process, its own
    # CUDA context, the bundle, the warmup)
    child_log = os.path.join(OUT_DIR, "fleet_child.log")
    env = dict(os.environ, PYTHONPATH=ROOT, PADDLE_TPU_CHAOS=(
        f"fleet.replica.kill=kill@{FLEET_CHILD_KILL_AFTER};"
        f"gen.decode.stall=delay:{FLEET_CHILD_STALL_S}"))
    with open(child_log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model",
             bundle, "--master", maddr, "--warmup", "--port",
             str(_free_port()), "--replica-id", "child", "--lease-ttl",
             str(FLEET_LEASE_TTL_S)], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    reps, routers, threads, drained = [], [], [], []
    launches = _Launches()
    try:
        builds0 = dict(build.counts)
        for i in range(2):
            reps.append(launches.warm(
                lambda i=i: _fleet_replica(bundle, maddr,
                                           f"card-{i}").start()))
        if launches.warmups[0] != launches.warmups[1]:
            raise AssertionError(f"fleet: two warmups launched "
                                 f"{launches.warmups}")
        addr = {r.replica_id: f"127.0.0.1:{r.addr[1]}" for r in reps}
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        routers.append(router)
        raddr = f"127.0.0.1:{router.addr[1]}"

        def child_lease():
            return next((r for r in svc.list_replicas()
                         if r["id"] == "child"), None)

        enrolled = {}

        def enrolment_watch():
            while child_lease() is None and proc.poll() is None:
                time.sleep(0.005)
            enrolled["t"] = time.monotonic()

        threads.append(threading.Thread(target=enrolment_watch,
                                        daemon=True))
        threads[-1].start()

        # what needs no child runs while it loads (its kill counts
        # heartbeats from its enrolment), the rest after its drill: the
        # router's in-process drill, then the router's own cost (the ten
        # streams straight to card-0 and through a static router in
        # front of it)
        solo = FleetRouter(replicas=[addr["card-0"]])
        solo.start_background()
        routers.append(solo)
        rounds = {"direct": [], "router": []}

        def one_round(kind, a):
            def run():
                wall, results = _concurrent_streams(
                    lambda p: ServingClient(a, timeout=120).generate(
                        p, max_new_tokens=MAX_NEW_TOKENS), prompts)
                if [r[2] for r in results] != want:
                    raise AssertionError(f"fleet[{kind}]: streams differ "
                                         f"from phase_serving's")
                rounds[kind].append(_stream_metrics(wall, results))
            return run

        def kill_owner_drill():
            # (b) the router cuts the owner after its fourth token
            chaos.inject("gen.decode.stall", delay=RESUME_STALL_S)
            resumes = runtime_metrics.counter("gen.session.resumes")
            chaos.inject("gen.session.kill_owner", error=True, times=1,
                         after=3)
            try:
                events, times = _stream_events(raddr, prompts[0])
            finally:
                chaos.clear("gen.decode.stall")
            _check_stream("fleet[kill_owner]", events, want[0])
            if runtime_metrics.counter("gen.session.resumes") != \
                    resumes + 1:
                raise AssertionError("fleet[kill_owner]: not one resume")
            out["kill_owner_gap_ms"] = 1e3 * _largest_gap(times)
            _wait_for("fleet: the cut owner's cooldown",
                      lambda: not any(e["down"] for e in
                                      router.table().values()), 10)

        fillers = [kill_owner_drill] + [
            one_round(kind, a) for _ in range(FLEET_ROUNDS)
            for kind, a in (("direct", addr["card-0"]),
                            ("router", f"127.0.0.1:{solo.addr[1]}"))]
        while fillers and "t" not in enrolled:
            fillers.pop(0)()
        out["fillers_before_child"] = 2 * FLEET_ROUNDS + 1 - len(fillers)
        _wait_for("fleet: the child's enrolment", lambda: "t" in enrolled,
                  HTTP_WAIT_S)
        if proc.poll() is not None:
            raise AssertionError(f"fleet: the child exited "
                                 f"{proc.returncode} before its drill "
                                 f"(see {child_log})")
        t_enrolled = enrolled["t"]
        t_kill = t_enrolled + (FLEET_CHILD_KILL_AFTER + 1) * \
            FLEET_HEARTBEAT_S
        child = child_lease()["addr"]
        _wait_for("fleet: three live replicas in the router",
                  lambda: len(router.live_replicas()) == 3, 10)
        out["child_enrolled_s"] = time.perf_counter() - t_phase
        with open(child_log) as f:
            started = f.read()
        if "fleet replica child serving" not in started or \
                "cuda:0" not in started:
            raise AssertionError(f"fleet: the child's start line "
                                 f"{started!r}")
        st, body = _http_get(child, "/stats")
        child_builds = json.loads(body)["server"]["kernel_builds"]
        if st != 200 or child_builds.get("compiled"):
            raise AssertionError(f"fleet: the child built kernels: "
                                 f"{child_builds}")

        # (a) the ten streams through the router over three replicas
        preds = [r.server.gen_predictor for r in reps]
        pre0 = [p.prefills for p in preds]
        took0 = {e["id"]: e["requests"] for e in router.table().values()}
        wall, results = _concurrent_streams(
            lambda p: ServingClient(raddr, timeout=120).generate(
                p, max_new_tokens=MAX_NEW_TOKENS), prompts)
        bad = {i: (r[2], r[3]) for i, r in enumerate(results)
               if r[2] != want[i]}
        if bad:
            with open(child_log) as f:
                tail = f.read()[-3000:]
            raise AssertionError(
                f"fleet: routed streams differ from phase_serving's: "
                f"{bad} (want {[want[i] for i in bad]}); the router's "
                f"table {router.table()}; the child's log: {tail}")
        took = {e["id"]: e["requests"] - took0.get(e["id"], 0)
                for e in router.table().values()}
        st, body = _http_get(child, "/stats")
        child_admitted = json.loads(body)["counters"].get(
            "gen.admissions", 0)
        in_process = sum(p.prefills - p0 for p, p0 in zip(preds, pre0))
        if sum(took.values()) != len(prompts) or \
                child_admitted != took.get("child", 0) or \
                in_process != took.get("card-0", 0) + took.get("card-1", 0):
            raise AssertionError(f"fleet: the router's picks {took} "
                                 f"against the child's admissions "
                                 f"{child_admitted} and the in-process "
                                 f"prefills {in_process}")
        out["routed"] = dict(took, tokens_per_s=_stream_metrics(
            wall, results)["tokens_per_s"])

        # (b) the child's death while it owns a stream: the in-process
        # replicas each take a stream first, so least-outstanding hands
        # the child the third
        chaos.inject("gen.decode.stall", delay=RESUME_STALL_S)
        lead = t_kill - time.monotonic()
        if lead < FLEET_CHILD_LEAD_S / 2:
            raise AssertionError(
                f"fleet: the child's kill is {lead:.2f}s away when its "
                f"drill starts ({time.monotonic() - t_enrolled:.2f}s after "
                f"its enrolment): raise FLEET_CHILD_KILL_AFTER")
        time.sleep(max(0.0, lead - FLEET_CHILD_LEAD_S))
        out["child_kill_slack_s"] = lead - FLEET_CHILD_LEAD_S
        died = {}

        def watch():
            proc.wait()
            died["t"] = time.monotonic()

        def lease_watch():
            while child_lease() is not None:
                time.sleep(0.005)
            died["lease_t"] = time.monotonic()

        for fn in (watch, lease_watch):
            threads.append(threading.Thread(target=fn, daemon=True))
            threads[-1].start()
        resumes = runtime_metrics.counter("gen.session.resumes")
        failovers = len(router.failover_log)
        drill = [None] * 3

        def run(i):
            try:
                drill[i] = _stream_events(raddr, prompts[i])
            except Exception as e:      # reported below
                drill[i] = e

        for i in range(3):
            threads.append(threading.Thread(target=run, args=(i,),
                                            daemon=True))
            threads[-1].start()
            _wait_for("fleet: the drill's stream reaching a replica",
                      lambda i=i: sum(e["outstanding"] for e in
                                      router.table().values()) == i + 1,
                      10, step=0.001)
        owners = {e["id"]: e["outstanding"]
                  for e in router.table().values()}
        for th in threads[-3:]:
            th.join(HTTP_WAIT_S)
        bad = [d for d in drill if not isinstance(d, tuple)]
        if bad:
            raise AssertionError(f"fleet[child kill]: streams failed {bad}")
        for i, (events, _) in enumerate(drill):
            _check_stream(f"fleet[child kill, prompt {i}]", events,
                          want[i])
        if owners != {"card-0": 1, "card-1": 1, "child": 1} or \
                proc.wait(HTTP_WAIT_S) != 137 or \
                runtime_metrics.counter("gen.session.resumes") != \
                resumes + 1:
            raise AssertionError(
                f"fleet[child kill]: owners {owners}, child exit "
                f"{proc.returncode}, resumes "
                f"{runtime_metrics.counter('gen.session.resumes') - resumes}")
        out["child_failover_gap_ms"] = 1e3 * max(
            _largest_gap(t) for _, t in drill)
        # the router logs a failover after it relays the stream's last
        # chunk, so the client can finish first
        _wait_for("fleet[child kill]: the router's failover record",
                  lambda: len(router.failover_log) > failovers, 5)
        (rid, *chain), = list(router.failover_log)[failovers:]
        if chain[0] != child:
            raise AssertionError(f"fleet[child kill]: failover {chain}")
        survivor = chain[-1]

        # the corpse, before its lease runs out: stale in the federation,
        # a failure of the assembled trace
        if child not in router.table():
            raise AssertionError("fleet: the child's lease dropped before "
                                 "the fleet views were taken")
        st, body = _http_get(raddr, "/metrics?fleet=1")
        text = body.decode()
        if st != 200 or f'paddle_tpu_fleet_replica_up{{replica="{child}",' \
                f'id="child",stale="1"}} 0' not in text:
            raise AssertionError(f"fleet: /metrics?fleet=1 ({st}) does not "
                                 f"mark the child stale")
        path = os.path.join(OUT_DIR, "fleet_trace.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["trace", "dump", "--fleet", "--addr", raddr,
                           "--output", path])
        with open(path) as f:
            fleet_trace = json.load(f)
        asm = fleet_trace["fleetAssembly"]
        rows = sorted(p["source"] for p in asm["processes"])
        if rc != 0 or [x["source"] for x in asm["failures"]] != [child] or \
                rows != sorted(["router", *addr.values()]):
            raise AssertionError(f"fleet: trace dump --fleet (exit {rc}): "
                                 f"processes {rows}, failures "
                                 f"{asm['failures']}")
        st, body = _http_get(survivor, "/trace")
        served = {(ev["args"].get("request_id"), ev["args"].get("port"))
                  for ev in json.loads(body)["traceEvents"]
                  if ev["name"] == "gen.request"}
        if (rid, int(survivor.rsplit(":", 1)[1])) not in served:
            raise AssertionError(f"fleet: the failed-over request {rid} "
                                 f"is not in {survivor}'s /trace")
        _wait_for("fleet: the master dropping the child's lease",
                  lambda: "lease_t" in died, 2 * FLEET_LEASE_TTL_S)
        out["kill_to_lease_drop_s"] = died["lease_t"] - died["t"]
        if out["kill_to_lease_drop_s"] > FLEET_LEASE_TTL_S + \
                FLEET_HEARTBEAT_S:
            raise AssertionError(f"fleet: lease dropped "
                                 f"{out['kill_to_lease_drop_s']:.3f}s "
                                 f"after the kill")
        _wait_for("fleet: the router's live set shrinking",
                  lambda: sorted(router.live_replicas()) ==
                  sorted(addr.values()), 2)
        chaos.clear("gen.decode.stall")
        for task in fillers:
            task()
        solo.shutdown()
        routers.remove(solo)
        out["direct"], out["router"] = (_spread(rounds["direct"]),
                                        _spread(rounds["router"]))

        # (c) a lease lost while alive, then the rejoin
        for r in reps:
            r.auto_rejoin = False
        chaos.inject("master.lease.expire", error=True, times=1)
        _wait_for("fleet: a lost lease",
                  lambda: any(r.server.lease_state == "lost" for r in reps),
                  3 * FLEET_HEARTBEAT_S)
        lost = next(r for r in reps if r.server.lease_state == "lost")
        other = next(r for r in reps if r is not lost)
        st, body = _http_get(addr[lost.replica_id], "/readyz")
        err = json.loads(body)
        if st != 503 or err["error"]["type"] != "lease_lost" or \
                _http_status(addr[other.replica_id], "/readyz") != 200:
            raise AssertionError(f"fleet: /readyz of the lost lease "
                                 f"{st} {err}")
        for r in reps:
            r.auto_rejoin = True
        _wait_for("fleet: the rejoin",
                  lambda: lost.server.lease_state == "held",
                  3 * FLEET_HEARTBEAT_S)
        if _http_status(addr[lost.replica_id], "/readyz") != 200:
            raise AssertionError("fleet: /readyz after the rejoin")
        _wait_for("fleet: the router seeing the rejoin",
                  lambda: len(router.live_replicas()) == 2, 2)

        # (d) the rolling restart: drain the owner of a live stream, then
        # a warmed replacement
        ready = []
        stop = threading.Event()

        def monitor():
            while not stop.wait(0.005):
                ready.append(len(svc.list_replicas()))

        threads.append(threading.Thread(target=monitor, daemon=True))
        threads[-1].start()
        resumes = runtime_metrics.counter("gen.session.resumes")
        chaos.inject("gen.decode.stall", delay=RESUME_STALL_S)
        stream = {}
        threads.append(threading.Thread(
            target=lambda: stream.update(r=_stream_events(raddr,
                                                          prompts[3])),
            daemon=True))
        threads[-1].start()
        _wait_for("fleet: the rolling restart's stream on a replica",
                  lambda: sum(bool(r.server._gen.active_slots)
                              for r in reps) == 1, 10, step=0.001)
        time.sleep(4 * RESUME_STALL_S)
        owner = next(r for r in reps if r.server._gen.active_slots)
        migrated = owner.drain(deadline_s=0)
        drained.append(owner)
        threads[-1].join(HTTP_WAIT_S)
        chaos.clear("gen.decode.stall")
        _check_stream("fleet[rolling restart]", stream["r"][0], want[3])
        if len(migrated) != 1 or \
                runtime_metrics.counter("gen.session.resumes") != \
                resumes + 1:
            raise AssertionError(f"fleet[rolling restart]: {len(migrated)} "
                                 f"migrated")
        builds = dict(build.counts)
        t = time.perf_counter()
        reps.append(launches.warm(
            lambda: _fleet_replica(bundle, maddr, "card-2").start()))
        out["replacement_ready_s"] = time.perf_counter() - t
        addr["card-2"] = f"127.0.0.1:{reps[-1].addr[1]}"
        events, _ = _stream_events(addr["card-2"], prompts[4])
        _check_stream("fleet[replacement]", events, want[4])
        stop.set()
        if dict(build.counts) != builds or launches.warmups[-1] != \
                launches.warmups[0] or min(ready) < 1 or \
                len(svc.list_replicas()) != 2:
            raise AssertionError(
                f"fleet[rolling restart]: builds {builds} -> "
                f"{dict(build.counts)}, warmup launches "
                f"{launches.warmups}, fewest leases {min(ready)}")
        _wait_for("fleet: the router seeing the replacement",
                  lambda: len(router.live_replicas()) == 2, 2)

        # (e) the federation of the live fleet, idle
        st, body = _http_get(raddr, "/metrics?fleet=1")
        text = body.decode()
        heads = []
        for rec in svc.list_replicas():
            if f'paddle_tpu_fleet_replica_up{{replica="{rec["addr"]}",' \
                    f'id="{rec["id"]}",stale="0"}} 1' not in text:
                raise AssertionError(f"fleet: {rec['id']} is not up in "
                                     f"/metrics?fleet=1")
            gauges = json.loads(_http_get(rec["addr"], "/stats")[1])[
                "gauges"]
            heads.append(gauges.get("hbm.headroom_bytes", -1.0))
        m = re.search(r"^paddle_tpu_fleet_hbm_headroom_min_bytes (\S+)$",
                      text, re.M)
        total = torch.cuda.get_device_properties(0).total_memory
        if st != 200 or m is None or float(m.group(1)) != min(heads) or \
                not 0 < min(heads) < total:
            raise AssertionError(f"fleet: headroom rollup "
                                 f"{m and m.group(1)} against the "
                                 f"replicas' {heads} (card {total})")
        out["hbm_headroom_min_gib"] = min(heads) / 2 ** 30
        out["builds"] = builds0 == dict(build.counts)
        prefills, steps = _expect_serving_launches(
            "fleet", launches.take(),
            [r.server.gen_predictor for r in reps])
    finally:
        chaos.clear()
        for r in routers:
            r.shutdown()
        for r in reps:
            if r not in drained:
                r.drain(deadline_s=0)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        master.shutdown()
        trace.disable()
        trace.clear()
    out.update(prefills=prefills, decode_steps=steps,
               warmup_launches=launches.warmups[0], card=card_line())
    log(f"fleet: router over 2 in-process replicas and a child process on "
        f"cuda:0; routed streams token-identical ({out['routed']}); "
        f"kill_owner and child kill (exit 137) resumed token-identical, "
        f"gaps {out['kill_owner_gap_ms']:.1f} / "
        f"{out['child_failover_gap_ms']:.1f} ms; lease dropped "
        f"{out['kill_to_lease_drop_s']:.3f} s after the kill; lease_lost "
        f"503 and rejoin; rolling restart with a replacement ready in "
        f"{out['replacement_ready_s']:.2f} s, no build; headroom min "
        f"{out['hbm_headroom_min_gib']:.2f} GiB; launches over "
        f"{prefills} prefills, {steps} decode steps; card {out['card']}")
    for kind in ("direct", "router"):
        log(f"fleet[{kind}, median min max of {FLEET_ROUNDS} rounds]: " +
            " ".join(f"{k}={v['median']:.3f},{v['min']:.3f},{v['max']:.3f}"
                     for k, v in out[kind].items()))
    return launches.take(), out


#: the controller drill: a step from ``CTL_BASE_RPS`` to ``CTL_PEAK_RPS``
#: streams a second at ``CTL_STEP_AT_S`` for ``CTL_PEAK_S``, in a replay
#: of ``CTL_REPLAY_S``; the one-replica TTFT is measured over
#: ``CTL_MEASURE_S`` at the peak
CTL_BASE_RPS, CTL_PEAK_RPS = 10.0, 60.0
CTL_STEP_AT_S, CTL_PEAK_S, CTL_REPLAY_S = 1.0, 3.0, 5.0
CTL_MEASURE_S = 2.0
#: the controller's policy: one replica at least, two at most, one warm
#: standby, a tick of 0.1 s
CTL_POLICY = {
    "version": 1, "interval_seconds": 0.1, "min_replicas": 1,
    "max_replicas": 2, "standby_pool": 1, "ready_timeout_seconds": 300.0,
    "scale_up": {"pressure_ratio": 1.0, "sustained_ticks": 2,
                 "cooldown_seconds": 1.0},
    "scale_down": {"idle_rps_per_replica": 0.5, "sustained_ticks": 5,
                   "cooldown_seconds": 0.0},
    "degrade": {"ladder": [0.0, 0.25, 0.5], "engage_ratio": 1.0,
                "recover_ticks": 2, "retry_after_seconds": 0.2},
}


def _generate_sender(raddr, prompts, want, errors, ttft=None, slo=None):
    """``TrafficReplay``'s ``send``: request ``i`` streams prompt
    ``i % 10`` through the router at ``raddr`` (``X-Deadline-Ms`` 30 s)
    and must return that prompt's stream (else its error goes to the
    list ``errors`` and the replay counts it lost); its time to the
    first token goes to the list ``ttft`` and the series
    ``gen.ttft_seconds`` of the registry ``slo``."""
    import http.client
    host, port = raddr.rsplit(":", 1)

    def send(i):
        try:
            return one(i)
        except Exception as e:
            errors.append(f"request {i}: {e!r}")
            raise

    def one(i):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/generate", json.dumps(
                {"prompt": prompts[i % len(prompts)],
                 "max_new_tokens": MAX_NEW_TOKENS}).encode(),
                {"Content-Type": "application/json",
                 "X-Deadline-Ms": "30000"})
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return {"status": resp.status,
                        "retry_after": resp.getheader("Retry-After")}
            toks, first, tail = [], None, None
            for line in resp:
                ev = json.loads(line)
                if "token" in ev:
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.append(ev["token"])
                elif ev.get("done"):
                    tail = ev
                    break
            if toks != want[i % len(prompts)]:
                raise AssertionError(f"tokens {toks}, tail {tail}")
            if ttft is not None:
                ttft.append(first)
            if slo is not None:
                slo.observe("gen.ttft_seconds", first)
            return {"status": 200}
        finally:
            conn.close()

    return send


def phase_fleet_controller(serving):
    """``FleetController(router, policy=CTL_POLICY, standby_factory=...)``
    on the card: one ``FleetReplica`` serving, a standby warmed on
    ``cuda:0`` by ``prewarm()``, ``TrafficReplay`` stepping real
    ``/generate`` streams (the ten prompts, each returned stream checked)
    from ``CTL_BASE_RPS`` to ``CTL_PEAK_RPS``.  The p99 TTFT objective is
    half the one-replica TTFT median measured at the peak in the phase,
    so the breach is device work.  Held to: the ladder climbs, the
    standby is enrolled (``controller.scale_ups`` + 1,
    ``controller.standbys_warmed`` >= 1) and serves without a kernel
    build, no accepted request lost, every shed with ``Retry-After``;
    after the step the idle drain returns the fleet to one replica and
    ``shutdown(drain_owned=True)`` leaves only the base replica, drained
    last.  Launches: ``n_layer`` a prefill and a decode step plus the
    standbys' warmups (each as the base's).  Prints the time to scale,
    sheds and TTFT p50 / p99 before (one replica) and under the
    controller."""
    import numpy as np
    from paddle_tpu_torch.fleet import FleetController, FleetRouter
    from paddle_tpu_torch.fleet.traffic import TrafficReplay, step
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.obs.slo import SLOWatchdog
    from paddle_tpu_torch.parallel.master import MasterServer, MasterService
    from paddle_tpu_torch.profiler import RuntimeMetrics, runtime_metrics

    prompts, want = serving["prompts"], serving["streams"]
    bundle = serving["bundle"]
    # the watchdog logs every breaching evaluation (ten a second here)
    slo_logger = logging.getLogger("paddle_tpu_torch.obs.slo")
    slo_level = slo_logger.level
    slo_logger.setLevel(logging.ERROR)
    svc = MasterService(replica_ttl=FLEET_LEASE_TTL_S)
    master = MasterServer(svc, port=0)
    master.start_background()
    maddr = f"127.0.0.1:{master.addr[1]}"
    launches = _Launches()
    made, router, controller, base, errors = [], None, None, None, []
    counter = runtime_metrics.counter
    c0 = {k: counter(k) for k in ("controller.scale_ups",
                                  "controller.scale_downs",
                                  "controller.standbys_warmed",
                                  "fleet.admission_shed")}
    out = {}
    try:
        base = launches.warm(
            lambda: _fleet_replica(bundle, maddr, "ctl-base").start())
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        raddr = f"127.0.0.1:{router.addr[1]}"
        _wait_for("controller: the base replica in the router",
                  lambda: len(router.live_replicas()) == 1, 10)

        # one replica at the peak: its TTFT median, halved, is the SLO
        before = []
        summary = TrafficReplay(
            _generate_sender(raddr, prompts, want, errors, ttft=before),
            lambda t: CTL_PEAK_RPS, CTL_MEASURE_S, seed=SEED % 2 ** 31,
            max_inflight=256).run()
        if summary["lost_accepted"] or not before:
            raise AssertionError(f"controller: one replica at the peak "
                                 f"{summary}, errors {errors[:5]}")
        objective = float(np.median(before)) / 2
        slo = RuntimeMetrics()
        watchdog = SLOWatchdog({
            "version": 1, "interval_seconds": 0.1,
            "sustained_breaches": 2,
            "objectives": [{"name": "ttft-p99", "kind": "quantile",
                            "series": "gen.ttft_seconds", "quantile": "p99",
                            "max": objective}]}, metrics=slo)

        def factory():
            made.append(_fleet_replica(bundle, maddr,
                                       f"ctl-standby-{len(made)}"))
            return made[-1]

        controller = FleetController(router, policy=CTL_POLICY,
                                     standby_factory=factory,
                                     watchdog=watchdog)
        builds = dict(build.counts)
        launches.warm(lambda: controller.prewarm())
        if len(made) != 1 or launches.warmups[-1] != launches.warmups[0]:
            raise AssertionError(f"controller: prewarm made {len(made)} "
                                 f"standbys, launches {launches.warmups}")
        standby_launches = launches.warmups.pop()
        seen = {}

        def watch():
            while controller is not None and not seen.get("stop"):
                st = controller.state()
                if st["degrade_level"] and "climb_t" not in seen:
                    seen["climb_t"] = time.monotonic()
                if counter("controller.scale_ups") > \
                        c0["controller.scale_ups"] and "scale_t" not in seen:
                    seen["scale_t"] = time.monotonic()
                seen["max_level"] = max(seen.get("max_level", 0),
                                        st["degrade_level"])
                time.sleep(0.01)

        controller.start()
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        after = []
        t0 = time.monotonic()
        summary = TrafficReplay(
            _generate_sender(raddr, prompts, want, errors, ttft=after,
                             slo=slo),
            step(CTL_BASE_RPS, CTL_PEAK_RPS, CTL_STEP_AT_S, CTL_PEAK_S),
            CTL_REPLAY_S, seed=SEED % 2 ** 31 + 1, max_inflight=256).run()
        # the promoted standby's own request (the step may end before
        # the router sends it one), while the pressure still holds it in
        promoted = made[0]
        events, _ = _stream_events(f"127.0.0.1:{promoted.addr[1]}",
                                   prompts[0])
        _check_stream("controller[promoted standby]", events, want[0])
        # the burst's window closes with the replay: from here on the
        # objective has nothing to judge and the ladder walks down
        slo.reset()
        _wait_for("controller: the idle drain back to one replica",
                  lambda: counter("controller.scale_downs") >
                  c0["controller.scale_downs"] and
                  len(router.live_replicas()) == 1 and
                  controller.state()["degrade_level"] == 0, 60)
        seen["stop"] = True
        watcher.join(10)
        served = promoted.server.gen_predictor.prefills
        controller.shutdown(drain_owned=True)
        gone = [r for r in made
                if _http_status(f"127.0.0.1:{r.addr[1]}", "/healthz") != 599]
        delta = {k: counter(k) - v for k, v in c0.items()}
        if seen.get("max_level", 0) < 1 or \
                delta["controller.scale_ups"] != 1 or \
                delta["controller.standbys_warmed"] < 1 or \
                delta["controller.scale_downs"] < 1 or not served or \
                dict(build.counts) != builds or gone or \
                summary["lost_accepted"] or summary["shed_without_hint"] or \
                summary["outcomes"]["dropped"]:
            raise AssertionError(
                f"controller: seen {seen}, counters {delta}, the promoted "
                f"standby's prefills {served}, builds {builds} -> "
                f"{dict(build.counts)}, still serving {gone}, replay "
                f"{summary}, errors {errors[:5]}")
        step_t = t0 + CTL_STEP_AT_S
        out.update(
            objective_ms=1e3 * objective,
            time_to_climb_s=seen["climb_t"] - step_t,
            time_to_scale_s=seen["scale_t"] - step_t,
            max_level=seen["max_level"], counters=delta,
            replay=summary,
            ttft_before_ms={q: 1e3 * float(np.percentile(before, q))
                            for q in (50, 99)},
            ttft_after_ms={q: 1e3 * float(np.percentile(after, q))
                           for q in (50, 99)})
        # the standbys warmed after prewarm's ran on the controller's
        # thread, beside the traffic: each launched what prewarm's did
        extra = {k: n * (delta["controller.standbys_warmed"] - 1)
                 for k, n in standby_launches.items()}
        prefills, steps = _expect_serving_launches(
            "controller", launches.take(),
            [base.server.gen_predictor] +
            [r.server.gen_predictor for r in made], extra=extra)
        out.update(prefills=prefills, decode_steps=steps)
    finally:
        if controller is not None:
            controller.shutdown(drain_owned=True)
        if router is not None:
            router.shutdown()
        if base is not None:
            base.drain(deadline_s=0)
        master.shutdown()
        slo_logger.setLevel(slo_level)
    out["card"] = card_line()
    log(f"fleet_controller: objective p99 TTFT {out['objective_ms']:.1f} ms "
        f"(half the one-replica median at {CTL_PEAK_RPS:g}/s); ladder to "
        f"level {out['max_level']} {out['time_to_climb_s']:.3f} s and the "
        f"standby enrolled {out['time_to_scale_s']:.3f} s after the step; "
        f"counters {out['counters']}; replay {out['replay']}; TTFT ms "
        f"before {out['ttft_before_ms']}, under the controller "
        f"{out['ttft_after_ms']}; card {out['card']}")
    return launches.take(), out


#: ``phase_master_train``: the tasks (one batch in each recordio file),
#: the tasks the first trainer finishes before it abandons its next
#: lease (the last, so the drained order is the uninterrupted one), and
#: the master's lease timeout, over a task's first run
MASTER_TASKS, MASTER_ABANDON_AFTER = 3, 2
MASTER_TASK_TIMEOUT_S = 4.0


def phase_master_train():
    """Route A at full width (Transformer-base, S 256, B 64, bf16 AMP,
    Adam, dropout 0 as in ``phase_checkpoint_resume``) fed by the
    master's task leases: ``MASTER_TASKS`` distinct ``T.fake_batch``
    batches, one pickled record in each recordio file, split into tasks
    by ``partition_files`` and served by a ``MasterServer``.  Run 1:
    ``cloud_reader`` yields every batch and ``Executor.run`` trains on
    each in task order.  Run 2, the JAX package's fault-tolerance drill
    in process: a ``MasterClient`` loop get_task -> run -> task_finished
    -> ``CheckpointManager.save``; after ``MASTER_ABANDON_AFTER`` tasks
    it leases one more and drops it with its executor and scope; the
    master requeues it at its lease timeout with a new epoch, the old
    epoch's late finish is refused, and a fresh executor
    ``restore_latest()``s and drains the rest.  Every persistable after
    run 2 equals run 1's bit for bit; both runs launch 18 bias softmaxes
    and 18 grads a step.  Prints a task's seconds and the requeue
    delay."""
    import pickle
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fault import CheckpointManager
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel.master import (MasterClient, MasterServer,
                                                  MasterService,
                                                  partition_files)
    from paddle_tpu_torch.reader.creator import cloud_reader
    from paddle_tpu_torch.recordio_writer import (
        RecordIOScanner, convert_reader_to_recordio_file)

    B, S, kernels = ROUTES["A"]
    root = os.path.join(OUT_DIR, "master_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    main, startup, cost, hp = _ckpt_program(pt, T)
    paths = []
    for i in range(MASTER_TASKS):
        b = T.fake_batch(B, S, S, hp, seed=SEED % 2 ** 31 + 300 + i)
        paths.append(os.path.join(root, f"task-{i}.recordio"))
        convert_reader_to_recordio_file(
            paths[-1], lambda b=b: iter([tuple(b[k] for k in READER_KEYS)]),
            compressor=0)
    scope0 = pt.Scope()
    pt.Executor().run(startup, scope=scope0)
    _no_launches("master_train")
    want_launches = {k: 18 * MASTER_TASKS for k in kernels}
    servers = []

    def serve():
        svc = MasterService(partition_files(paths),
                            timeout=MASTER_TASK_TIMEOUT_S)
        servers.append(MasterServer(svc, port=0))
        servers[-1].start_background()
        return svc, f"127.0.0.1:{servers[-1].addr[1]}"

    def run_task(exe, scope, task):
        (path,) = task.chunks
        (rec,) = list(RecordIOScanner(path))
        exe.run(main, feed=dict(zip(READER_KEYS, pickle.loads(rec))),
                fetch_list=[cost], scope=scope)

    try:
        # run 1: cloud_reader over the master, uninterrupted
        svc, maddr = serve()
        exe, scope = pt.Executor(), _scope_copy(pt, scope0)
        n = 0
        for sample in cloud_reader(maddr)():
            exe.run(main, feed=dict(zip(READER_KEYS, sample)),
                    fetch_list=[cost], scope=scope)
            n += 1
        if n != MASTER_TASKS or svc.stats()["done"] != MASTER_TASKS:
            raise AssertionError(f"master_train: cloud_reader yielded {n} "
                                 f"batches, {svc.stats()}")
        want = _tensor_state(scope)
        first = _take_launches()
        del exe, scope

        # run 2: a trainer dies holding a lease; the master requeues it
        svc, maddr = serve()
        ckdir = os.path.join(root, "ckpt")
        exe, scope = pt.Executor(), _scope_copy(pt, scope0)
        mgr = CheckpointManager(ckdir, keep=2, executor=exe,
                                main_program=main, scope=scope)
        client = MasterClient(maddr, trainer_id="trainer-0")
        task_s, save_s = [], []
        while True:
            task = client.get_task()
            if len(task_s) == MASTER_ABANDON_AFTER:
                break
            t = time.perf_counter()
            run_task(exe, scope, task)
            torch.cuda.synchronize()
            task_s.append(time.perf_counter() - t)
            if not client.task_finished(task.id, task.epoch):
                raise AssertionError(f"master_train: task {task.id} "
                                     f"refused")
            t = time.perf_counter()
            mgr.save(len(task_s))
            save_s.append(time.perf_counter() - t)
        abandoned, t_abandon = task, time.monotonic()
        client.close()
        del exe, scope, mgr, client
        gc.collect()
        exe, scope = pt.Executor(), pt.Scope()
        mgr = CheckpointManager(ckdir, keep=2, executor=exe,
                                main_program=main, scope=scope)
        t = time.perf_counter()
        restored = mgr.restore_latest()
        restore_s = time.perf_counter() - t
        client = MasterClient(maddr, trainer_id="trainer-1")
        requeue_s = None
        while True:
            task = client.get_task()
            if task is None:
                if client.all_done():
                    break
                time.sleep(0.01)
                continue
            if task.id == abandoned.id:
                requeue_s = time.monotonic() - t_abandon
                if task.epoch <= abandoned.epoch or client.task_finished(
                        abandoned.id, abandoned.epoch):
                    raise AssertionError(
                        f"master_train: the requeued lease's epoch "
                        f"{task.epoch} after {abandoned.epoch}, or the "
                        f"old epoch's finish taken")
            t = time.perf_counter()
            run_task(exe, scope, task)
            torch.cuda.synchronize()
            task_s.append(time.perf_counter() - t)
            if not client.task_finished(task.id, task.epoch):
                raise AssertionError(f"master_train: task {task.id} "
                                     f"refused")
        client.close()
        got = _tensor_state(scope)
        second = _take_launches()
        stats = svc.stats()
    finally:
        for s in servers:
            s.shutdown()
    differ = [n for n in want if n not in got or
              not np.array_equal(got[n], want[n])]
    if restored != MASTER_ABANDON_AFTER or requeue_s is None or \
            sorted(got) != sorted(want) or differ or \
            stats["done"] != MASTER_TASKS or \
            first != want_launches or second != want_launches:
        raise AssertionError(
            f"master_train: restored {restored}, requeued after "
            f"{requeue_s}, {len(differ)} variables differ {differ[:5]}, "
            f"master {stats}, launches {first} / {second}")
    shutil.rmtree(root, ignore_errors=True)
    del scope0
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(task_s=task_s, save_s=save_s, restore_s=restore_s,
               requeue_s=requeue_s, variables=len(want),
               bit_identical=True, card=card_line())
    log(f"master_train[A, dropout 0]: {MASTER_TASKS} tasks leased through "
        f"cloud_reader, then a trainer abandoning task {abandoned.id} "
        f"after {MASTER_ABANDON_AFTER}: requeued with a new epoch after "
        f"{requeue_s:.3f} s, the old epoch's finish refused, restored "
        f"step {restored} in {restore_s:.3f} s; all {len(want)} "
        f"persistables bit-identical; a task's seconds "
        f"{[round(x, 3) for x in task_s]}, saves {save_s}; card "
        f"{out['card']}")
    launches = {k: first.get(k, 0) + second.get(k, 0) for k in kernels}
    return launches, out


KERNEL_NOTES = {
    "flash_fwd": {"repaired": "bf16 T(p) cast before the product with v",
                  "redesigned": "bf16 on the tensor cores"},
    "flash_dq": {"redesigned": "bf16 on the tensor cores"},
    "flash_dkdv": {"redesigned": "bf16 on the tensor cores"},
    "smalls_fwd": {"also_replaces": "exp_smalls_attn.py:48",
                   "redesigned": "bf16 forward on the tensor cores"},
    "smalls_bwd": {"also_replaces": "exp_smalls_attn.py:74",
                   "redesigned": "bf16 backward on the tensor cores"},
    "bshd_fwd": {"redesigned": "bf16 forward on the tensor cores"},
    "bshd_bwd": {"redesigned": "bf16 backward on the tensor cores"},
    "conv3x3": {"redesigned": "bf16 on the tensor cores"},
    "bias_softmax": {"redesigned": "one warp a row in registers, 16-byte "
                                   "loads, shuffle reductions (Sk <= 1024)"},
    "paged_decode": {"redesigned": "split over the cache in partitions, "
                                   "partials merged by a second kernel"},
}


#: each phase's wall seconds (``timed``), printed on a line before the
#: last
PHASE_SECONDS = {}
START = time.perf_counter()


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds added to
    ``PHASE_SECONDS[name]`` (``name[arg]`` for a phase run once a string
    argument, such as a route, ``name[key=value]`` with keywords)."""
    tags = [a for a in args[:1] if isinstance(a, str)] + \
        [f"{k}={v}" for k, v in kw.items()]
    if tags:
        name = f"{name}[{','.join(tags)}]"
    t = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = round(
            PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t, 3)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port (paddle_tpu_torch) is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = timed("build", build.build_all)
    log(f"build: {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.2f}s with {build.find_nvcc()}")
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for src, text in logs.items():
            f.write(f"--- {src}\n{text}\n")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # the flash gate stays at its default (512): route A (S = 256) takes
    # the composed attention, routes B (S = 2048) and C (S = 512) the
    # fused op, which runs the flash kernels on B and the single-pass
    # pair on C (smalls_ok)
    os.environ.pop("PADDLE_TPU_FLASH_MIN_S", None)
    from paddle_tpu_torch.kernels import ALL_KERNELS
    errs, rows = {}, {}
    errs["paged_decode"], paged_rows = timed("paged", phase_paged)
    rows["paged_decode"] = paged_rows["serving"]
    errs["bias_softmax"], sm_rows = timed("softmax", phase_softmax)
    # route A runs 12 row-bias (encoder self, cross) bias softmaxes a step
    # for 6 causal ones, and 90 of its 110 launches here: that is the row
    rows["bias_softmax"] = sm_rows["route A row"]
    errs["bias_softmax_grad"], rows["bias_softmax_grad"] = \
        timed("softmax_grad", phase_softmax_grad)
    flash_err, flash_rows = timed("flash", phase_flash)
    for name in ("flash_fwd", "flash_dq", "flash_dkdv"):
        errs[name] = flash_err[name]
        # route B runs 12 key-masked (encoder self, cross) attentions a
        # step for 6 causal ones: the key-masked shape is the table's row
        rows[name] = flash_rows[(name, "key-masked")]
    tensor_core = timed("sass", phase_sass)
    smalls_err, smalls_rows = timed("smalls", phase_smalls)
    for name in ("smalls_fwd", "smalls_bwd"):
        errs[name] = smalls_err[name]
        # route C, like route B: 12 key-masked attentions a step for 6
        # causal ones
        rows[name] = smalls_rows[(name, "key-masked")]
    bshd_err, bshd_rows = timed("bshd", phase_bshd)
    for name in ("bshd_fwd", "bshd_bwd"):
        errs[name], rows[name] = bshd_err[name], bshd_rows[name]
    errs["conv3x3"], conv_rows = timed("conv3x3", phase_conv3x3)
    # ResNet-50's first stage runs 3 of its 16 bodies at 56x56x64 and its
    # largest activations: the table's row
    rows["conv3x3"] = conv_rows[CONV3X3_SHAPES[0]]

    # the sentinel bundle's CPU replays run beside the phases from here
    # on; the kernels' device times above are taken first, in a process
    # that has run nothing else on the card (after a route A step the
    # profiler's captures of the paged kernels came back short three
    # times running)
    replays = timed("sentinel_replay_start", start_replays)
    by_path = {}
    by_path["serving"], serving = timed("serving", phase_serving)
    by_path["http_generate"], http_gen = timed(
        "http_generate", phase_http_generate, serving)
    by_path["http_resume"], http_resume = timed(
        "http_resume", phase_http_resume, serving)
    http_predict = timed("http_predict", phase_http_predict)
    by_path["cli_train"], cli = timed("cli", phase_cli, serving)
    by_path["serving_budget"], serving_budget = timed(
        "serving_budget", phase_serving_budget, serving, http_gen)
    by_path["dense_decode"], dense = timed("serving", phase_serving,
                                           paged=False)
    graph_serving = timed("graph_serving", phase_graph_serving, serving)
    train, graph_train = {}, {}
    for route in ROUTES:
        by_path[f"train_{route}"], train[route] = timed(
            "train", phase_train, route)
    for route in ROUTES:
        by_path[f"graph_train_{route}"], graph_train[route] = \
            timed("graph_train", phase_graph_train, route)
    by_path["train_opt_A"], train_opt, opt_state = timed(
        "train_opt", phase_train_opt, "A")
    by_path["check_nan_inf"], nan_check = timed(
        "check_nan_inf", phase_check_nan_inf, opt_state)
    del opt_state
    by_path["gen_lm_train"] = timed("gen_lm_train", phase_gen_lm_train)
    by_path["bshd_attention"], bshd_path = timed("bshd_path", phase_bshd_path)
    for name, e in (("bshd_fwd", "fwd_plain"), ("bshd_bwd", "bwd_plain")):
        errs[name] = max(errs[name], bshd_path["numerics"][e])
    conv_train, resnet_state = {}, None
    for model in CONV_MODELS:
        by_path[f"{model}_train"], conv_train[model], state = \
            timed("train_conv", phase_train_conv, model)
        resnet_state = resnet_state or state
    by_path["resnet50_infer"], infer_err = timed(
        "infer_conv3x3", phase_infer_conv3x3, resnet_state)
    errs["conv3x3"] = max(errs["conv3x3"], infer_err)
    del resnet_state
    torch.cuda.empty_cache()
    checks = {route: timed("card_vs_cpu", phase_card_vs_cpu, route)
              for route in ROUTES}
    resnet_check = timed("card_vs_cpu_resnet50", phase_card_vs_cpu_resnet50)
    wide_deep = timed("wide_deep", phase_wide_deep)
    stacked_lstm = timed("stacked_lstm", phase_stacked_lstm)
    lstm_buckets = timed("stacked_lstm_buckets", phase_stacked_lstm_buckets)
    sequence_nets = timed("sequence_nets", phase_sequence_nets)
    seq2seq = timed("seq2seq", phase_seq2seq)
    s2s_buckets = timed("seq2seq_buckets", phase_seq2seq_buckets)
    beam_decode = timed("beam_decode", phase_beam_decode)
    optimizers = timed("optimizers", phase_optimizers)
    by_path["reader_train"], by_path["reader_train_memory"], \
        reader_train = timed("reader_train", phase_reader_train)
    by_path["checkpoint_resume"], checkpoint_resume = \
        timed("checkpoint_resume", phase_checkpoint_resume)
    by_path["sentinel"], sentinel = timed("sentinel", phase_sentinel)
    dp_launches, datapipe_train = timed("datapipe_train",
                                        phase_datapipe_train)
    for part, n in dp_launches.items():
        by_path[f"datapipe_{part}"] = n
    by_path["perf"], by_path["perf_cli"], by_path["perf_decode"], \
        perf_out = timed("perf", phase_perf, serving)
    op_families = timed("op_families", phase_op_families)
    srl = timed("label_semantic_roles", phase_label_semantic_roles)
    ssd = timed("ssd", phase_ssd)
    torch.cuda.empty_cache()
    ssd["card_vs_cpu"] = timed("card_vs_cpu_ssd", phase_card_vs_cpu_ssd)
    csp = timed("csp", phase_csp)
    by_path["parallel_train"], parallel_train = timed(
        "parallel_train", phase_parallel_train)
    by_path["pipeline_train"], pipeline_train = timed(
        "pipeline_train", phase_pipeline_train)
    sharded_tables = timed("sharded_tables", phase_sharded_tables)
    by_path["fleet"], fleet = timed("fleet", phase_fleet, serving)
    by_path["fleet_controller"], fleet_controller = timed(
        "fleet_controller", phase_fleet_controller, serving)
    by_path["master_train"], master_train = timed("master_train",
                                                  phase_master_train)
    sentinel_replay = timed("sentinel_replay_join", join_replays, replays)

    kernels = []
    for k in ALL_KERNELS:
        r = rows[k.name]
        paths = {p: n[k.name] for p, n in by_path.items()
                 if n.get(k.name)}
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": errs[k.name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        for extra in ("device_ms", "cudnn_conv_ms", "body"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        kernels[-1].update(KERNEL_NOTES.get(k.name, {}))
        if k.name in tensor_core:
            kernels[-1]["sass_mma"] = tensor_core[k.name]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on a main "
                                 f"path")
    log(f"serving: tokens_per_s={serving['tokens_per_s']:.1f} "
        f"decode_step_ms={serving['decode_step_ms']:.3f}")
    for kind in ("http", "in_process"):
        log(f"http_generate[{kind}, median min max of "
            f"{http_gen['rounds']} rounds]: " + " ".join(
                f"{k}={v['median']:.3f},{v['min']:.3f},{v['max']:.3f}"
                for k, v in http_gen[kind].items()))
    log("http_generate: " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in http_gen.items() if k not in ("http", "in_process")))
    log(f"http_resume: {http_resume}")
    log("http_predict: " + " ".join(
        f"{m}_rows_per_s={v['rows_per_s']:.1f}"
        for m, v in http_predict.items()) +
        f" occupancy={http_predict['batched']['occupancy']}")
    log(f"cli: {cli}")
    log("serving_budget: " + json.dumps(serving_budget))
    log("train_opt[A]: " + json.dumps(train_opt))
    log("check_nan_inf: " + json.dumps(nan_check))
    log(f"dense decode: tokens_per_s={dense['tokens_per_s']:.1f} "
        f"decode_step_ms={dense['decode_step_ms']:.3f}")
    for route, t in train.items():
        log(f"train[{route}]: step_ms={t['step_ms']:.2f} "
            f"tokens_per_s={t['tokens_per_s']:.1f} "
            f"peak_gib={t['peak_gib']:.2f}")
    for route, c in checks.items():
        log(f"card-vs-cpu[{route}]: loss_rel={c['loss_rel']:.3e} "
            f"grad_rel={c['grad_rel']:.3e} param_max={c['param_max']:.3e} "
            f"relu_kinks={c['relu_kinks']}")
    for model, t in conv_train.items():
        log(f"train[{model}]: B={t['batch']} step_ms={t['step_ms']:.2f} "
            f"images_per_s={t['images_per_s']:.1f} mfu={t['mfu']:.4f} "
            f"peak_gib={t['peak_gib']:.2f}")
    log("card-vs-cpu[resnet50]: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in resnet_check.items()))
    for name in ("sparse", "sparse_2**20", "dense"):
        w = wide_deep[name]
        log(f"wide_deep[{name}]: step_ms={w['step_ms']:.3f} "
            f"examples_per_s={w['examples_per_s']:.1f} "
            f"peak_above_state_gib={w['peak_above_state_gib']:.4f}")
    log(f"wide_deep: unique_rows={wide_deep['unique_rows']} of "
        f"{wide_deep['ids']} ids; card-vs-cpu " + " ".join(
            f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
            for k, v in wide_deep["card_vs_cpu"].items()))
    log(f"stacked_lstm[LSTM-IMDB-H512]: step_ms="
        f"{stacked_lstm['step_ms']:.3f} sequences_per_s="
        f"{stacked_lstm['sequences_per_s']:.2f} rows_per_step="
        f"{stacked_lstm['rows_per_step']} peak_gib="
        f"{stacked_lstm['peak_gib']:.3f} ragged_step_ms="
        f"{stacked_lstm['ragged_step_ms']:.3f}; card-vs-cpu " + " ".join(
            f"{k}={v:.3e}" for k, v in stacked_lstm["card_vs_cpu"].items()))
    log("stacked_lstm_buckets: " + json.dumps(lstm_buckets))
    log("sequence_nets: " + " ".join(
        f"{n}_step_ms={v['step_ms']:.3f}" for n, v in sequence_nets.items()))
    log(f"seq2seq[Seq2Seq-NMT-512]: step_ms={seq2seq['step_ms']:.3f} "
        f"target_tokens_per_s={seq2seq['target_tokens_per_s']:.1f} "
        f"while_trips={seq2seq['while_trips']} "
        f"device_reads={seq2seq['host_reads']} peak_above_state_gib="
        f"{seq2seq['peak_above_state_gib']:.4f} ragged_step_ms="
        f"{seq2seq['ragged_step_ms']:.3f}; card-vs-cpu " + " ".join(
            f"{k}={v:.3e}" for k, v in seq2seq["card_vs_cpu"].items()))
    log("seq2seq_buckets: " + json.dumps(s2s_buckets))
    log(f"beam_decode: decode_ms={beam_decode['decode_ms']:.3f} "
        f"eager_decode_ms={beam_decode['eager_decode_ms']:.3f} "
        f"static_decode_ms={beam_decode['static_decode_ms']:.3f} "
        f"card_cpu_gap={beam_decode['card_cpu_gap']:.3e} "
        f"card_cpu_score_rel={beam_decode['card_cpu_score_rel']:.2e}")
    log(f"optimizers: max abs diff card vs cpu "
        f"{max(optimizers.values()):.3e} over {len(optimizers)} programs")
    log("reader_train: " + json.dumps(reader_train))
    log("checkpoint_resume: " + json.dumps(checkpoint_resume))
    log("sentinel: " + json.dumps(sentinel))
    log("datapipe_train: " + json.dumps(datapipe_train))
    log("sentinel_replay[A]: " + json.dumps(sentinel_replay))
    log("perf: " + json.dumps(perf_out))
    log("op_families: " + json.dumps(op_families))
    log(f"label_semantic_roles[book]: step_ms={srl['step_ms']:.3f} "
        f"tokens_per_s={srl['tokens_per_s']:.1f} state_gib="
        f"{srl['state_gib']:.4f} peak_above_gib={srl['peak_gib']:.4f} "
        f"first_step_ms={srl['first_step_ms']:.1f} "
        f"chunk={json.dumps(srl['chunk'])}; card-vs-cpu " + " ".join(
            f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
            for k, v in srl["card_vs_cpu"].items()))
    log(f"ssd[MobileNet-SSD]: step_ms={ssd['step_ms']:.3f} "
        f"images_per_s={ssd['images_per_s']:.1f} state_gib="
        f"{ssd['state_gib']:.4f} peak_above_gib={ssd['peak_gib']:.4f} "
        f"first_step_ms={ssd['first_step_ms']:.1f} map={ssd['map']:.6f} "
        f"detections={ssd['detections']} served_rows={ssd['served_rows']}"
        f"; card-vs-cpu " + " ".join(
            f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ssd["card_vs_cpu"].items()))
    log("csp: " + json.dumps(csp))
    log("parallel_train: " + json.dumps(parallel_train))
    log("pipeline_train: " + json.dumps(pipeline_train))
    log("sharded_tables: " + json.dumps(sharded_tables))
    log("fleet: " + json.dumps(fleet))
    log("fleet_controller: " + json.dumps(fleet_controller))
    log("master_train: " + json.dumps(master_train))
    log("bshd attention (forward + backward): " + " ".join(
        f"{r}={bshd_path[f'{r}_ms']:.4f}ms" for r in bshd_path["route_errs"]))
    for route, g in graph_train.items():
        log(f"graph_train[{route}]: " + json.dumps(g))
    log("graph_serving: " + json.dumps(graph_serving))
    log("graphed paths: " + json.dumps(sorted({g["path"] for g in GRAPHS})))
    log(json.dumps({"graphs": GRAPHS}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"profiler_short_captures": PROFILER_SHORT}))
    log(json.dumps({"phase_seconds": PHASE_SECONDS,
                    "total_s": round(time.perf_counter() - START, 1)}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-trainer"]:
        # a trainer process of phase_checkpoint_resume
        sys.path.insert(0, ROOT)
        sys.exit(ckpt_trainer(sys.argv[2:]))
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    finally:
        stop_replays()
    sys.exit(code)
