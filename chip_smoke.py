#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, run; exit 0 only if all pass

Run from the root of a checkout. It uses ``mmlspark_tpu_torch`` only (no JAX,
nothing of ``mmlspark_tpu``) and needs one CUDA device:

1. header: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the seconds it takes to build every kernel under
   ``mmlspark_tpu_torch/csrc`` with nvcc (one process per source) and the
   native C++ library with g++ (``native_loader``; its build failing fails
   the run);
2. kernels: K1 (histogram) and K2 (row select) against their plain PyTorch
   versions on the card, at the main path's shapes and at ragged ones, each
   timed beside its plain version, one PyTorch library call computing the
   same function, and its bound (bytes or operations over the H100's peak);
   both also with the host's cost of issuing them hidden (their device-only
   time) and their CUDA launches per call; K1 also beside its sector floor
   (the 32-byte sectors that hold a selected row), and whether two calls
   agree bit for bit (logged);
3. scan_main: ``LightGBMClassifier(numLeaves=31, maxBin=255,
   numIterations=20).fit`` on a seeded synthetic HIGGS-shaped dataset
   (2,097,152 rows x 28 features) on the card, on its default route, the
   whole-run scan (checked): its boosting loop under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host read in it fails
   the run; then ``.transform`` of 65,536 rows. K1's two entries (the mask
   entry at each root, the device-count entry at every split) and K2 must
   have launched, counted through the CUDA graph's replays. Logs the fit's,
   the native binning's and the loop's seconds and peak memory. The scores
   are held against the host f64 traversal of the same model, and the
   first three trees of a card scan on 131,072 of the rows against the
   CPU's forced scan (``MMLSPARK_TPU_SCAN_TRAIN=1``) on them. Then K1 and
   K2 on the fit's own data: the binned matrix at the root (every row), the
   first tree's first K2 compaction bit for bit, K1 on that buffer, and
   K1's device-count entry on it and its device-held count against its
   plain version (bit for bit against the per-split launch, logged);
3a. fused_tree: the same data forced to the fused per-tree route and to the
   per-split host route, 5 iterations each: the same trees (features,
   bins, counts, default directions, children; gains and hessian sums
   within 1e-6 relative, bitwise logged), seconds a tree on both, and on
   the fused route exactly one host read a tree (the synchronizing calls
   the sync debug mode sees logged);
3a'. native_main: a 200,000 x 28, 20-iteration fit that routes ``native``
   by default, bit for bit the same fit on the CPU; on the 2,097,152-row
   matrix native binning against the numpy path and, on 65,536 rows,
   ``forest_predict_f64`` against the numpy traversal, bit for bit, with
   both times;
3a''. profile: ``core.profiling`` device traces of the main fit on the
   per-split route (forced, 1 iteration) and on the scan: the device's busy share of
   the fit's window (spin kernels mark it), the top device operations, the
   longest idle gaps, K1's and K2's device ms (the serving_sparse load is
   traced in its own phase, 12);
3b. dense_variants: on the same data, ``boostingType`` goss (topRate 0.2,
   otherRate 0.1), dart (dropRate 0.1, maxDrop 50; 10 iterations) and rf
   (baggingFraction 0.9, baggingFreq 1) through ``LightGBMClassifier.fit``
   (goss and rf on the scan, their loops under
   ``set_sync_debug_mode("error")``, dart on the fused route, checked):
   fit and loop seconds, K1 and K2 launches
   (counted through the replays), GOSS's rows selected each iteration
   (exactly top_n + other_n); GOSS's Threefry draws (every one of the
   fit's 20 keys over 2,097,152 rows) and its two exact top-k selections
   on the fit's own keys and gradients, card against CPU bit for bit and
   timed; each model's transform against the host f64 traversal and its
   train AUC; the first three trees refit on the card and on the CPU over
   the first 131,072 rows on the same route (the native engine off: a cut
   that small would take it; goss and rf against the CPU's forced scan);
3c. ranker_main: ``LightGBMRanker`` on seeded MSLR-WEB30K-shaped data
   (2,097,152 rows x 136 features, relevance 0-4, queries of 1-1,251
   documents; 10% of the queries flagged by ``validationIndicatorCol``,
   ``earlyStoppingRound=5``, 20 iterations), then ``.transform`` and a
   fused transform of 65,536 rows: the LambdaRank gradient's time per
   iteration, the valid NDCG@10 per iteration and the best iteration, K1 and
   K2 launches, peak device memory; the card's iteration-0 g and h against
   the CPU's (``LAMBDARANK_RTOL``/``ATOL``) and the first tree against a CPU
   refit on the first whole queries of 65,536 rows, the transform against
   the host traversal, the fused transform bit for bit;
3d. categorical_main: ``LightGBMClassifier`` with six categorical
   slots (``categoricalSlotIndexes``; catSmooth 10, catL2 10,
   maxCatThreshold 32) on seeded rows shaped like the airline on-time
   benchmark of szilard/benchm-ml (``dep_delayed_15min``: Month,
   DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest of 12, 31, 7, 22,
   300 and 300 values, DepTime and Distance; 2,097,152 rows cut from its
   10M; about 19% positive), 20 iterations, 31 leaves, maxBin 255: fit
   seconds, K1 and K2 launches and K1's device time, peak device memory,
   and the holdout AUC (262,144 more rows) against the same fit without
   categorical slots. Gates: (a) K1 and K2 on the fit's first-tree inputs
   (``hist_on_path``); (b) a set split of >= 2 categories in the first
   tree; (c) the first 3 trees equal a CPU refit on 131,072 rows
   (features, bins, bin words, category sets; leaf values rtol 1e-5); (d)
   the card's ``DeviceEnsemble`` within rtol 1e-5, atol 1e-5 of the host
   traversal on 65,536 rows; (e) the fused transform bit for bit; (f)
   ``save_native_model`` -> ``load_native_model_from_file`` of this model
   and the dense main model within 1e-9 on the host and 1e-5 on the card
   (bitwise logged), LightGBM text re-exported byte-identical; (g) stage
   ``save`` -> ``load`` -> transform bit for bit; (h) a ``modelString``
   continuation (10 + 10 iterations, LightGBM text) with the CPU's first
   continued tree; (i) a checkpointed fit (bagging 0.8, 9 iterations, every
   3) preempted at its 6th iteration and resumed gives the uninterrupted
   fit's ``to_string()``;
4. sparse data: the reference benchmark's text-shaped CSR (1,000,000 rows x
   2^18 hashed features, ~50 token counts per row, seeded), with the host
   costs of the sparse path timed apart inside the stage fit (step 6, run
   before step 5): ``rows_to_csr`` over the rows, ``SparseDataset.from_csr``
   and the bin-sorted layout;
5. K4 (flat sparse histogram) against its plain version at that dataset's
   layout (~49.7M entries, ~1.31M flat bins, 50% row mask) and at ragged
   shapes, timed the same way; two calls on the main-path input must agree
   bit for bit;
6. sparse main path: ``LightGBMClassifier(numLeaves=31, numIterations=10,
   learningRate=0.1, minDataInLeaf=20).fit`` on a DataFrame of those sparse
   rows on its default route, the whole-run sparse scan (checked; its loop
   under ``set_sync_debug_mode("error")`` and timed apart from the in-fit
   host build), then ``.transform`` of 65,536 rows. K4 must have launched,
   counted through the graph's replays; the scores must equal the CPU
   ``predict_csr`` of the same model and the train accuracy exceed 0.7. A
   split's flat histogram on the full-width dataset is timed in parts: the
   row-mask gather and [3, nnz] stack, and K4. The root split of the
   full-width dataset is searched with the reference's f32 prefix formula
   and the port's f64 one; the reference benchmark's anchor shape (100,000
   x 2^12) is refit for 3 iterations on the card's scan and the CPU's
   forced scan, the 3 trees identical;
6b. sparse_variants: ``train_sparse`` with goss (on the scan; twice, the
   second at maxDepth 8 so the reference's rule turns lazy routing on) and
   dart (the fused loop), 31 leaves, 10 iterations, on the same full-width
   dataset: routes, loop seconds and K4 launches, the compaction the
   reference's rule picks (capacities, rows and entries selected each
   iteration, exactly top_n + other_n rows), K4 on the goss fit's own
   compacted stream against its plain version and timed beside the
   full-width call, the card's ``predict_csr`` against the CPU's; at the
   anchor shape, goss (compaction forced on both sides; the first tree's
   leaf values bit for bit) and dart refit on the card and the CPU for 2
   iterations on the same route (both trees identical), and through the
   stage entry point one fit with ``validationIndicatorCol`` and
   ``earlyStoppingRound=3`` and one with ``numBatches=2`` (identical first
   trees, same best iteration, same route);
6c. sparse_wide: ``train_sparse`` at 127 leaves, 2 iterations, on the
   full-width dataset, whose fused-grower state (3.98 GB) passes the 2 GiB
   gate: route ``host``, the per-split loop (checked), seconds a tree, host
   reads a split (at most two), peak device memory; the anchor refit for
   one iteration on the card and the CPU, both forced onto that loop
   (``MMLSPARK_TPU_FUSED_TREE_BYTES=0``), first tree identical;
7. K3 (CSR gather) against its plain version, bitwise: on the real 256-row
   CSR batches the fused executor stages from the sparse rows with the
   sparse model's used columns, on all 65,536 rows at once (two calls bit
   for bit equal), and at ragged shapes (empty rows, a padded row and nnz
   tail, used ids past the width, an all-leaf forest, no entries, used ids
   shuffled with duplicates, rows longer than a warp's window, 30,000 used
   ids, one row), timed beside its plain version, a PyTorch sparse-tensor
   call and its bound, and timed once more with the host's cost of issuing
   it hidden (the kernel's own device time), beside an empty launch's
   (``torch.cuda._sleep(1)``) time both ways; then at the executor's batch
   sizes up to the whole partition (256 to 65,536 rows), each with its
   bytes bound and the device-only time of other launch geometries;
8. fused scoring: ``PipelineModel([model]).fuse()`` on both models. Sparse:
   with ``layout="csr"`` and ``forest.csr`` over the same 65,536 rows the
   sparse path scored unfused — no fallback, 256 CSR batches and no
   densify, 256 K3 launches, within 1e-6 of the unfused transform, and the
   ``forest.gather``/``forest.gemm`` variants bit-identical; dense: the
   65,536 HIGGS-shaped rows bitwise-equal to the unfused transform; and at
   the anchor's 2^12 width the CSR-staged output bitwise-equal to the same
   rows sent as dense arrays. Fused and unfused seconds, the host CSR
   staging's share, the transfer ring's decomposition and the cache's hits
   and misses are printed;
9. attn_kernel: K5 (flash attention, ``csrc/flash_attn.cu``) against its
   plain version (the reference's XLA path) and both against exact f64
   attention, on bf16 [B, T, H, D] inputs: B=4, H=8, D=64 at T=2048 and
   8192, causal and not (the reference's flash A/B points); one main-path
   batch (B=64, T=2048, H=8, D=64); D=128 and 256 at T=1024, causal and
   not, D=384 and 512 at T=1024; B=1, H=1, T=1024; and short lengths (T=128
   to 512) that check the gate's default. In every case: max |K5 - plain|
   <= 0.05 (the reference's own flash-vs-XLA bound) and, per element, no
   more than ``ULPS_MAX`` bf16 ulps of sum_j p_j |v_j| (the magnitude the
   element is summed from), K5's max and rms error against f64 no more than
   ``F64_RATIO_MAX`` times the plain version's, and at every length the
   gate sends to K5, K5 faster than its plain version. Each case logs ms,
   plain_ms, library_ms (``scaled_dot_product_attention`` on [B, H, T, D],
   timed only), bound_ms and bound_by (4*B*H*Tq*Tk*D flops, halved under
   causal masking, over the spec 989 TFLOP/s bf16 peak, against 8 bytes
   per element over 3.35 TB/s) and K5's ms over library_ms; at the
   main-path batch that ratio must not pass ``K5_LIBRARY_RATIO_MAX``; and
   a batch past grid.z's cap (B=65,537, T=128, H=1, D=64), held on its
   first and last 64 rows to the same per-element gates. In every case K5
   also runs with its lse output (training's): the same output bits, the
   lse within ``LSE_TOL`` of the plain version's, timed both ways, and
   two calls give the same bits. Also K5's general path above
   D = 512 (``ATTN_WIDE_CASES``: D = 640, 768, 1024 at T=1024, causal and
   not, and D = 2048), held to the same correctness gates without the
   speed gate, each logging the library call's backend; no K5
   instantiation built in the run may spill or serialise its ``wgmma``;
9b. attn_bwd_kernel: K6 and K7 (the flash-attention backward,
   ``csrc/flash_attn_bwd.cu``: a TMA producer warp and two ``wgmma``
   consumer warpgroups each) on K5's own output and lse at the train
   shape (B=8, T=2048, H=8, D=64), causal and not, and at D=128 and 256:
   each gradient finite, its max and rms error against an exact f64
   backward within ``F64_RATIO_MAX`` of the plain backward's, two calls
   bit for bit; each kernel's ms and TFLOP/s beside the plain backward's,
   the whole ``flash_attention_bwd_cuda`` call (``bwd_total_ms``: di, K6,
   K7 and the allocations), the backward of
   ``scaled_dot_product_attention`` (``library_ms``, timed only) and its
   bound (K6 8, K7 6 * B*H*T*T*D flops, halved under causal masking), and
   each instantiation's ptxas registers, spills and notes from the build.
   At the train shape (K6 + K7) ms over library_ms must not pass
   ``BWD_LIBRARY_RATIO_MAX``, no K6/K7 instantiation may have its ``wgmma``
   pipeline serialised by ptxas (which cost up to 2x), and the train
   path's (D=64) may not spill. Also K6/K7 at D = 384, 512
   and 640 (B=2 or 1, T=2048, H=4, causal and not) through their
   128-column slices, whose instantiations may not spill either, each
   logging the library call's backend;
10. transformer_main: the reference's sequence-benchmark encoder
   (``tools/bench_seq.py:41``: dim 512, depth 4, 8 heads, vocab 32,000,
   seed 0) at seq_len 2048 served through
   ``DNNModel(inputCol="tokens", outputCol="emb", batchSize=64).transform``
   over 256 rows of uniform token ids (numpy ``default_rng(0)``) in 2
   partitions: 4 batches, 524,288 tokens, K5 launched exactly 16 times.
   The output must be finite and, against the same transform with
   ``MMLSPARK_TPU_NO_FLASH=1`` (plain attention on the card) and, for the
   first 2 rows, against the port on the CPU, every row's 1 - cosine
   within ``COS_GAP_MAX`` and the max and mean |difference| within
   ``OUT_MAX_DIFF`` and ``OUT_MEAN_DIFF``. Logs the first and a second
   transform's seconds, tokens/s, the transfer ring's per-batch
   decomposition (the readback on its own stream) and peak device memory;
11. transformer_fused: ``PipelineModel([dnn]).fuse()`` on the same rows
   (executor batch 64), bitwise-equal to the unfused output, with its
   seconds and ``fusion_stats()``.
12. serving (``mmlspark_tpu_torch.serving`` on the card; after 8 while
   its models are alive, and 15 after 11). serving_sparse: the sparse main
   model through ``serve_pipeline(fused, fused=True, async_exec=True,
   replicas=2, http_mode="async", max_batch_size=256)`` with the CSR layout
   and ``forest.csr`` set: 4,096 of the scoring rows as CSR frames over 64
   keep-alive connections; every reply 200, its probability within 1e-6
   of the unfused transform and its class equal to the unfused prediction,
   K3 launched, no host fallback and no densify; 256 of the rows
   bitwise-equal across the 4 modes (thread/async transport x
   serial/pipelined executor) and the 2 wires (JSON sparse dict, CSR
   frame); ``/_mmlspark/metrics`` carries the wire counters and the card's
   ``mmlspark_device_memory_bytes``; requests/s and client and server
   latencies logged;
13. serving_dense: the dense model served fused, 4,096 frames of 28 f64;
   every reply the unfused probability bit for bit (no kernel of the port
   runs here: the plain GEMM/gather traversal);
14. serving_front: a ``RoutingFront`` over two such workers, 512 requests,
   one worker stopped hard after 128 replies: every request answered 200
   bit for bit by the survivor, apart from the reference's allowed 504 for
   an unreplayed POST;
15. serving_transformer: the encoder of 10 served through
   ``serve_pipeline(PipelineModel([DNNModel(batchSize=64), frame reply]),
   fused=True, async_exec=True)``: 128 int32 token frames, replies f32
   frames held to the transformer gates of 10 against the transform of the
   same rows; K5 launched at least 2 x 4 times; tokens/s logged.
16. mega_sparse (after 8): the fused CSR path over the 65,536 sparse rows
   through ``transform_submit`` at K = 1 and 8 (``set_tuning(mega_k=)``;
   K = 4 cut for the script's time:
   K batches a replay of a CUDA graph captured per stream), each twice
   (capture, then measured with every launch counter at 0 and, at K > 1,
   the dispatch under ``set_sync_debug_mode("error")``): the outputs at
   K > 1 bit for bit K=1's and within the fused-CSR gate of the unfused
   transform; K3 launched once a batch through the replays; seconds, the
   per-batch dispatch ms, the mega groups and the graph count logged;
17. mega_dense: the 65,536 HIGGS-shaped rows the same way, every K bit for
   bit the unfused transform (the GEMM traversal under capture);
18. tuner: a ``SegmentCostModel`` folded from both runs (tallied costs,
   the executors' timings), then ``Tuner.tune(measure)`` for 3 steps on
   the fused sparse path (``measure``: rows/s over 16,384 rows): the
   proposed and applied knobs, the journal and rollbacks, the prediction
   error, and each segment's roofline attribution, whose bound must not
   pass its measured wall per batch (``BOUND_RATIO_MAX``);
19. serving_autotune: ``serve_pipeline(autotune=True, tune_every=50)`` on
   the sparse CSR path (1,024 frames) against the same server without a
   Tuner, pipelined and serial: a tuned server whose cost model declines
   every stitch replies byte for byte as the un-tuned one; a tuned server
   with the cost model as it comes replies byte for byte as the un-tuned
   one or, where the calibrated planner stitched the classifier's
   finalize, bit for bit as a fused model pinned stitched on the same
   rows (and within the stage's declared finalize tolerance of the
   host's); the ``tuner`` section and ``mmlspark_tuner_*`` families
   present; requests/s, p50/p99 and the knobs applied logged;
20. deposit: the dense rows as f32 per-row arrays (a frame's decoding)
   through fused transforms with pinned slot staging and without, then
   served as f32 frames both ways: bit for bit the copying path, a slot
   deposit a batch, the fallback copies accounted; both servers'
   requests/s and latencies logged;
21. mega_transformer (after 11): the encoder's 256 rows in one partition,
   fused, at K = 1 and 4: K=4's replay bit for bit K=1's, K5 launched 16
   times both ways.
22. train_transformer (after 15): the encoder of 10 with a 16-class
   per-token head trained through ``models.training.run_train_loop``, 20
   steps of 8 rows x 2048 tokens (tag = token // 2000, SGD 0.01, momentum
   0.9): (a) K5, K6 and K7 launched 4 times a step each; (b) step 1's
   gradients within ``TRAIN_GRAD_REL_L2`` (relative L2, per leaf) of plain
   attention's under autograd on the card; (c) the mean loss of the last
   5 steps below the first 5's; (d) 3 steps + a checkpoint + resume + 3
   bit for bit 6 steps; (e) the trained params served through
   ``DNNModel`` on 64 rows bit for bit ``FunctionModel.apply``, K5
   launched and K6/K7 not. Step ms, tokens/s, peak memory and the device's
   busy share of one profiled step; then a causal depth-1 run of 3 steps
   (gates a and b);
23. bilstm_train: ``tools/bench_seq.py``'s tagger (seq 512, embed 128,
   hidden 256, 16 tags) on 64 rows: the card's forward within
   ``DEEP_BF16_TOL`` of the CPU's, then 5 train steps whose loss falls.
23b. train_wide_d384, train_wide_d512, serve_wide_d640: the
   encoder of 10 at dim 1536 and 2048 with 4 heads (head dims 384 and
   512; depth 2) trained 3 steps through ``run_train_loop`` with gates (a)
   and (b) of 22, and at dim 2560 (head dim 640; depth 2) served through
   ``DNNModel`` over 16 rows in batches of 8: K5 launched 2 x 2 times, the
   output within 10's gates of plain attention's.
24. image_main: the north-star path, ``io.image.read_images`` ->
   ``ImageFeaturizer(batchSize=128, cutOutputLayers=1)`` over ResNet-50
   (the torchvision layout from a seeded state_dict through
   ``from_torch_resnet``) on 512 seeded 256x256 BMPs: images/s end to end,
   host prep against device time, peak memory, a traced batch's top device
   operations; gates (a) the card against the port on the CPU (bf16, and
   f32 with TF32 off), (b) fused bit for bit unfused, (c) logits and layer3
   taps, (d) save -> load bit for bit (``image_main``'s docstring);
25. resnet_train: ResNet-50 at batch 32 for 5 steps of ``run_train_loop``:
   BatchNorm's moving statistics move every step, step 1's loss and
   gradients against the CPU's in f32 (the gradients against their own
   sensitivity to a one-ulp input change), the loss finite;
26. moe_main: the sequence model of 10 with a switch-MoE FFN (8 experts,
   capacity factor 1.5) in every block: ``DNNModel`` over 256 rows (16 K5
   launches) and 10 train steps (40 each of K5, K6 and K7); card against
   CPU: the routing of the same MoE inputs, and the logits with the card's
   routing pinned (``PinnedRouting``); the loss falling; step 1's
   gradients through K5-K7 against exact attention's, no further than the
   plain version's (``F64_RATIO_MAX``), the routing pinned;
27. onnx_main: the ResNet-50 of 24 exported with ``onnx.export_onnx`` and
   imported back with ``onnx.import_onnx`` (a ``GraphModule`` on NCHW),
   ``ImageFeaturizer(batchSize=128, cutOutputLayers=1)`` over the same 512
   seeded BMPs on the card: every row within ``ONNX_COS_GAP`` (1 - cosine)
   of the native module's features, both f32; images/s, forward ms a batch,
   peak memory, export and import seconds;
28. onnx_multi_input: a BERT-base-shaped encoder (google-research/bert
   ``uncased_L-12_H-768_A-12``, 128 tokens) written as ONNX by
   ``bert_onnx`` from seeded weights, with two graph inputs fed through
   ``DNNModel.setFeedDict`` over 1,024 seeded sequences: the first 16
   against the port on the CPU within ``BERT_CPU_REL``; sequences/s, peak
   memory;
29. vw_main: 200,000 Criteo-shaped rows (``criteo_like``) through
   ``VowpalWabbitFeaturizer(numBits=18)`` and ``VowpalWabbitClassifier``
   (the native pass), transformed on the card, then an FTRL fit and an
   adaptive fit with ``MMLSPARK_TPU_NATIVE_VW=0``, each one pass of
   ``vw_scan`` (``csrc/vw_scan.cu``; launches counted from 0 around the
   two: exactly 2): vw_scan against its plain version on a 20,000-example
   prefix and the adaptive kernel fit against the native one within
   ``VW_RTOL``/``VW_ATOL``, two calls bit for bit, the transform within
   ``VW_PREDICT_REL`` of the host f64 dot.
29b. text_main, adult_main, word2vec_main (the featurize, stages and train
   layers): ``TextFeaturizer`` (2^18 features, IDF, stop words) fit and
   transform on 50,000 seeded book-review-shaped texts, every token hashed
   by the native ``murmur3_batch``, into ``LightGBMClassifier`` on the
   sparse column (31 leaves, 50 iterations, the sparse scan: K4) and a
   fused CSR transform of a 10,000-review holdout (K3) within 1e-6 of the
   unfused one, its first 3 trees refit on the card and the CPU over 5,000
   reviews the same; ``CleanMissingData`` -> ``TrainClassifier`` over
   32,561 Adult-shaped rows (string label, 8 string columns with None,
   100 iterations on the device route: K1, K2), the holdout scores within
   1e-5 of the host f64 traversal, ``ComputeModelStatistics`` and
   ``ComputePerInstanceStatistics`` on its 16,281-row holdout, a 3-tree
   refit's trees, scores and statistics the CPU's; ``Word2Vec``
   (vectorSize 100, window 3, 3 iterations, 4 negatives, batch 1,024) on
   5,000 reviews on the card twice bit for bit, its initial matrix the
   CPU's bit for bit, and on 500 reviews within ``W2V_VECTOR_TOL`` of the
   CPU's;
29c. automl_main, sar_main, lime_main (the AutoML, recommendation and
   LIME layers): ``TuneHyperparameters`` over ``LightGBMClassifier(
   numIterations=25)`` with numLeaves in {15, 31}, 3 folds, AUC, on
   adult_main's rows at parallelism 1 and 2 (K1, K2): bit for bit each
   other, every fit's launches counted once, a fold's first trees the
   CPU's, then ``FindBestModel`` on the holdout; SAR (jaccard, support 4,
   30-day decay) through ``RankingTrainValidationSplit`` on 10,000,054
   seeded MovieLens-10M-shaped ratings (69,878 users, 10,677 items), its
   co-occurrence against exact counts, its similarity bitwise a host
   recompute, its scores against a host f64 product, its top 10 by the tie
   rule, the TLC fixtures on the card, NDCG@10; ``TabularLIME`` over the
   tuned model (64 rows, 1,000 samples, one batched lasso) and
   ``ImageLIME`` over the ResNet-50 featurizer (4 images, 100 samples),
   the probes against the host traversal and the lassos against the CPU's
   (``automl_main``'s, ``sar_main``'s and ``lime_main``'s docstrings);
30. mesh_dense, mesh_sparse, mesh_vw: the data-parallel fits
   (``parallel/mesh.py``, ``parallel/launch.py``), their ranks spawned
   once from this process for the three phases (``mesh_phases``,
   ``mesh_rank``: fresh processes, a file rendezvous; the kernels are
   built here first, the ranks load them; the inputs the ranks
   memory-map as ``.npy``, written once here: the dense cell's matrix, the
   sparse cell's binned CSR, vw_main's featurized rows). With two cards or
   more: NCCL, one rank a card (at most ``MESH_MAX_CARDS``); on one card:
   NCCL with one rank and two ranks sharing ``cuda:0`` over gloo, asked
   for by name (``mesh_launches``), all at once, beside this process's
   single-card reference fits (``mesh_spawn``). mesh_dense: ``train(mesh=)`` on the
   dense cell, fused for 20 iterations (the sharded body under
   ``set_sync_debug_mode("error")`` on NCCL) and per-split for 3 trees,
   then here, alone on the card, the sharded fused fit on a one-rank NCCL
   group as the port grows it (no compaction under a mesh) and with each
   histogram's rows compacted first, timed (``mesh_compaction_ab``);
   mesh_sparse: ``train_sparse(mesh=)`` on the sparse cell, 2 iterations;
   mesh_vw: ``train_linear(mesh=)`` on vw_main's rows, adaptive and FTRL, 2
   passes. Gates: every rank's model byte for byte; the GBDT models byte
   for byte the single-card fits on the same routes (a difference prints
   where and how many cells); VW within ``VW_RTOL``/``VW_ATOL`` of one
   process averaging its per-block ``vw_scan`` passes the same way; K1, K4
   and vw_scan launched on each rank, K2 on the per-split route's (the
   sharded fused body compacts nothing, so its K2 and K1's device-count
   entry stay at 0); K1's f64 mask entry and K4's against their plain
   versions on each rank's own first-split inputs, and K1's f64
   device-count entry on the compacted fit's (``MESH_F64_REL``, and the
   f32 entry the f64 sums rounded once, bit for bit), held and timed here
   once every rank has finished, on the card alone. Each rank logs its fit seconds (the runs
   share the card with each other and with this process's fits), its
   collectives (calls, bytes, summed wall ms) and its launches. A rank that
   fails, exits nonzero or passes ``MESH_LAUNCH_TIMEOUT`` fails the run.
31. the DNN over a mesh (``dnn_mesh_refs``, ``dnn_mesh_start``,
   ``dnn_mesh_gates``): this process first makes the single-card
   references alone on the card, then one NCCL rank (every axis 1: NCCL's
   collectives run) and four gloo ranks sharing ``cuda:0`` (on four cards
   NCCL a card) run, beside the GBDT mesh phases' ranks, every phase in
   one start-up (``dnn_mesh_rank``), each on its own mesh of the same
   world. mesh_train: the train_transformer encoder (dim 512, depth 4, 8
   heads, seq 2048, 16-class per-token head, 8 rows a step) on fsdp 2 x
   tensor 2 for 3 steps: (a) in f32 (plain attention) loss, accuracy and
   every rank's blocks after each step against the single card's step at
   the reference's tolerances; (b) in bf16, K5/K6/K7 launched depth x steps
   times on [4, 2048, 4, 64] (4 heads a rank), the loss and each leaf's
   change within ``MESH_BF16_REL`` of the single card's; (c) K5, K6 and K7
   against their plain versions on the inputs a rank stashed, here alone on
   the card, timed beside the plain versions and the library call; (d) a
   repeated step the same bits. mesh_resnet: ResNet-50 at 224 px, 16 rows,
   2 steps, f32, each step from the single card's state before it, against
   its step at the reference's tolerances or ``MESH_ORDER_RATIO`` x the
   single card's own distance under a row permutation. mesh_ring: the
   encoder forward (2 rows) with ``ring_axis`` over seq 4, causal and not:
   output and input gradient against an f64 dense computation
   (``encoder_f64``), within ``F64_RATIO_MAX`` x the single card's f32
   dense errors. mesh_moe: moe_main's first MoE layer (8 experts, 2 a
   rank) on its tapped input, f32, ``MESH_MOE_ATOL``. mesh_pipe: 4 encoder
   blocks as 4 stages, 8 microbatches, ``MESH_PIPE_ATOL``. mesh_dnn_model:
   transformer_main's stage under a ``MeshContext`` of data 4 against its
   single-card output by transformer_main's gate, K5 16 times. Each rank
   logs its step seconds and collectives (``parallel.mesh.stats``).

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``, after a ``{"kernels": [...]}`` line that
lists K1-K7 (hist, select, csr_gather, sparse_hist, flash_attn,
flash_attn_bwd_dkv, flash_attn_bwd_dq; K6's and K7's main path is
train_transformer's 20 steps) and vw_scan (not a TPU kernel: the VW
learner's pass; its main path is vw_main's two scan fits, its ms, plain_ms
and bound on the 20,000-example prefix, with the 200,000-row pass's ms and
bound and the native pass's ms beside them), each with its launches on its
main path, error
against its plain version, ms, plain_ms, bound_ms, bound_by and library_ms, and
its launches on the new paths (``launches_on_new_paths``: dense_variants and
its GOSS scan, ranker_main, categorical_main, sparse_variants and its compacted
stream, sparse_wide, text_main (K3, K4), adult_main (K1, K2), automl_main
(K1, K2, both tuning runs' fits), serving_sparse,
serving_transformer, mega_sparse at K=8 and mega_transformer at K=4, through
the graph replays, serving_autotune,
train_transformer (K5) and its causal run (K5-K7), moe_main's transform (K5)
and training (K5-K7), and the mesh phases' runs, summed over their ranks);
K1's and K4's rows carry their f64 entries' checks, ms and bounds on a mesh
rank's inputs (``f64_entry``), K5's, K6's and K7's theirs on a tensor
rank's heads (``mesh_rank_inputs``), K4's row also its
call on the compacted stream (``compacted_stream``), and K6's and K7's their
design (``status``), TFLOP/s and the whole backward call's ms
(``bwd_total_ms``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_MAIN = 2_097_152
F_MAIN = 28
BINS_MAIN = 256
N_SCORE = 65_536
SEED = 20_240_601
# the reference's sparse benchmark point (tools/bench_gbdt_sparse.py)
N_SPARSE = 1_000_000
W_SPARSE = 1 << 18
NNZ_SPARSE = 50
ITERS_SPARSE = 10
DEVICE = "cuda"

# the reference's sequence benchmark model (tools/bench_seq.py:41) at its
# flash A/B length (bench_seq.py:94): 2048 tokens, so the flash gate is on
SEQ_LEN = 2048
SEQ_DIM = 512
SEQ_DEPTH = 4
SEQ_HEADS = 8
SEQ_VOCAB = 32_000
SEQ_ROWS = 256
SEQ_BATCH = 64

# K5 against its plain version, per element: |K5 - plain| in bf16 ulps of
# sum_j p_j |v_j|, the magnitude the output element is summed from (both
# round the probabilities to bf16, each in its own way, and then the output;
# where 1/sqrt(D) is not a power of 2 the plain version's bf16 scaling of k
# rounds too. A CPU emulation of K5's rounding steps reads 0.5-2.0, and
# 30-100 with one key tile skipped or not rescaled)
ULPS_MAX = 4.0
# K5's max and rms error against exact f64 attention, over the plain
# version's (and K6's and K7's, per gradient, against an f64 backward)
F64_RATIO_MAX = 1.5
# K5's row log-sum-exp against the plain version's (both f32; the kernel's
# exp2/log2 approximations and its summation order; 3e-6 read on the card)
LSE_TOL = 1e-4
# K5's time at the main-path batch over scaled_dot_product_attention's on
# the same inputs (a PyTorch call timed only as a yardstick): the Hopper
# design's target (an mma.sync kernel with synchronous tile loads read 2.71)
K5_LIBRARY_RATIO_MAX = 1.35
# K6 + K7 at the train shape over the backward of
# scaled_dot_product_attention on the same inputs (a PyTorch call timed only
# as a yardstick, which computes dQ with atomics in the same pass: K7
# recomputes S and dP instead, 7 products against 5). The Hopper design
# read 1.05-1.07 on the H100 (the mma.sync kernels before it 2.09)
BWD_LIBRARY_RATIO_MAX = 1.3
# the encoder's output against plain attention on the card and against the
# port on the CPU, per row and over all: a few times what the H100 shows
# (1 - cosine 6.4e-6, max |d| 0.0196, mean |d| 0.0026 against plain
# attention; the outputs are LayerNorm'd, of magnitude ~1)
COS_GAP_MAX = 3e-5
OUT_MAX_DIFF = 0.05
OUT_MEAN_DIFF = 0.005
# the tagger's forward on the card against the CPU's: the bound the CPU
# tests hold the port's deep bf16 paths to against the reference
# (tests/test_torch_fusion.py DEEP_BF16_TOL: one flip of a bf16
# intermediate of magnitude <= 4)
DEEP_BF16_TOL = 2e-2

# H100 SXM peaks (NVIDIA data sheet, spec; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# K3 timed at the fused executor's bucketed batch sizes, up to the whole
# scored partition (N_SCORE rows), and at these rows a warp beside its own
# geometry
GATHER_BATCHES = (256, 1024, 4096, 16_384, 65_536)
GATHER_SWEEP_ROWS = (1, 2, 4, 8, 16)


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
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


def queued_ms(torch, fn, iters: int = 200, warmup: int = 3):
    """Mean device time of ``fn`` with the host's cost of issuing it hidden:
    a spin kernel holds the stream while the host queues all ``iters``
    calls, so the events bracket only their device work. The spin grows
    until it outlasts the queueing (the start event must still be
    pending once every call is queued). None where this torch has no spin
    kernel."""
    spin = getattr(torch.cuda, "_sleep", None)
    if spin is None:
        return None
    for _ in range(warmup):
        fn()
    cycles = 1 << 24          # ~8 ms at the H100's boost clock
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("the spin kernel never outlasted the host's queueing")


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC with average ranks for tied scores."""
    uniq, inv, counts = np.unique(scores, return_inverse=True, return_counts=True)
    upper = np.cumsum(counts)
    ranks = (upper - (counts - 1) / 2.0)[inv]
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def higgs_like(n: int, seed: int):
    """Seeded synthetic stand-in for HIGGS (28 float features: 21 low-level
    kinematics — momenta, pseudorapidities, azimuths, b-tags — and 7 derived
    masses), binary label from a nonlinear signal. Values are f32-exact."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, F_MAIN), dtype=np.float32)
    for j in range(21):
        kind = j % 4
        if kind == 0:      # transverse momentum: positive, skewed
            X[:, j] = rng.lognormal(0.0, 0.5, n)
        elif kind == 1:    # pseudorapidity
            X[:, j] = rng.normal(0.0, 1.0, n)
        elif kind == 2:    # azimuth
            X[:, j] = rng.uniform(-np.pi, np.pi, n)
        else:              # b-tag: three levels
            X[:, j] = rng.choice(np.array([0.0, 1.1, 2.2], np.float32), n)
    for j in range(7):     # derived masses
        a, b = X[:, 4 * j % 21], X[:, (4 * j + 4) % 21]
        X[:, 21 + j] = np.sqrt(a * b * (1.0 + 0.5 * np.cos(X[:, (4 * j + 2) % 21]))
                               + rng.gamma(2.0, 0.1, n))
    z = (1.2 * (X[:, 21] - 1.0) - 0.8 * np.abs(X[:, 1]) + 0.6 * X[:, 0] * X[:, 3]
         + 0.5 * np.sin(X[:, 2]) * X[:, 24] + rng.logistic(0.0, 1.0, n))
    y = (z > np.median(z)).astype(np.float64)
    return X.astype(np.float64), y


def header(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log({"phase": "header", "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0),
         "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    from mmlspark_tpu_torch import _kernels

    from mmlspark_tpu_torch import native_loader

    t0 = time.perf_counter()
    native = native_loader.available()
    native_s = time.perf_counter() - t0
    secs = _kernels.build_all()
    log({"phase": "build", "seconds": secs, "kernels": _kernels.sources(),
         "build_dir": str(_kernels.build_dir()), "native_library": native,
         "native_build_seconds": native_s, "native_path": str(native_loader.so_path())})
    if not native:
        fail("the native library did not build or load (g++ is on this host: "
             "nvcc needs it)")
    for name, text in _kernels.build_logs.items():
        log({"phase": "build", "kernel": name,
             "ptxas": _kernels.ptxas_summary(text)})
    return {"smi": smi}


def hist_inputs(torch, n, f, b, density, gen):
    dev = torch.device("cuda")
    bins = torch.randint(0, b, (f, n), generator=gen, dtype=torch.int32)
    grad = torch.randn(n, generator=gen)
    hess = torch.rand(n, generator=gen)
    mask = torch.rand(n, generator=gen) < density
    return [t.to(dev) for t in (bins, grad, hess, mask)]


def check_hist(torch, hk, n, f, b, gen) -> float:
    """K1 vs its plain version: count exact, grad/hess within 1e-5 of the
    bin's sum of |v| + 1e-6. Returns the max abs error of grad/hess."""
    bins, grad, hess, mask = hist_inputs(torch, n, f, b, 0.5, gen)
    k = hk.histogram_cuda(bins, grad, hess, mask, b)
    p = hk.histogram_plain(bins, grad, hess, mask, b)
    scale = hk.histogram_plain(bins, grad.abs(), hess.abs(), mask, b)
    torch.cuda.synchronize()
    if not torch.equal(k[..., 2], p[..., 2]):
        fail(f"hist count channel differs at n={n} f={f} b={b}")
    err = (k[..., :2] - p[..., :2]).abs()
    tol = 1e-5 * scale[..., :2] + 1e-6
    if not bool((err <= tol).all()):
        fail(f"hist grad/hess beyond tolerance at n={n} f={f} b={b}: "
             f"max err {err.max().item()}")
    log({"phase": "kernels", "kernel": "hist", "n": n, "f": f, "bins": b,
         "count_exact": True, "max_abs_err": err.max().item()})
    return err.max().item()


def kernel_phase(torch) -> dict:
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.gbdt.tree import pick_tier, tier_caps

    gen = torch.Generator().manual_seed(SEED)
    out = {}

    # ----- K1
    err = check_hist(torch, hk, N_MAIN, F_MAIN, BINS_MAIN, gen)
    for n in (1, 1537):
        for b in (2, 17, 1024, 20000):
            check_hist(torch, hk, n, 65, b, gen)
    bins, grad, hess, mask = hist_inputs(torch, N_MAIN, F_MAIN, BINS_MAIN, 0.5, gen)
    n, f, b = N_MAIN, F_MAIN, BINS_MAIN
    m = mask.to(torch.float32)
    vals = torch.stack([grad * m, hess * m, m], dim=1)                  # [N, 3]
    flat_idx = ((bins.to(torch.int64) + torch.arange(f, device=bins.device)[:, None]
                 * b)[..., None] * 3 + torch.arange(3, device=bins.device)).reshape(-1)
    flat_vals = vals[None].expand(f, n, 3).reshape(-1)
    ms = time_ms(torch, lambda: hk.histogram_cuda(bins, grad, hess, mask, b))
    plain = time_ms(torch, lambda: hk.histogram_plain(bins, grad, hess, mask, b), 5)
    lib = time_ms(torch, lambda: torch.zeros(f * b * 3, device=bins.device)
                  .index_add_(0, flat_idx, flat_vals), 5)
    # the kernel's own device time: the host's cost of issuing it hidden
    device_ms = queued_ms(torch, lambda: hk.histogram_cuda(bins, grad, hess, mask, b))
    cnt = int(mask.sum())
    t_bound, by = bound_ms(cnt * f * 4 + n + cnt * 8 + f * b * 12, 3 * cnt * f)
    # memory moves 32-byte sectors of 8 rows: the sectors of bins that hold a
    # selected row, and grad/hess likewise
    sectors = (mask.view(-1, 8).any(dim=1).sum().item() * 32 * (f + 2)
               + n + f * b * 12)
    # the in-block f64 adds land in atomic order: two calls may differ in
    # the last bit of a cell at a rounding tie (logged, not gated)
    again = [hk.histogram_cuda(bins, grad, hess, mask, b) for _ in range(2)]
    del flat_idx, flat_vals
    out["hist"] = dict(name="hist", route="cuda",
                       source="mmlspark_tpu_torch/csrc/hist.cu",
                       replaces="mmlspark_tpu/gbdt/pallas_hist.py:65",
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
                       bound_by=by, library_ms=lib, device_only_ms=device_ms,
                       launches_per_call=hk.LAUNCHES_PER_CALL,
                       sector_floor_ms=sectors / HBM_BYTES_PER_S * 1e3,
                       bitwise_run_to_run=bool(torch.equal(*again)),
                       library_call="Tensor.index_add_ (one call, flat index "
                                    "and values prepared outside the timing)",
                       shape=dict(n=n, f=f, bins=b, selected=cnt))
    log(dict(phase="kernels", **out["hist"]))

    # ----- K2: bitwise, cap from the grower's tiers (full width when no
    # tier holds the rows)
    caps = tier_caps(N_MAIN, True)
    for density in (0.0, 0.3, 1.0):
        msk = (torch.rand(N_MAIN, generator=gen) < density).to(bins.device)
        count = int(msk.sum())
        tidx = pick_tier(caps, count)
        cap = caps[tidx - 1] if tidx else N_MAIN
        a = sk.select_rows_cuda(bins, grad, hess, msk, cap)
        p = sk.select_rows_plain(bins, grad, hess, msk, cap)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, p)):
            fail(f"select differs from its plain version at density {density}")
        log({"phase": "kernels", "kernel": "select", "density": density,
             "count": count, "cap": cap, "bitwise": True})
        if density == 0.3:
            sel = (msk, count, cap)
    msk, count, cap = sel
    ms = time_ms(torch, lambda: sk.select_rows_cuda(bins, grad, hess, msk, cap))
    plain = time_ms(torch, lambda: sk.select_rows_plain(bins, grad, hess, msk, cap), 5)

    def library():
        idx = torch.nonzero(msk).flatten()
        return (bins.index_select(1, idx), grad.index_select(0, idx),
                hess.index_select(0, idx))

    lib = time_ms(torch, library, 5)
    # the kernel's own device time: the host's cost of issuing it hidden
    device_ms = queued_ms(torch, lambda: sk.select_rows_cuda(bins, grad, hess, msk, cap))
    t_bound, by = bound_ms(N_MAIN + count * (F_MAIN + 2) * 4 + cap * (F_MAIN + 2) * 4, 0)
    out["select"] = dict(name="select", route="cuda",
                         source="mmlspark_tpu_torch/csrc/select.cu",
                         replaces="mmlspark_tpu/gbdt/pallas_select.py:52",
                         max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=t_bound,
                         bound_by=by, library_ms=lib, device_only_ms=device_ms,
                         launches_per_call=sk.LAUNCHES_PER_CALL,
                         ms_over_library=ms / lib,
                         library_call="torch.nonzero + 3x index_select",
                         shape=dict(n=N_MAIN, f=F_MAIN, selected=count, cap=cap))
    log(dict(phase="kernels", **out["select"]))
    return out


def first_diff(a, b):
    for fld in ("feature", "threshold_bin", "left", "right"):
        x, y = getattr(a, fld), getattr(b, fld)
        if len(x) != len(y):
            return {"field": fld, "nodes": [len(x), len(y)]}
        bad = np.nonzero(x != y)[0]
        if len(bad):
            i = int(bad[0])
            return {"field": fld, "node": i, "cuda": int(x[i]), "cpu": int(y[i])}
    return None


class Env:
    """Environment names set (or, with None, removed) for a block."""

    def __init__(self, **names):
        self.names = names

    def __enter__(self):
        import os

        self.prev = {k: os.environ.get(k) for k in self.names}
        for k, v in self.names.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the device route for fits small enough for the native engine (the card
# against the CPU refits, and the probes), and the routes' pins on the CPU
NATIVE_OFF = {"MMLSPARK_TPU_NATIVE_TRAIN": "0"}
CPU_SCAN = {"MMLSPARK_TPU_SCAN_TRAIN": "1"}
CPU_FUSED = {"MMLSPARK_TPU_FUSED_TREE": "1"}
PER_SPLIT = {"MMLSPARK_TPU_NO_SCAN_TRAIN": "1", "MMLSPARK_TPU_NO_FUSED_TREE": "1"}
FUSED_ONLY = {"MMLSPARK_TPU_NO_SCAN_TRAIN": "1"}


def zero_launches() -> None:
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk

    hk.launches = hk.count_launches = sk.launches = 0


def read_launches() -> dict:
    """K1's mask entry (``hist``), K1's device-count entry (``hist_count``)
    and K2 (``select``): the counters count graph replays too."""
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk

    return {"hist": hk.launches, "hist_count": hk.count_launches,
            "select": sk.launches}


def check_launches(launches: dict, what: str) -> None:
    if min(launches.values()) < 1:
        fail(f"{what}: a kernel of the path never launched: {launches}")


def check_route(booster, want: str, what: str) -> None:
    if booster.route != want:
        fail(f"{what}: the fit took the {booster.route!r} route, not {want!r}")


class Watch:
    """While active, the seconds, the arguments (``calls``: (args,
    kwargs)) and the return value of every call of ``module.name`` (a
    module's function, or a class's method)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.seconds, self.results, self.calls = [], [], []

    def __enter__(self):
        import inspect

        self.orig = getattr(self.module, self.name)
        self.saved = inspect.getattr_static(self.module, self.name)

        def watched(*a, **kw):
            t0 = time.perf_counter()
            res = self.orig(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            self.results.append(res)
            self.calls.append((a, kw))
            return res

        setattr(self.module, self.name, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def scan_main(torch, smi):
    """The dense main fit on its default route, ``scan``:
    ``LightGBMClassifier(numLeaves=31, maxBin=255, numIterations=20)`` on
    2,097,152 x 28 HIGGS-shaped rows, its boosting loop under
    ``torch.cuda.set_sync_debug_mode("error")`` (a synchronizing call in it
    raises), then ``.transform`` of N_SCORE rows. Gates: the route, K1's
    two entries and K2 launched (counted through the graph's replays), the
    scores against the host f64 traversal, the first 3 trees of a card scan
    at N_CUT rows against the CPU's forced scan on them (the same route:
    its f32 running score may part from the per-tree route in late trees),
    and K1 and K2 on the fit's own first-tree inputs (``hist_on_path``)."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    X, y = higgs_like(N_MAIN, SEED)
    df = DataFrame.from_dict({"features": X, "label": y})
    small = DataFrame.from_dict({"features": X[:N_SCORE], "label": y[:N_SCORE]})
    log({"phase": "data", "rows": N_MAIN, "features": F_MAIN,
         "seconds": time.perf_counter() - t0, "positives": float(y.mean())})
    est = LightGBMClassifier(numLeaves=31, maxBin=255, numIterations=20)

    zero_launches()
    native_before = native_loader.uses[("bin_matrix", "native")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bst.scan_loop_sync_mode = "error"
    t0 = time.perf_counter()
    try:
        with Watch(BinMapper, "transform_fm") as bins_w, \
                Watch(bst, "_train_scan") as loop_w, PathInputs() as inputs:
            model = est.fit(df)
            torch.cuda.synchronize()
    finally:
        bst.scan_loop_sync_mode = None
    fit_s = time.perf_counter() - t0
    guarded = bool(bst.last_scan_guarded)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    booster = model.booster
    t1 = time.perf_counter()
    scored = model.transform(small)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    log({"phase": "scan_main", "card": smi, "route": booster.route,
         "fit_seconds": fit_s, "fit_rows_per_s": N_MAIN / fit_s,
         "binning_seconds": sum(bins_w.seconds),
         "binning_native": native_loader.uses[("bin_matrix", "native")]
         > native_before,
         "loop_seconds": loop_w.results[0] if loop_w.results else None,
         "loop_sync_debug_mode": "error" if guarded else None,
         "launches": launches,
         "launches_per_tree": {k: v / 20 for k, v in launches.items()},
         "peak_device_gb": peak_gb, "transform_rows": N_SCORE,
         "transform_seconds": score_s, "trees": len(booster.trees)})
    check_route(booster, "scan", "scan_main")
    if not guarded:
        fail("scan_main: the boosting loop ran without the sync debug mode "
             "(another thread was working)")
    check_launches(launches, "scan_main")
    log({"phase": "scan_main", **check_dense_scores(scored, booster, X, y, "main"),
         "max_abs_diff_vs_host_f64_unrounded": float(np.abs(
             np.stack(list(scored.column("rawPrediction")))[:, 1]
             - booster.raw_predict(X[:N_SCORE])).max())})

    # the card's scan against the CPU's forced scan, on a cut
    cut = DataFrame.from_dict({"features": X[:N_CUT], "label": y[:N_CUT]})
    refit = {}
    for dev, env in ((DEVICE, NATIVE_OFF), ("cpu", CPU_SCAN)):
        with use_device(dev), Env(**env):
            t0 = time.perf_counter()
            refit[dev] = (LightGBMClassifier(numLeaves=31, maxBin=255,
                                             numIterations=ITERS_REFIT)
                          .fit(cut).booster, time.perf_counter() - t0)
    bc, bp = refit[DEVICE][0], refit["cpu"][0]
    diffs = [first_diff(bc.trees[i][0], bp.trees[i][0]) for i in range(ITERS_REFIT)]
    d3 = float(np.abs(bc.raw_predict(X[:N_SCORE]) - bp.raw_predict(X[:N_SCORE])).max())
    log({"phase": "scan_main", "refit_rows": N_CUT, "routes": [bc.route, bp.route],
         "cuda_fit_seconds": refit[DEVICE][1], "cpu_fit_seconds": refit["cpu"][1],
         "first_diff_per_tree": diffs, "max_abs_diff_3_trees": d3})
    if bc.route != "scan" or bp.route != "scan":
        fail(f"scan_main: the refits took {bc.route} and {bp.route}, not scan")
    if diffs[0] is not None:
        fail(f"scan_main: tree 1 differs between the card's and the CPU's scan: "
             f"{diffs[0]}")
    if d3 > 1e-3:
        fail(f"scan_main: 3-tree raw scores differ by {d3}")
    hist_on_path(torch, inputs, "main")
    del inputs
    return launches, model, X, y


class GrowWatch:
    """While active, every ``FusedGrower.grow`` call: its seconds (it ends
    in the tree's one read, so the work is done), its host reads and the
    synchronizing calls ``torch.cuda.set_sync_debug_mode("warn")`` reports
    in it, and whether it ran eagerly, captured a graph or replayed."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        import warnings

        from mmlspark_tpu_torch.gbdt import tree

        self.tree, self.orig = tree, tree.FusedGrower.grow
        watch = self

        def grow(grower, *a, **kw):
            run = grower.run
            kind = ("eager" if run.calls == 0 or not run.capture else
                    "replay" if run.graphs else "capture")
            reads = tree.host_reads
            prev = watch.torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                watch.torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    res = watch.orig(grower, *a, **kw)
                finally:
                    watch.torch.cuda.set_sync_debug_mode(prev)
            watch.calls.append({"kind": kind, "s": time.perf_counter() - t0,
                                "reads": tree.host_reads - reads,
                                "syncs": sum("ynchroniz" in str(w.message)
                                             for w in seen)})
            return res

        tree.FusedGrower.grow = grow
        return self

    def __exit__(self, *exc):
        self.tree.FusedGrower.grow = self.orig


# iterations of the fused_tree phase's two fits
ITERS_FUSED = 5


def tree_gate(fused, host, rtol_gain: float, rtol_sums: float):
    """The fused route's trees against the per-split route's: the same
    features, bins, children, counts and default directions, gains within
    ``rtol_gain`` and hessian sums within ``rtol_sums`` relative. Returns
    (first difference per tree, all gains and sums bit for bit, the largest
    relative gain difference)."""
    diffs, bitwise, worst = [], True, 0.0
    for i, (a, b) in enumerate(zip(fused.trees, host.trees)):
        a, b = a[0], b[0]
        d = first_diff(a, b)
        for fld in ("count", "default_left"):
            if d is None and not np.array_equal(getattr(a, fld), getattr(b, fld)):
                d = {"field": fld, "tree": i}
        for fld, rtol in (("gain", rtol_gain), ("weight", rtol_sums)):
            x, z = getattr(a, fld), getattr(b, fld)
            if x.shape != z.shape:
                continue                       # first_diff has it
            bitwise = bitwise and np.array_equal(x, z)
            if fld == "gain" and len(x):
                worst = max(worst, float((np.abs(x - z) / np.maximum(
                    np.abs(z), 1e-30)).max()))
            if d is None and not np.allclose(x, z, rtol=rtol, atol=0):
                d = {"field": fld, "tree": i,
                     "max_abs_diff": float(np.abs(x - z).max())}
        diffs.append(d)
    if len(fused.trees) != len(host.trees):
        diffs.append({"field": "trees",
                      "count": [len(fused.trees), len(host.trees)]})
    return diffs, bitwise, worst


def fused_tree_phase(torch, X, y, smi) -> dict:
    """The main path's data forced to the fused per-tree route
    (``MMLSPARK_TPU_NO_SCAN_TRAIN=1``) and to the per-split host route
    (also ``MMLSPARK_TPU_NO_FUSED_TREE=1``), ITERS_FUSED iterations each on
    the card: the same features, bins, counts, default directions and
    children, gains and hessian sums bit for bit (the gate: within 1e-6
    relative, bitwise logged); seconds a tree on each route,
    and on the fused route exactly one host read a tree (eager, capture and
    replay calls alike). Then the same on the first N_CUT rows, below
    ``select_kernel.MIN_ROWS``: there the per-split route sums a child of
    more than N_CUT/8 rows at full width, the fused route compacted, so the
    last f32 bit of such a histogram may differ (ROADMAP C): the gate is
    then that of the CPU tests against the reference's fused grower (gains
    1e-4, sums 1e-5 relative), bitwise logged. Returns the
    fused fit's launches at full size."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import tree

    est = LightGBMClassifier(numLeaves=31, maxBin=255, numIterations=ITERS_FUSED)
    result = None
    for rows, rtol_gain, rtol_sums in ((len(y), 1e-6, 1e-6),
                                       (N_CUT, 1e-4, 1e-5)):
        df = DataFrame.from_dict({"features": X[:rows], "label": y[:rows]})
        zero_launches()
        with Env(**FUSED_ONLY), GrowWatch(torch) as gw:
            t0 = time.perf_counter()
            fused = est.fit(df).booster
            torch.cuda.synchronize()
            fused_s = time.perf_counter() - t0
        launches = read_launches()
        reads = tree.host_reads
        with Env(**PER_SPLIT), Watch(bst, "grow_tree") as hw:
            t0 = time.perf_counter()
            host = est.fit(df).booster
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        host_reads = tree.host_reads - reads
        check_route(fused, "fused", "fused_tree")
        check_route(host, "host", "fused_tree")
        check_launches(launches, "fused_tree")
        diffs, bitwise, worst = tree_gate(fused, host, rtol_gain, rtol_sums)
        log({"phase": "fused_tree", "card": smi, "rows": rows,
             "trees": len(fused.trees),
             "routes": [fused.route, host.route], "fused_fit_seconds": fused_s,
             "per_split_fit_seconds": host_s,
             "fused_seconds_per_tree": [c["s"] for c in gw.calls],
             "fused_call_kinds": [c["kind"] for c in gw.calls],
             "fused_reads_per_tree": [c["reads"] for c in gw.calls],
             "fused_syncs_per_tree": [c["syncs"] for c in gw.calls],
             "per_split_seconds_per_tree": hw.seconds,
             "per_split_reads_per_tree": host_reads / max(len(host.trees), 1),
             "launches": launches, "first_diff_per_tree": diffs,
             "gate_rtol": {"gain": rtol_gain, "hessian_sums": rtol_sums},
             "gains_and_sums_bitwise": bitwise,
             "max_rel_gain_diff": worst})
        if any(d is not None for d in diffs):
            fail(f"fused_tree: at {rows} rows the fused grower's trees part "
                 f"from the per-split grower's: {diffs}")
        if any(c["reads"] != 1 for c in gw.calls):
            fail(f"fused_tree: reads per tree {[c['reads'] for c in gw.calls]}, not 1")
        result = launches if result is None else result
    return result


# rows of the native engine's main fit (200,000 x 28 x 20 = 4e6 <= 2e7: the
# default route is native)
N_NATIVE = 200_000


def native_main(torch, X, y, dense_model, smi) -> None:
    """The native engine (``native_loader``, the port's g++ build of its copy
    of the reference's C++ source): a N_NATIVE x 28, 20-iteration
    ``LightGBMClassifier`` fit that routes ``native`` by default, bit for
    bit the same fit run under ``use_device("cpu")``; on the main path's
    2,097,152 x 28 matrix, native binning (``bin_matrix``) bit for bit the
    port's numpy binning, and ``forest_predict_f64`` over the dense main
    model on N_SCORE rows bit for bit the numpy traversal
    (``MMLSPARK_TPU_NO_NATIVE_PREDICT=1``); each with both times."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier, predict_ensemble
    from mmlspark_tpu_torch.runtime import use_device

    if not native_loader.available():
        fail("native_main: the native library did not build or load")
    df = DataFrame.from_dict({"features": X[:N_NATIVE], "label": y[:N_NATIVE]})
    fits = {}
    for dev in (DEVICE, "cpu"):
        with use_device(dev):
            t0 = time.perf_counter()
            fits[dev] = (LightGBMClassifier(numLeaves=31, maxBin=255,
                                            numIterations=20).fit(df).booster,
                         time.perf_counter() - t0)
    bc, bp = fits[DEVICE][0], fits["cpu"][0]
    same_fit = bc.to_string() == bp.to_string()

    mapper = dense_model.booster.bin_mapper
    t0 = time.perf_counter()
    nat = mapper.transform_fm(X, dtype=np.uint8)
    native_bin_s = time.perf_counter() - t0
    saved = native_loader.bin_matrix, native_loader.bin_column
    native_loader.bin_matrix = native_loader.bin_column = lambda *a, **k: None
    try:
        t0 = time.perf_counter()
        ref = mapper.transform_fm(X, dtype=np.uint8)
        numpy_bin_s = time.perf_counter() - t0
    finally:
        native_loader.bin_matrix, native_loader.bin_column = saved
    bins_same = bool(np.array_equal(nat, ref))

    trees, Xs = dense_model.booster.trees, X[:N_SCORE]
    t0 = time.perf_counter()
    fast = predict_ensemble(trees, Xs, 1)
    native_pred_s = time.perf_counter() - t0
    with Env(MMLSPARK_TPU_NO_NATIVE_PREDICT="1"):
        t0 = time.perf_counter()
        slow = predict_ensemble(trees, Xs, 1)
        numpy_pred_s = time.perf_counter() - t0
    pred_same = bool(np.array_equal(fast, slow))
    log({"phase": "native_main", "card": smi, "rows": N_NATIVE, "iterations": 20,
         "routes": [bc.route, bp.route], "fit_seconds": fits[DEVICE][1],
         "cpu_fit_seconds": fits["cpu"][1], "fits_bitwise": same_fit,
         "binning_rows": len(X), "native_binning_seconds": native_bin_s,
         "numpy_binning_seconds": numpy_bin_s, "binning_bitwise": bins_same,
         "predict_rows": N_SCORE, "predict_trees": len(trees),
         "native_predict_seconds": native_pred_s,
         "numpy_predict_seconds": numpy_pred_s, "predict_bitwise": pred_same,
         "uses": {f"{k[0]}/{k[1]}": v for k, v in native_loader.uses.items()}})
    check_route(bc, "native", "native_main")
    check_route(bp, "native", "native_main (CPU)")
    if not (same_fit and bins_same and pred_same):
        fail(f"native_main: fit bitwise {same_fit}, binning {bins_same}, "
             f"predict {pred_same}")


# spin kernels that mark a traced window at each end
MARKS = 3
# the CUDA kernels of K1 (both entries) and K2, by name in a trace
K1_KERNELS = ("hist_block_kernel", "hist_reduce_kernel", "hist_count_kernel",
              "hist_count_reduce_kernel", "hist_global_kernel")
K2_KERNELS = ("select_count_kernel", "select_scatter_kernel")


def marked_trace(torch, fn, device_only: bool = True):
    """``fn()`` under ``core.profiling.trace``, between spin kernels that
    mark its window on the device's clock. Returns (fn's result,
    ``device_busy`` over that window, whether the markers were found, the
    K1 and K2 device ms in it)."""
    from mmlspark_tpu_torch.core import profiling

    spin = torch.cuda._sleep
    with profiling.trace(device_only=device_only) as prof:
        for _ in range(MARKS):
            spin(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        for _ in range(MARKS):
            spin(1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iv = profiling._device_intervals(prof)
    marks = sorted((s, e) for s, e, n in iv if "spin" in n)
    # the markers before and after fn, split at their widest gap, which
    # must span half of fn's wall time (a trace has dropped markers): else
    # the device span
    window = None
    if len(marks) >= 2:
        gap, at = max((b[0] - a[1], i) for i, (a, b) in
                      enumerate(zip(marks, marks[1:])))
        if gap > 1e6 * wall / 2:
            window = (marks[at][0], marks[-1][1])
    busy = profiling.device_busy(prof, window_us=window)
    lo, hi = window if window else (-np.inf, np.inf)
    k_ms = {k: sum(e - s for s, e, n in iv
                   if lo <= s <= hi and any(m in n for m in names)) / 1e3
            for k, names in (("K1", K1_KERNELS), ("K2", K2_KERNELS))}
    return res, busy, window is not None, k_ms


# the traced per-split fit's iterations: its trace's shares settle within a
# few trees, and the script keeps to its time (20 before the mesh phases)
PROFILE_PER_SPLIT_ITERS = 1


def profile_phase(torch, X, y, smi) -> None:
    """Traces (``core.profiling``, device activity) of the dense main fit on
    the per-split route (forced; ``PROFILE_PER_SPLIT_ITERS`` iterations) and
    on its default route (scan, 20): for each,
    the device's busy share of the fit's window (spin kernels mark it), the
    top device operations by time, the longest idle gaps, and K1's and
    K2's device ms. (The serving_sparse load is traced in its phase.)"""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier

    df = DataFrame.from_dict({"features": X, "label": y})
    for name, env, iters in (("per_split", PER_SPLIT, PROFILE_PER_SPLIT_ITERS),
                             ("scan", {}, 20)):
        with Env(**env):
            t0 = time.perf_counter()
            model, busy, marked, k_ms = marked_trace(torch, lambda: LightGBMClassifier(
                numLeaves=31, maxBin=255, numIterations=iters).fit(df))
            wall = time.perf_counter() - t0
        log({"phase": "profile", "card": smi, "fit": name, "route": model.booster.route,
             "iterations": iters, "wall_seconds_traced": wall,
             "window_marked": marked,
             "k1_device_ms": k_ms["K1"], "k2_device_ms": k_ms["K2"],
             "k1_share_of_window": (k_ms["K1"] / busy["window_ms"]
                                    if busy["window_ms"] else None),
             **busy})
        if not busy["device_events"]:
            fail(f"profile: the {name} fit's trace holds no device event")


class Timed:
    """While active, CUDA events around every call of ``module.name`` (two
    records a call, queued without a wait): the device time between them,
    summed, and the host's seconds in the calls. Calls made while a CUDA
    graph is captured are not timed, and a graph's replays make no call:
    on the scan and fused routes this times the eager calls only (the
    profile phase times the replays)."""

    def __init__(self, torch, module, name: str):
        self.torch, self.module, self.name = torch, module, name
        self.events, self.host_s = [], []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(*a, **kw):
            if self.torch.cuda.is_current_stream_capturing():
                return self.orig(*a, **kw)   # replays are not timed here
            ev = (self.torch.cuda.Event(enable_timing=True),
                  self.torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            ev[0].record()
            res = self.orig(*a, **kw)
            ev[1].record()
            self.host_s.append(time.perf_counter() - t0)
            self.events.append(ev)
            return res

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    @property
    def calls(self) -> int:
        return len(self.events)

    def per_call_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def device_ms(self) -> float:
        return float(sum(self.per_call_ms()))


def host_raw32(booster, X: np.ndarray) -> np.ndarray:
    """The host f64 traversal of the trees the model scores with (up to its
    best iteration), comparing features and thresholds as f32 values the
    way the device traversal does; base score included, class 0."""
    from mmlspark_tpu_torch.gbdt import predict_ensemble

    n_iter = booster.best_iteration if booster.best_iteration > 0 \
        else len(booster.trees)
    trees32 = [[t.__class__(**{**t.__dict__, "threshold": t.threshold.astype(
        np.float32).astype(np.float64)}) for t in g]
        for g in booster.trees[:n_iter]]
    X32 = X.astype(np.float32).astype(np.float64)
    return predict_ensemble(trees32, X32, 1)[:, 0] + booster.base_score[0]


def check_dense_scores(scored, booster, X, y, what: str) -> dict:
    """A binary classifier's transform of the first N_SCORE rows: shapes,
    finite, within 1e-5 of the host f64 traversal, train AUC >= 0.6."""
    raw = np.stack(list(scored.column("rawPrediction")))[:, 1]
    proba = np.stack(list(scored.column("probability")))
    if raw.shape != (N_SCORE,) or proba.shape != (N_SCORE, 2):
        fail(f"{what}: unexpected output shapes {raw.shape} {proba.shape}")
    if not (np.isfinite(raw).all() and np.isfinite(proba).all()):
        fail(f"{what}: non-finite scores")
    diff = float(np.abs(raw - host_raw32(booster, X[:N_SCORE])).max())
    train_auc = auc(raw, y[:N_SCORE])
    if diff > 1e-5:
        fail(f"{what}: device scores differ from the host f64 traversal "
             f"by {diff}")
    if train_auc < 0.6:
        fail(f"{what}: train AUC {train_auc} is not learning")
    return {"train_auc_65536": train_auc, "max_abs_diff_vs_host_f64": diff}


class PathInputs:
    """While active, keeps copies of the arguments of the grower's first
    histogram (the first tree's root: the fit's own binned [F, N] matrix,
    its gradients and its row mask), of its first K2 compaction (a small
    child's rows under that mask, and the tier's width) and, on the fused
    and scan routes, of K1's first device-count call (that compaction's
    buffers, the count on the device and the tier widths); or, given
    ``(module, name)`` targets, of the first call of each. Calls made while
    a CUDA graph is captured are skipped: the first calls are eager."""

    def __init__(self, *targets):
        self.args, self.targets = {}, targets

    def __enter__(self):
        from mmlspark_tpu_torch.gbdt import hist_kernel as hk
        from mmlspark_tpu_torch.gbdt import histogram as H
        from mmlspark_tpu_torch.gbdt import select_kernel as sk

        targets = self.targets or ((H, "compute_histogram"),
                                   (sk, "select_rows"),
                                   (hk, "histogram_count"))
        self.orig = [(mod, name, getattr(mod, name)) for mod, name in targets]
        for mod, name, fn in self.orig:
            setattr(mod, name, self._keep(name, fn))
        return self

    def _keep(self, name, fn):
        import torch

        def rec(*a, **kw):
            if name not in self.args and not (
                    torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                self.args[name] = tuple(x.clone() if hasattr(x, "clone")
                                        else x for x in a)
            return fn(*a, **kw)
        return rec

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def hist_on_path(torch, inputs: PathInputs, what: str) -> None:
    """K1 and K2 on a fit's own inputs (``PathInputs``): K1 on the root's
    binned matrix, gradients and row mask; K2 on the first compaction's
    inputs, bit for bit against its plain version; K1 on the compacted
    tier buffer. Each K1 call is checked against its plain version and
    timed."""
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk

    if "select_rows" not in inputs.args:
        fail(f"{what}: the fit made no K2 compaction")
        return
    bins, g, h, mask, b = inputs.args["compute_histogram"]
    f = bins.shape[0]
    s_bins, s_g, s_h, small, cap = inputs.args["select_rows"]
    count = int(small.sum())
    compacted = sk.select_rows_cuda(s_bins, s_g, s_h, small, cap)
    plain = sk.select_rows_plain(s_bins, s_g, s_h, small, cap)
    k2_bitwise = all(torch.equal(a, p) for a, p in zip(compacted, plain))
    if not k2_bitwise:
        fail(f"K2 on the {what} fit's small child differs from its plain "
             f"version")
    valid = torch.arange(cap, device=bins.device) < count
    out = {}
    for part, args, rows in (("root", (bins, g, h, mask), int(mask.sum())),
                             ("tier", (*compacted, valid), count)):
        k = hk.histogram_cuda(*args, b)
        p = hk.histogram_plain(*args, b)
        scale = hk.histogram_plain(args[0], args[1].abs(), args[2].abs(),
                                   args[3], b)
        err = (k[..., :2] - p[..., :2]).abs()
        if not torch.equal(k[..., 2], p[..., 2]) or \
                not bool((err <= 1e-5 * scale[..., :2] + 1e-6).all()):
            fail(f"K1 on the {what} fit's {part} data differs from its "
                 f"plain version: max err {err.max().item()}")
        width = args[0].shape[1]
        out[part] = {"rows": width, "selected": rows, "bins": b,
                     "ms": time_ms(torch, lambda: hk.histogram_cuda(*args, b)),
                     "device_only_ms": queued_ms(
                         torch, lambda: hk.histogram_cuda(*args, b), 50),
                     "bound_ms": bound_ms(rows * (f * 4 + 8) + width
                                          + f * b * 12, 0)[0],
                     "max_abs_err": err.max().item()}
    if "histogram_count" in inputs.args:
        out["device_count"] = check_count_entry(torch, inputs, what)
    log({"phase": "hist_on_path", "path": what, "features": f,
         "tier_cap": cap, "k2_bitwise": k2_bitwise, **out})


def check_count_entry(torch, inputs: PathInputs, what: str) -> dict:
    """K1's device-count entry on a fit's own first K2-compacted buffer and
    device-held count: against its plain version (count channel exact,
    grad/hess within 1e-5 of the bin's |v| sum + 1e-6), and bit for bit
    (logged) against the mask entry launched at the tier width the count
    picks (the per-split grower's launch); timed, with its bound."""
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt.tree import pick_tier

    bins, g, h, cnt, b, caps = inputs.args["histogram_count"]
    f, width = bins.shape
    count = int(cnt.reshape(()).item())
    valid = torch.arange(width, device=bins.device) < count
    k = hk.histogram_count_cuda(bins, g, h, cnt, b, caps)
    p = hk.histogram_count_plain(bins, g, h, cnt, b)
    scale = hk.histogram_plain(bins, g.abs(), h.abs(), valid, b)
    err = (k[..., :2] - p[..., :2]).abs()
    if not torch.equal(k[..., 2], p[..., 2]) or \
            not bool((err <= 1e-5 * scale[..., :2] + 1e-6).all()):
        fail(f"K1's device-count entry on the {what} fit's data differs from "
             f"its plain version: max err {err.max().item()}")
    tidx = pick_tier(caps, count)
    w = caps[tidx - 1] if tidx else width
    tier = hk.histogram_cuda(bins[:, :w].contiguous(), g[:w].contiguous(),
                             h[:w].contiguous(), valid[:w].contiguous(), b)
    # the library call: one index_add_ over the counted rows (flat index
    # and values prepared outside the timing), as kernel_phase times K1's
    vals = torch.stack([g[:count], h[:count], torch.ones_like(g[:count])], 1)
    flat_idx = ((bins[:, :count].to(torch.int64)
                 + torch.arange(f, device=bins.device)[:, None] * b)[..., None] * 3
                + torch.arange(3, device=bins.device)).reshape(-1)
    flat_vals = vals[None].expand(f, count, 3).reshape(-1)
    lib_ms = time_ms(torch, lambda: torch.zeros(f * b * 3, device=bins.device)
                     .index_add_(0, flat_idx, flat_vals), 5)
    del vals, flat_idx, flat_vals
    return {"rows": width, "selected": count, "tier_width": w,
            "library_ms": lib_ms,
            "bitwise_vs_tier_launch": bool(torch.equal(k, tier)),
            "ms": time_ms(torch, lambda: hk.histogram_count_cuda(
                bins, g, h, cnt, b, caps)),
            "device_only_ms": queued_ms(torch, lambda: hk.histogram_count_cuda(
                bins, g, h, cnt, b, caps), 50),
            "plain_ms": time_ms(torch, lambda: hk.histogram_count_plain(
                bins, g, h, cnt, b), 5),
            "bound_ms": bound_ms(count * (f * 4 + 8) + 4 + f * b * 12, 0)[0],
            "max_abs_err": err.max().item()}


# ---------------------------------------------------------------------------
# sparse (CSR) path
# ---------------------------------------------------------------------------


def make_csr_text(n_rows: int, width: int, avg_nnz: int, seed: int):
    """Seeded copy of the reference benchmark's text-shaped CSR
    (tools/bench_gbdt_sparse.py make_csr_text): ~avg_nnz token counts (1-4)
    per row, token ids skewed toward low ids (width * r^3), label from 8
    signal tokens plus noise."""
    rng = np.random.default_rng(seed)
    nnz_per_row = rng.poisson(avg_nnz, n_rows).clip(1)
    total = int(nnz_per_row.sum())
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    idx = (width * rng.random(total) ** 3).astype(np.int64).clip(0, width - 1)
    # sorted, distinct per row: np.unique's result, by a sort and a mask
    # (with np.unique here, numpy 2.3 on the H100's host, sparse_data's
    # generate_seconds read 104.25)
    key = np.sort(row_of * width + idx)
    key = key[np.concatenate(([True], key[1:] != key[:-1]))]
    row_of = key // width
    idx = key % width
    vals = 1.0 + rng.integers(0, 4, len(key)).astype(np.float64)
    indptr = np.searchsorted(row_of, np.arange(n_rows + 1))
    signal = (width * np.linspace(0.01, 0.6, 8) ** 3).astype(np.int64)
    sig_val = np.zeros(n_rows)
    for j, s in enumerate(signal):
        hit = idx == s       # at most one entry per row: bincount == add.at
        sig_val += np.bincount(row_of[hit], minlength=n_rows,
                               weights=(1.0 if j % 2 == 0 else -1.0) * vals[hit])
    y = (sig_val + rng.normal(0, 0.5, n_rows) > 0).astype(np.float64)
    return indptr, idx, vals, y


def sparse_data() -> dict:
    """The full-width sparse dataset as sparse rows (the stage fit's input)
    and the CSR arrays they were made from. The host build of the sparse
    path (``rows_to_csr``, ``SparseDataset.from_csr``, the bin-sorted
    layout) is timed inside the stage fit, once (``sparse_main_path``),
    which leaves its dataset and layout here for the later phases."""
    t0 = time.perf_counter()
    indptr, idx, vals, y = make_csr_text(N_SPARSE, W_SPARSE, NNZ_SPARSE, 0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = np.empty(N_SPARSE, dtype=object)
    for i in range(N_SPARSE):
        a, b = indptr[i], indptr[i + 1]
        rows[i] = {"indices": idx[a:b], "values": vals[a:b], "size": W_SPARSE}
    rows_s = time.perf_counter() - t0
    log({"phase": "sparse_data", "rows": N_SPARSE, "width": W_SPARSE,
         "nnz": int(len(idx)), "positives": float(y.mean()),
         "generate_seconds": gen_s, "row_dicts_seconds": rows_s})
    return {"rows": rows, "y": y, "csr": (indptr, idx, vals)}


def sparse_hist_inputs(torch, nnz, tb, empty_every, gen):
    """Bin-sorted entries over ``tb`` skewed bins (every ``empty_every``-th
    empty), stats masked at 50%, on the card."""
    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen)))
    weights = rng.random(tb) ** 4 + 1e-4
    if empty_every:
        weights[::empty_every] = 0.0
    ids = np.sort(rng.choice(tb, size=nnz, p=weights / weights.sum()))
    bin_end = np.searchsorted(ids, np.arange(tb), side="right").astype(np.int32)
    m = (rng.random(nnz) < 0.5).astype(np.float32)
    data = np.stack([rng.standard_normal(nnz) * m, (rng.random(nnz) + 0.1) * m, m])
    dev = torch.device(DEVICE)
    return (torch.from_numpy(data.astype(np.float32)).to(dev),
            torch.from_numpy(bin_end).to(dev))


def check_sparse_hist(torch, shk, data, bin_end, what) -> float:
    """K4 vs its plain version: count exact, grad/hess within 1e-5 of the
    bin's sum of |v| + 1e-6. Returns the max abs error of grad/hess."""
    k = shk.sparse_histogram_cuda(data, bin_end)
    p = shk.sparse_histogram_plain(data, bin_end)
    scale = shk.sparse_histogram_plain(data.abs(), bin_end)
    torch.cuda.synchronize()
    nnz, tb = data.shape[1], bin_end.shape[0]
    if tuple(k.shape) != (3, tb) or not torch.equal(k[2], p[2]):
        fail(f"sparse_hist count channel differs ({what}: nnz={nnz} tb={tb})")
    err = (k[:2] - p[:2]).abs()
    if not bool((err <= 1e-5 * scale[:2] + 1e-6).all()):
        fail(f"sparse_hist grad/hess beyond tolerance ({what}: nnz={nnz} "
             f"tb={tb}): max err {err.max().item()}")
    e = err.max().item() if err.numel() else 0.0
    log({"phase": "kernels", "kernel": "sparse_hist", "case": what, "nnz": nnz,
         "bins": tb, "count_exact": True, "max_abs_err": e})
    return e


def sparse_kernel_phase(torch, data: dict) -> dict:
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    gen = torch.Generator().manual_seed(SEED + 4)
    dev = torch.device(DEVICE)
    ds = data["ds"]
    n, tb = ds.num_rows, ds.total_bins
    rows_bs = torch.as_tensor(ds.row_of_nnz[data["order"]].astype(np.int64),
                              device=dev)
    bin_end = torch.as_tensor(data["bin_end"].astype(np.int32), device=dev)
    grad = torch.randn(n, generator=gen).to(dev)
    hess = torch.rand(n, generator=gen).to(dev)
    m = (torch.rand(n, generator=gen) < 0.5).to(dev)[rows_bs].to(torch.float32)
    stats = torch.stack([grad[rows_bs] * m, hess[rows_bs] * m, m]).contiguous()
    del rows_bs
    err = check_sparse_hist(torch, shk, stats, bin_end, "main")
    for nnz, tb_r, empty, what in ((0, 5, 0, "nnz 0"), (1, 1, 0, "nnz 1"),
                                   (1, 9, 0, "nnz 1, empty bins"),
                                   (300_001, 1, 0, "one bin"),
                                   (123_457, 7_777, 3, "empty bins, ragged tb"),
                                   (2_049, 4_001, 2, "more bins than entries")):
        check_sparse_hist(torch, shk, *sparse_hist_inputs(torch, nnz, tb_r, empty,
                                                          gen), what)
    nnz = stats.shape[1]
    # the design sums every bin in one fixed order: two calls agree bit for bit
    first, second = (shk.sparse_histogram_cuda(stats, bin_end) for _ in range(2))
    if not torch.equal(first, second):
        fail("two K4 calls on the main-path input differ")
    del first, second
    ids = shk.bin_ids(bin_end)
    ms = time_ms(torch, lambda: shk.sparse_histogram_cuda(stats, bin_end))
    device_ms = queued_ms(torch, lambda: shk.sparse_histogram_cuda(stats, bin_end), 50)
    plain = time_ms(torch, lambda: shk.sparse_histogram_plain(stats, bin_end), 5)
    lib = time_ms(torch, lambda: torch.zeros(3, tb, device=dev)
                  .index_add_(1, ids, stats), 5)
    t_bound, by = bound_ms(12 * nnz + 4 * tb + 12 * tb, 3 * nnz)
    row = dict(name="sparse_hist", route="cuda",
               source="mmlspark_tpu_torch/csrc/sparse_hist.cu",
               replaces="mmlspark_tpu/gbdt/pallas_sparse.py:269",
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
               bound_by=by, library_ms=lib, device_only_ms=device_ms,
               launches_per_call=shk.LAUNCHES_PER_CALL, bitwise_run_to_run=True,
               library_call="Tensor.index_add_ over the flat bin ids (f32, one "
                            "call, ids prepared outside the timing)",
               shape=dict(nnz=nnz, bins=tb, row_mask=0.5))
    log(dict(phase="kernels", **row))
    del stats, ids
    torch.cuda.empty_cache()
    return row


def root_split_check(torch, ds, y) -> dict:
    """The split search of the full-width dataset at iteration 0 with the
    reference's formula (f32 prefix over all flat bins) and the port's (f64
    segmented scan): the root's (bin, gain) both ways and the port's gain at
    the reference's bin, the error of the reference's left hessian sums over
    every bin, and the whole first tree grown with each. Recorded, not
    gated: a disagreement is the reference's fault."""
    from mmlspark_tpu_torch.gbdt import GrowerConfig, booster, sparse

    dev = torch.device(DEVICE)
    d = sparse.device_arrays(ds, dev)
    base = booster.init_score("binary", y)
    scores = torch.full((ds.num_rows,), float(base[0]), device=dev)
    labels = torch.as_tensor(y, dtype=torch.float32, device=dev)
    g, h = booster.grad_hess("binary", scores, labels)
    mask = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
    gb, hb = sparse._entry_gh(d, g, h)
    hist = sparse._zero_completed(d, sparse._flat_histogram(d, gb, hb, mask),
                                  sparse._masked_totals(g, h, mask))[None]
    split_surroundings(torch, d, gb, hb, ds.num_rows)
    args = (0.0, 0.0, 1e-3, 20)
    faithful = sparse._find_best_split_flat(d, hist, *args, faithful=True)[0]
    port = sparse._find_best_split_flat(d, hist, *args)[0]
    # within-feature left hessian sums of every flat bin, both ways
    h32 = hist[0]
    cs = sparse._prefix_sum(h32)[:, 1:]
    fs = d["feat_start_of_bin"]
    hl_f = (cs - (cs[:, fs] - h32[:, fs]))[1].double()
    hl_p = sparse._segmented_cumsum(d, h32.double())[1]
    hl_err = (hl_f - hl_p).abs()
    b_f = int(faithful[0])
    only = torch.zeros(ds.total_bins, dtype=torch.bool, device=dev)
    only[b_f] = True
    at_f = sparse._find_best_split_flat(d, hist, *args, bin_mask=only)[0]
    names = ("bin", "gain", "GL", "HL", "CL", "GR", "HR", "CR")
    out = {"faithful": dict(zip(names, faithful.tolist())),
           "port_f64": dict(zip(names, port.tolist())),
           "port_f64_at_faithful_bin": dict(zip(names, at_f.tolist())),
           "same_bin": b_f == int(port[0]),
           "left_hess_abs_err_max": hl_err.max().item(),
           "left_hess_abs_err_last_feature_bins": hl_err[-8:].tolist(),
           "bins_left_hess_err_over_1": int((hl_err > 1.0).sum())}
    # the whole first tree, grown once with each formula
    cfg = GrowerConfig(num_leaves=31, min_data_in_leaf=20)
    port_tree, port_rows = sparse.grow_tree_sparse(ds, d, g, h, cfg)
    exact = sparse._find_best_split_flat
    sparse._find_best_split_flat = functools.partial(exact, faithful=True)
    try:
        ref_tree, ref_rows = sparse.grow_tree_sparse(ds, d, g, h, cfg)
    finally:
        sparse._find_best_split_flat = exact

    def loss(rows) -> float:
        """sum over leaves of -G^2 / 2H, from f64 row sums (lower = better)"""
        gh = torch.zeros(2, 2 * cfg.num_leaves - 1, dtype=torch.float64, device=dev)
        gh.index_add_(1, rows.long(), torch.stack([g, h]).double())
        keep = gh[1] > 0
        return float((-0.5 * gh[0][keep] ** 2 / gh[1][keep]).sum())

    internal = port_tree.feature >= 0
    n_same = min(len(port_tree.feature), len(ref_tree.feature))
    diff = first_diff(ref_tree, port_tree)
    if diff and "cuda" in diff:
        diff["faithful"], diff["port_f64"] = diff.pop("cuda"), diff.pop("cpu")
    out["first_tree"] = {
        "first_diff": diff,
        "splits_with_other_feature_or_bin": int(
            ((port_tree.feature[:n_same] != ref_tree.feature[:n_same])
             | (port_tree.threshold_bin[:n_same]
                != ref_tree.threshold_bin[:n_same]))[internal[:n_same]].sum()),
        "splits": int(internal.sum()),
        "exact_loss_faithful": loss(ref_rows), "exact_loss_port_f64": loss(port_rows)}
    log(dict(phase="sparse_root_split", **out))
    return out


def split_surroundings(torch, d, gb, hb, n_rows: int) -> None:
    """Where a split's flat histogram spends its device time on the
    full-width dataset: the [nnz] gather of the node's row mask and the
    masked [3, nnz] stack that ``sparse._flat_histogram`` builds, beside K4
    on that stack, for a node holding half the rows."""
    from mmlspark_tpu_torch.gbdt import sparse
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    dev = gb.device
    gen = torch.Generator().manual_seed(SEED + 6)
    node = (torch.rand(n_rows, generator=gen) < 0.5).to(dev)
    rows = d["row_of_nnz_bs"]

    def stack():
        m = node.index_select(0, rows).to(torch.float32)
        return torch.stack([gb * m, hb * m, m])

    data = stack()
    nnz, tb = data.shape[1], d["bin_end"].shape[0]
    out = {"nnz": nnz, "bins": tb,
           "mask_gather_stack_ms": time_ms(torch, stack),
           "k4_ms": time_ms(torch, lambda: shk.sparse_histogram_cuda(
               data, d["bin_end"])),
           "flat_histogram_ms": time_ms(torch, lambda: sparse._flat_histogram(
               d, gb, hb, node)),
           # what a fused gather-and-stack must move: the row ids and the
           # node mask's gathered bytes, grad/hess in, the [3, nnz] stack out
           "mask_gather_stack_bound_ms": bound_ms(
               nnz * (rows.element_size() + 1 + 8 + 12), 0)[0]}
    log({"phase": "sparse_split", **out})


def sparse_main_path(torch, data: dict):
    """The sparse stage fit on its default route, ``scan`` (checked), its
    boosting loop under ``set_sync_debug_mode("error")`` and timed apart
    from the in-fit host build (``rows_to_csr``, ``from_csr``, the
    bin-sorted layout, each timed; the dataset and the layout kept in
    ``data`` for the later phases); K4 counted through the graph's
    replays; the transform against the CPU ``predict_csr``; the root split
    both ways (``root_split_check``)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import sparse
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    rows, y = data["rows"], data["y"]
    df = DataFrame.from_dict({"features": rows, "label": y})
    small = DataFrame.from_dict({"features": rows[:N_SCORE], "label": y[:N_SCORE]})
    est = LightGBMClassifier(numLeaves=31, numIterations=ITERS_SPARSE,
                             learningRate=0.1, minDataInLeaf=20)
    shk.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bst.scan_loop_sync_mode = "error"
    t0 = time.perf_counter()
    try:
        # the boosting loop's own seconds inside the fit: the rest is the
        # host build of the CSR dataset and its device layout
        with Watch(sparse, "_train_scan_sparse") as loop_w, \
                Watch(sparse, "rows_to_csr") as csr_w, \
                Watch(sparse.SparseDataset, "from_csr") as build_w, \
                Watch(sparse, "_bin_sorted_layout") as layout_w:
            model = est.fit(df)
            torch.cuda.synchronize()
    finally:
        bst.scan_loop_sync_mode = None
    fit_s = time.perf_counter() - t0
    loop_s = loop_w.results[0] if loop_w.results else None
    order, _, bin_end = layout_w.results[0]
    data.update(ds=build_w.results[0], order=order, bin_end=bin_end)
    log({"phase": "sparse_data", "total_bins": data["ds"].total_bins,
         "host_rows_to_csr_seconds": csr_w.seconds[0],
         "host_from_csr_seconds": build_w.seconds[0],
         "host_bin_sorted_layout_seconds": layout_w.seconds[0],
         "timed_inside": "the sparse stage fit"})
    t1 = time.perf_counter()
    scored = model.transform(small)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    launches = shk.launches
    nnz = int(len(data["csr"][1]))
    booster = model.booster
    log({"phase": "sparse_main", "route": booster.route,
         "fit_seconds": fit_s,
         "fit_rows_per_s": N_SPARSE * ITERS_SPARSE / fit_s,
         "fit_nnz_per_s": nnz * ITERS_SPARSE / fit_s,
         "boosting_loop_seconds": loop_s, "loop_sync_debug_mode": "error",
         "transform_rows": N_SCORE, "transform_seconds": score_s,
         "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": {"sparse_hist": launches}})
    check_route(booster, "scan", "sparse_main")
    if launches < 1:
        fail("K4 never launched on the sparse main path")

    raw = np.stack(list(scored.column("rawPrediction")))[:, 1]
    if raw.shape != (N_SCORE,) or not np.isfinite(raw).all():
        fail(f"sparse scores: shape {raw.shape} or non-finite values")
    indptr, idx, vals = data["csr"]
    cut = int(indptr[N_SCORE])
    cpu = sparse.predict_csr(booster.trees, indptr[:N_SCORE + 1], idx[:cut],
                             vals[:cut], 1, device="cpu")[:, 0] + booster.base_score[0]
    diff = float(np.abs(raw - cpu).max())
    full = sparse.predict_csr(booster.trees, indptr, idx, vals, 1)[:, 0] \
        + booster.base_score[0]
    acc = float(((full > 0) == (y > 0.5)).mean())
    leaves = [t.num_leaves for g in booster.trees for t in g]
    log({"phase": "sparse_main", "max_abs_diff_vs_cpu_predict_csr": diff,
         "train_accuracy": acc, "trees": len(booster.trees), "leaves": leaves,
         "boosting_loop_ms_per_split":
             loop_s * 1e3 / max(sum(leaves) - len(leaves), 1)
             if loop_s is not None else None})
    if diff > 1e-12:
        fail(f"sparse transform differs from the CPU predict_csr by {diff}")
    if acc <= 0.7:
        fail(f"sparse train accuracy {acc} is not above 0.7")
    root_split_check(torch, data["ds"], y)
    return launches, model


def sparse_anchor(torch):
    """The reference benchmark's anchor shape, 3 iterations on the card's
    scan and on the CPU's forced scan (the same route): the 3 trees
    identical in structure, 3-tree raw scores within 1e-3. Returns the
    card's booster and the anchor's CSR arrays."""
    from mmlspark_tpu_torch.gbdt import TrainParams, sparse

    indptr, idx, vals, y = make_csr_text(N_ANCHOR, W_ANCHOR, 50, 1)
    ds = sparse.SparseDataset.from_csr(indptr, idx, vals, W_ANCHOR)
    params = TrainParams(objective="binary", num_iterations=3, num_leaves=31,
                         learning_rate=0.1, min_data_in_leaf=20, seed=0)
    out = {}
    for dev, env in ((DEVICE, {}), ("cpu", CPU_SCAN)):
        t0 = time.perf_counter()
        with Env(**env):
            b = sparse.train_sparse(params, ds, y, device=dev)
        out[dev] = (b, time.perf_counter() - t0)
    (bc, cuda_s), (bp, cpu_s) = out[DEVICE], out["cpu"]
    diffs = [first_diff(bc.trees[i][0], bp.trees[i][0]) for i in range(3)]
    raw = [sparse.predict_csr(b.trees, indptr, idx, vals, 1, device="cpu")[:, 0]
           for b in (bc, bp)]
    d3 = float(np.abs(raw[0] - raw[1]).max())
    log({"phase": "sparse_anchor", "rows": N_ANCHOR, "width": W_ANCHOR,
         "nnz": int(len(idx)), "routes": [bc.route, bp.route],
         "cuda_fit_seconds": cuda_s, "cpu_fit_seconds": cpu_s,
         "first_diff_per_tree": diffs, "max_abs_diff_3_trees": d3})
    if bc.route != "scan" or bp.route != "scan":
        fail(f"anchor: the fits took {bc.route} and {bp.route}, not scan")
    bad = [(i + 1, d) for i, d in enumerate(diffs) if d is not None]
    if bad:
        fail(f"anchor tree {bad[0][0]} differs between the card's and the "
             f"CPU's scan: {bad[0][1]}")
    if d3 > 1e-3:
        fail(f"anchor 3-tree raw scores differ by {d3}")
    return bc, (indptr, idx, vals)


# ---------------------------------------------------------------------------
# K3 and the fused scoring pipeline
# ---------------------------------------------------------------------------


def fused_batches(model, rows):
    """The CSR batches ``PipelineModel([model]).fuse()`` stages for
    ``rows`` with the layout knob at "csr" (the executor's own prep and
    batching), as host arrays."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.fusion import SegmentExecutor, plan

    df = DataFrame.from_dict({"features": rows})
    ex = SegmentExecutor(plan([model], df.schema)[0], layout="csr")
    state = ex._prep_partition(dict(df.partitions[0]))
    if "features" not in state.get("csr", {}):
        fail("the executor did not stage the sparse rows as CSR")
    return state["csr"]["features"], list(ex._batches(state))


def gather_args(torch, arrays, used):
    dev = torch.device(DEVICE)
    return ([torch.as_tensor(arrays[f"features:{k}"]).to(dev)
             for k in ("indptr", "indices", "values")]
            + [int(arrays["features:width"]), used])


def check_gather(torch, gk, args, what) -> None:
    """K3 vs its plain version: bitwise (the f32 bits of every cell)."""
    k = gk.csr_gather_cuda(*args)
    p = gk.csr_gather_plain(*args)
    torch.cuda.synchronize()
    n, u = args[0].shape[0] - 1, args[4].shape[0]
    if tuple(k.shape) != (n, u) or not torch.equal(k.view(torch.int32),
                                                   p.view(torch.int32)):
        fail(f"csr_gather differs from its plain version ({what}: rows={n} "
             f"used={u})")
    log({"phase": "kernels", "kernel": "csr_gather", "case": what, "rows": n,
         "used": u, "nnz": int(args[0][-1]), "nnz_staged": args[1].shape[0],
         "bitwise": True})


def library_gather(torch, args):
    """One PyTorch sparse-tensor call computing the gather on the same
    batch (the first of these that runs here), for the library yardstick."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # sparse tensors: beta
        return _library_gather(torch, args)


def _library_gather(torch, args):
    indptr, indices, values, width, used = args
    n, nnz = indptr.shape[0] - 1, int(indptr[-1])
    csr = torch.sparse_csr_tensor(indptr.long(), indices[:nnz].long(),
                                  values[:nnz], size=(n, width))
    used64 = used.long()

    def one_hot():
        sel = torch.zeros(width, used.shape[0], device=used.device)
        sel[used64, torch.arange(used.shape[0], device=used.device)] = 1.0
        return sel

    # (name, inputs prepared outside the timing, the timed call)
    cands = [("sparse CSR index_select(1, used) + to_dense", lambda: csr,
              lambda x: x.index_select(1, used64).to_dense()),
             ("sparse COO index_select(1, used) + to_dense", csr.to_sparse_coo,
              lambda x: x.index_select(1, used64).to_dense()),
             ("torch.sparse.mm(CSR, dense one-hot [width, U])", one_hot,
              lambda x: torch.sparse.mm(csr, x))]
    tried = []
    for name, prep, call in cands:
        try:
            x = prep()
            out = call(x)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            tried.append(f"{name}: {str(e).splitlines()[0][:120]}")
            continue
        return name, functools.partial(call, x), out, tried
    return None, None, None, tried


def rows_prefix(indptr, indices, values, width, n):
    """The first ``n`` rows of a partition's CSR triple as one batch, nnz
    padded to a power of two as the executor pads a batch's."""
    from mmlspark_tpu_torch.parallel.batching import next_bucket, pad_batch

    nnz = int(indptr[n])
    pad = next_bucket(max(nnz, 1))
    return {"features:indptr": indptr[:n + 1], "features:width": width,
            "features:indices": pad_batch(indices[:nnz], pad),
            "features:values": pad_batch(values[:nnz], pad)}


def gather_bound(n_rows, nnz, n_used):
    """Bytes the gather must move: offsets, the batch's entries (index +
    value), the used ids, the [N, U] f32 output."""
    return bound_ms(4 * (n_rows + 1) + 8 * nnz + 4 * n_used
                    + 4 * n_rows * n_used, 0)


def gather_batch_sizes(torch, gk, triple, used) -> list:
    """K3 at the executor's bucketed batch sizes up to the whole partition,
    cut from the same rows: the wrapper's ms, device-only ms and the bytes
    bound at each, and the device-only ms at other rows a warp beside
    launch_geometry's choice."""
    out = []
    for n in GATHER_BATCHES:
        args = gather_args(torch, rows_prefix(*triple, n), used)
        check_gather(torch, gk, args, f"first {n:,} rows")
        nnz, u = int(args[0][-1]), used.shape[0]
        geo = gk.launch_geometry(n, u)
        sweep = {}
        orig = gk.launch_geometry
        try:
            for rpw in GATHER_SWEEP_ROWS:
                gk.launch_geometry = lambda n_, u_: (rpw, None, None)
                sweep[rpw] = queued_ms(torch, lambda: gk.csr_gather_cuda(*args),
                                       50)
        finally:
            gk.launch_geometry = orig
        row = dict(rows=n, nnz=nnz, nnz_staged=args[1].shape[0],
                   geometry=dict(zip(("rows_per_warp", "grid_x", "grid_y"),
                                     geo)),
                   ms=time_ms(torch, lambda: gk.csr_gather_cuda(*args), 50),
                   device_only_ms=queued_ms(
                       torch, lambda: gk.csr_gather_cuda(*args), 50),
                   bound_ms=gather_bound(n, nnz, u)[0],
                   device_only_ms_by_rows_per_warp=sweep)
        row["device_only_over_bound"] = row["device_only_ms"] / row["bound_ms"]
        log(dict(phase="kernels", kernel="csr_gather", case="batch size", **row))
        out.append(row)
    return out


def gather_kernel_phase(torch, model, rows) -> dict:
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk

    dev = torch.device(DEVICE)
    used_np = gk.used_features(model._ensemble())
    used = torch.as_tensor(used_np.astype(np.int32), device=dev)
    triple, batches = fused_batches(model, rows)
    indptr, width = triple[0], triple[3]
    main_args = gather_args(torch, batches[0].arrays, used)
    check_gather(torch, gk, main_args, "fused batch 0 (256 rows)")
    check_gather(torch, gk, gather_args(torch, batches[-1].arrays, used),
                 "fused batch 255")
    # all rows at once: the partition's whole triple, nnz padded as a
    # batch would be
    big_args = gather_args(torch, rows_prefix(*triple, len(indptr) - 1), used)
    check_gather(torch, gk, big_args, "65,536 rows at once")
    empty = {"indices": np.zeros(0, np.int64), "values": np.zeros(0), "size": width}
    holes = rows[:256].copy()
    holes[::3] = [empty] * len(holes[::3])
    rng = np.random.default_rng(SEED)
    # rows longer than a warp's window (STAGE_ENTRIES): 600-4,096 entries,
    # lengths a text row reaches, and a row of the 2^12-wide anchor can hold
    long_rows = rows[:256].copy()
    for i, k in ((0, 600), (7, 3000), (8, 1300), (255, 4096)):
        idx = np.sort(rng.choice(width, k, replace=False))
        long_rows[i] = {"indices": idx, "values": rng.integers(1, 5, k)
                        .astype(np.float64), "size": width}
    shuffled = torch.as_tensor(rng.permutation(np.concatenate(
        [used_np, used_np[::3], [width - 1, width, width + 5]])).astype(np.int32),
        device=dev)
    wide = torch.as_tensor(np.sort(rng.choice(width, 30_000, replace=False))
                           .astype(np.int32), device=dev)
    one_row = dict(batches[0].arrays)
    one_row["features:indptr"] = one_row["features:indptr"][:2]
    cases = [("empty rows", fused_batches(model, holes)[1][0].arrays, used),
             ("padded rows and nnz tail",
              fused_batches(model, rows[:1000])[1][-1].arrays, used),
             ("used ids past the width", batches[0].arrays,
              torch.cat([used, torch.tensor([width - 1, width, width + 5],
                                            dtype=torch.int32, device=dev)])),
             ("all-leaf forest (used = [0])", batches[0].arrays, used[:1] * 0),
             ("no entries", fused_batches(model, np.array(
                 [empty] * 256, dtype=object))[1][0].arrays, used),
             ("shuffled used with duplicates", batches[0].arrays, shuffled),
             ("rows longer than the window",
              fused_batches(model, long_rows)[1][0].arrays, used),
             ("30,000 used ids", batches[0].arrays, wide),
             ("one row", one_row, used)]
    for what, arrays, u in cases:
        check_gather(torch, gk, gather_args(torch, arrays, u), what)
    k1 = gk.csr_gather_cuda(*big_args)
    k2 = gk.csr_gather_cuda(*big_args)
    if not torch.equal(k1.view(torch.int32), k2.view(torch.int32)):
        fail("two K3 calls on the same 65,536 rows differ")

    b_nnz = int(main_args[0][-1])
    n_rows, n_used = main_args[0].shape[0] - 1, used.shape[0]
    ms = time_ms(torch, lambda: gk.csr_gather_cuda(*main_args), 200)
    plain = time_ms(torch, lambda: gk.csr_gather_plain(*main_args), 20)
    # the same launches with the wrapper's host cost hidden: the kernel's
    # own device time
    queued = queued_ms(torch, lambda: gk.csr_gather_cuda(*main_args))
    # the least any launch costs on this card and host: an empty kernel
    empty_launch = dict(ms=time_ms(torch, lambda: torch.cuda._sleep(1), 200),
                        device_only_ms=queued_ms(
                            torch, lambda: torch.cuda._sleep(1)))
    lib_name, lib_fn, lib_out, tried = library_gather(torch, main_args)
    lib = time_ms(torch, lib_fn, 20) if lib_fn is not None else None
    k = gk.csr_gather_cuda(*main_args)
    lib_equal = bool(torch.equal(lib_out, k)) if lib_out is not None else None
    t_bound, by = gather_bound(n_rows, b_nnz, n_used)
    sizes = gather_batch_sizes(torch, gk, triple, used)
    row = dict(name="csr_gather", route="cuda",
               source="mmlspark_tpu_torch/csrc/csr_gather.cu",
               replaces="mmlspark_tpu/gbdt/pallas_sparse.py:151",
               max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=t_bound,
               bound_by=by, library_ms=lib, device_only_ms=queued,
               empty_launch=empty_launch,
               geometry=gk.launch_geometry(n_rows, n_used),
               library_call=lib_name,
               library_equal=lib_equal, library_refused=tried,
               shape=dict(rows=n_rows, used=n_used, nnz=b_nnz,
                          nnz_staged=main_args[1].shape[0], width=width),
               all_rows=sizes[-1],
               batch_sizes={r["rows"]: {key: r[key] for key in (
                   "ms", "device_only_ms", "bound_ms")} for r in sizes})
    log(dict(phase="kernels", **{k_: v for k_, v in row.items()
                                 if k_ != "all_rows"}))
    return row


def _raw(df) -> np.ndarray:
    return np.stack(list(df.column("rawPrediction")))


def fused_sparse(torch, model, rows, smi) -> int:
    """The fused CSR scoring path over the sparse rows; returns K3's
    launches in it."""
    from mmlspark_tpu_torch.core import fusion
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk

    label = "LightGBMClassificationModel"
    df = DataFrame.from_dict({"features": rows})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = _raw(model.transform(df))
    unfused_s = time.perf_counter() - t0
    fused = PipelineModel([model]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    staging = [0.0]
    orig = fusion._csr_from_rows

    def timed_csr_from_rows(col, width):
        t = time.perf_counter()
        try:
            return orig(col, width)
        finally:
            staging[0] += time.perf_counter() - t

    fusion._csr_from_rows = timed_csr_from_rows
    try:
        gk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored = fused.transform(df)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        launches = gk.launches
    finally:
        fusion._csr_from_rows = orig
    st = fused.fusion_stats()
    seg = st["per_segment"].get(label, {})
    raw = _raw(scored)
    diff = float(np.abs(raw - unfused).max())
    variants = {}
    for vid in ("forest.gather", "forest.gemm", "forest.csr"):
        fused.set_tuning(kernel_variants={label: {"*": vid}})
        t0 = time.perf_counter()
        out = _raw(fused.transform(df))
        torch.cuda.synchronize()
        variants[vid] = {"seconds": time.perf_counter() - t0,
                         "bitwise_vs_first_run": bool(np.array_equal(out, raw))}
    log({"phase": "fused_sparse", "card": smi, "rows": len(rows),
         "fused_seconds": fused_s, "unfused_seconds": unfused_s,
         "host_csr_from_rows_seconds": staging[0],
         "host_csr_from_rows_share": staging[0] / fused_s,
         "k3_launches": launches, "max_abs_diff_vs_unfused": diff,
         "fallbacks": st["fallbacks"], "ring": seg,
         "compile_cache": st["compile_cache"],
         "segment_costs": st["segment_costs"], "variants": variants})
    if st["fallbacks"]:
        fail(f"fused sparse transform fell back: {st['fallbacks']}")
    if seg.get("csr_batches") != N_SCORE // 256 or "densifies" in seg:
        fail(f"expected {N_SCORE // 256} CSR batches and no densify, got {seg}")
    if launches != N_SCORE // 256:
        fail(f"K3 launched {launches} times in the fused sparse transform")
    if diff > 1e-6:
        fail(f"fused CSR scores differ from the unfused transform by {diff}")
    bad = [v for v, r in variants.items() if not r["bitwise_vs_first_run"]]
    if bad:
        fail(f"forest variants {bad} differ from forest.csr")
    return launches


def fused_dense(torch, model, X, smi) -> None:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel

    df = DataFrame.from_dict({"features": X})
    cols = ("rawPrediction", "probability", "prediction")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = model.transform(df)
    unfused_s = time.perf_counter() - t0
    fused = PipelineModel([model]).fuse()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused.transform(df)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    st = fused.fusion_stats()
    same = {c: bool(np.array_equal(np.stack(list(unfused.column(c))),
                                   np.stack(list(out.column(c))))) for c in cols}
    log({"phase": "fused_dense", "card": smi, "rows": len(X),
         "fused_seconds": fused_s, "unfused_seconds": unfused_s,
         "bitwise": same, "fallbacks": st["fallbacks"],
         "ring": st["per_segment"].get("LightGBMClassificationModel"),
         "compile_cache": st["compile_cache"]})
    if st["fallbacks"] or not all(same.values()):
        fail(f"fused dense scores are not the unfused ones bit for bit: {same}, "
             f"fallbacks {st['fallbacks']}")


def fused_anchor(torch, booster, csr, n: int = 8192) -> None:
    """At the anchor's 2^12 width, the CSR-staged fused output against the
    same rows sent as dense arrays (2^18 cannot be densified: 68 GB)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import LightGBMClassificationModel

    indptr, idx, vals = csr
    width = 1 << 12
    rows = np.empty(n, dtype=object)
    dense = np.zeros((n, width), dtype=np.float32)
    for i in range(n):
        a, b = indptr[i], indptr[i + 1]
        rows[i] = {"indices": idx[a:b], "values": vals[a:b], "size": width}
        dense[i, idx[a:b]] = vals[a:b]
    label = "LightGBMClassificationModel"
    fused = PipelineModel([LightGBMClassificationModel(booster=booster)]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    via_csr = fused.transform(DataFrame.from_dict({"features": rows}))
    seg = fused.fusion_stats()["per_segment"][label]
    via_dense = fused.transform(DataFrame.from_dict({"features": dense}))
    same = {c: bool(np.array_equal(np.stack(list(via_csr.column(c))),
                                   np.stack(list(via_dense.column(c)))))
            for c in ("rawPrediction", "probability", "prediction")}
    log({"phase": "fused_anchor", "rows": n, "width": width,
         "csr_batches": seg.get("csr_batches"), "bitwise": same})
    if seg.get("csr_batches") != n // 256 or not all(same.values()):
        fail(f"anchor: CSR-staged and dense fused outputs differ: {same}, {seg}")


# ---------------------------------------------------------------------------
# K5 and the transformer serving path
# ---------------------------------------------------------------------------


def attn_inputs(torch, b, t, h, d, gen):
    dev = torch.device(DEVICE)
    return [torch.randn(b, t, h, d, generator=gen).to(dev).to(torch.bfloat16)
            for _ in range(3)]


def attention_f64(torch, q, k, v, causal):
    """Exact attention in f64 from the same bf16 inputs, one batch row at a
    time (an independent formula: softmax of the scaled f64 scores)."""
    t, d = q.shape[1], q.shape[-1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1) \
        if causal else None
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for i in range(q.shape[0]):
        s = torch.einsum("qhd,khd->hqk", q[i].double(), k[i].double()) / d ** 0.5
        if mask is not None:
            s.masked_fill_(mask, float("-inf"))
        out[i] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                              v[i].double())
        del s
    return out


def bf16_ulps(torch, a, b, scale):
    """max over elements of |a - b| in bf16 ulps of ``scale``: 2^(e - 8)
    for a scale in [2^(e-1), 2^e)."""
    _, e = torch.frexp(scale.float())
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return ((a.float() - b.float()).abs() / ulp).max().item()


def sdpa_backend(torch, q, k, v, causal) -> str:
    """The backend PyTorch's dispatcher picks for
    ``scaled_dot_product_attention`` on these [B, H, T, D] inputs (its
    flash backend stops at head dim 256): logged beside every library time
    at D >= 384, where the yardstick is another kernel."""
    from torch.nn.attention import SDPBackend

    choice = getattr(torch, "_fused_sdp_choice", None)
    if choice is None:
        return "not reported"
    names = {int(m.value): n for n, m in SDPBackend.__members__.items()}
    return names.get(int(choice(q, k, v, is_causal=causal)), "not reported")


def k5_ptxas() -> dict:
    """K5's instantiations as ptxas reported them in this run's build:
    {(head dim or slice width, causal, sliced): {registers, spill_stores,
    spill_loads, notes}}; empty when the library came from an earlier
    build."""
    from mmlspark_tpu_torch import _kernels

    out = {}
    for row in _kernels.ptxas_summary(_kernels.build_logs.get("flash_attn", "")):
        m = re.search(r"flash_fwd_(sm90|sliced)ILi(\d+)ELb([01])E", row["function"] or "")
        if m:
            out[(int(m.group(2)), m.group(3) == "1", m.group(1) == "sliced")] = {
                "registers": row.get("registers"),
                "spill_stores": row.get("spill_stores"),
                "spill_loads": row.get("spill_loads"), "notes": row["warnings"]}
    return out


# K5 above the tuned head dims (the general path: D streamed in 64-column
# chunks, 128-column output slices): held to every correctness gate, timed
# beside the plain version and the library call, no speed gate
ATTN_WIDE_CASES = [(4, 1024, 8, 640, False), (4, 1024, 8, 640, True),
                   (2, 1024, 8, 768, False), (2, 1024, 8, 768, True),
                   (1, 1024, 8, 1024, False), (1, 1024, 8, 1024, True),
                   (1, 1024, 4, 2048, False)]


def attn_kernel_phase(torch) -> dict:
    """K5 against its plain version and both against an exact f64
    recomputation, in every case: the reference's A/B points, one main-path
    batch, head dims 128-512, one head, a sweep of short lengths that
    checks the gate's default (K5 faster than its plain version at every
    length the gate sends to it), and the general path above D = 512
    (``ATTN_WIDE_CASES``: the same correctness gates, no speed gate). Two
    calls give the same bits in every case; no K5 instantiation built in
    this run spills or has its wgmma pipeline serialised. Every case is
    logged before any check fails."""
    from mmlspark_tpu_torch.models import attention
    from mmlspark_tpu_torch.models import flash_kernel as fk

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(SEED + 5)
    cases = [(4, 2048, 8, 64, False), (4, 2048, 8, 64, True),
             (4, 8192, 8, 64, False), (4, 8192, 8, 64, True),
             (SEQ_BATCH, SEQ_LEN, SEQ_HEADS, SEQ_DIM // SEQ_HEADS, False),
             (4, 1024, 8, 128, False), (4, 1024, 8, 128, True),
             (4, 1024, 8, 256, False), (4, 1024, 8, 256, True),
             (4, 1024, 8, 384, False), (4, 1024, 8, 512, True),
             (1, 1024, 1, 64, False),
             # the gate's default: short lengths
             (4, 128, 8, 64, False), (4, 128, 8, 64, True),
             (4, 256, 8, 64, False), (4, 512, 8, 64, False),
             (1, 128, 1, 64, False)] + ATTN_WIDE_CASES
    min_t = attention.FLASH_MIN_T_DEFAULT
    main, rows, bad = None, [], []
    ptxas = k5_ptxas()
    for (width, causal, sliced), info in sorted(ptxas.items()):
        if info["spill_stores"] or info["spill_loads"] or any(
                "Performance Loss" in n for n in info["notes"]):
            bad.append(f"K5 {'sliced ' if sliced else ''}{width} causal={causal}: "
                       f"ptxas spills or serialises its wgmma ({info})")
    log({"phase": "attn_kernel", "ptxas": {
        f"{'sliced' if sl else 'd'}{w}{'_causal' if c else ''}": info
        for (w, c, sl), info in sorted(ptxas.items())}})
    for b, t, h, d, causal in cases:
        t_case = time.perf_counter()
        wide = d > fk.FWD_TUNED_MAX
        q, k, v = attn_inputs(torch, b, t, h, d, gen)
        o = fk.flash_attention_cuda(q, k, v, causal)
        again = fk.flash_attention_cuda(q, k, v, causal)
        o_lse, lse = fk.flash_attention_cuda(q, k, v, causal, lse=True)
        p, p_lse = fk.flash_attention_plain(q, k, v, causal, return_lse=True)
        exact = attention_f64(torch, q, k, v, causal)
        scale = attention_f64(torch, q, k, v.abs(), causal)
        torch.cuda.synchronize()
        row = {"phase": "attn_kernel", "b": b, "t": t, "h": h, "d": d,
               "causal": causal, "path": "sliced" if wide else "tuned",
               "bitwise_two_calls": bool(torch.equal(o, again)),
               "lse_output_bitwise": bool(torch.equal(o, o_lse)),
               "lse_max_abs_err_vs_plain": (lse - p_lse).abs().max().item(),
               "max_abs_err_vs_plain": (o.float() - p.float()).abs().max().item(),
               "max_ulps_vs_plain": bf16_ulps(torch, o, p, scale), "finite": bool(
                   torch.isfinite(o).all())}
        for name, x in (("k5", o), ("plain", p)):
            err = x.double() - exact
            row[f"{name}_err_vs_f64"] = err.abs().max().item()
            row[f"{name}_rms_vs_f64"] = err.square().mean().sqrt().item()
        del o, again, p, exact, scale, o_lse, lse, p_lse
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if d >= 384:
            row["library_backend"] = sdpa_backend(torch, qt, kt, vt, causal)
        long = t >= 8192 or b >= 64
        row["ms"] = time_ms(torch, lambda: fk.flash_attention_cuda(q, k, v, causal),
                            10 if long else 20)
        row["ms_with_lse"] = time_ms(torch, lambda: fk.flash_attention_cuda(
            q, k, v, causal, lse=True), 10 if long else 20)
        row["plain_ms"] = time_ms(torch, lambda: fk.flash_attention_plain(
            q, k, v, causal), 2 if long else 5, 1)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10 if long else 20)
        flops = 4 * b * h * t * t * d / (2 if causal else 1)
        row["bound_ms"], row["bound_by"] = bound_ms(4 * b * t * h * d * 2, flops,
                                                    BF16_OPS_PER_S)
        row["tflops"] = flops / row["ms"] / 1e9
        row["ms_over_library"] = row["ms"] / row["library_ms"]
        row["case_seconds"] = time.perf_counter() - t_case
        log(row)
        rows.append(row)
        if (b, t, causal) == (SEQ_BATCH, SEQ_LEN, False):
            main = row
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        # the gates, each set from the readings (see the constants)
        msgs = []
        if not row["bitwise_two_calls"]:
            msgs.append("two calls differ")
        if not row["lse_output_bitwise"] or row["lse_max_abs_err_vs_plain"] > LSE_TOL:
            msgs.append(f"K5 with lse: output bitwise {row['lse_output_bitwise']}, "
                        f"lse {row['lse_max_abs_err_vs_plain']} from the plain "
                        f"version's (bound {LSE_TOL})")
        if not row["finite"] or row["max_abs_err_vs_plain"] > 0.05:
            msgs.append(f"K5 differs from its plain version by "
                        f"{row['max_abs_err_vs_plain']} (reference bound 0.05)")
        if row["max_ulps_vs_plain"] > ULPS_MAX:
            msgs.append(f"K5 is {row['max_ulps_vs_plain']} bf16 ulps from its "
                        f"plain version (bound {ULPS_MAX})")
        for stat in ("err", "rms"):
            k5, plain = row[f"k5_{stat}_vs_f64"], row[f"plain_{stat}_vs_f64"]
            if k5 > F64_RATIO_MAX * plain:
                msgs.append(f"K5's {stat} against f64, {k5}, exceeds "
                            f"{F64_RATIO_MAX}x the plain version's {plain}")
        if not wide and t >= min_t and row["ms"] >= row["plain_ms"]:
            msgs.append(f"K5 ({row['ms']} ms) is not faster than its plain "
                        f"version ({row['plain_ms']} ms) at a length the "
                        f"gate sends to it (FLASH_MIN_T_DEFAULT={min_t})")
        bad += [f"{m} at b={b} t={t} h={h} d={d} causal={causal}" for m in msgs]
    bad += attn_big_batch(torch, fk, gen)
    log({"phase": "attn_kernel", "card_limits": {
        "max_ulps_vs_plain": max(r["max_ulps_vs_plain"] for r in rows),
        "max_f64_err_ratio": max(r["k5_err_vs_f64"] / r["plain_err_vs_f64"]
                                 for r in rows),
        "max_f64_rms_ratio": max(r["k5_rms_vs_f64"] / r["plain_rms_vs_f64"]
                                 for r in rows),
        "min_plain_over_k5_ms": min(r["plain_ms"] / r["ms"] for r in rows),
        "sliced_min_tflops": min(r["tflops"] for r in rows
                                 if r["path"] == "sliced")},
         "sliced_cases_seconds": sum(r["case_seconds"] for r in rows
                                     if r["path"] == "sliced")})
    log({"phase": "attn_kernel", "main_path_ms": main["ms"],
         "main_path_library_ms": main["library_ms"],
         "main_path_ms_over_library": main["ms_over_library"],
         "main_path_tflops": main["tflops"],
         "bound": f"<= {K5_LIBRARY_RATIO_MAX} x scaled_dot_product_attention"})
    if main["ms_over_library"] > K5_LIBRARY_RATIO_MAX:
        bad.append(f"K5 at the main-path batch takes {main['ms_over_library']:.3f}x "
                   f"the time of scaled_dot_product_attention (bound "
                   f"{K5_LIBRARY_RATIO_MAX})")
    if bad:
        fail("; ".join(bad))
    k5 = dict(name="flash_attn", route="cuda",
              source="mmlspark_tpu_torch/csrc/flash_attn.cu",
              replaces="mmlspark_tpu/models/attention.py:41",
              max_abs_err=main["max_abs_err_vs_plain"], ms=main["ms"],
              plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
              bound_by=main["bound_by"], library_ms=main["library_ms"],
              library_call="torch.nn.functional.scaled_dot_product_attention "
                           "on bf16 [B, H, T, D] (layout prepared outside "
                           "the timing)",
              shape=dict(b=SEQ_BATCH, t=SEQ_LEN, h=SEQ_HEADS,
                         d=SEQ_DIM // SEQ_HEADS, causal=False),
              bound_peak="989 TFLOP/s bf16 dense (spec), 3.35 TB/s",
              wide=[{key: r.get(key) for key in (
                  "b", "t", "h", "d", "causal", "ms", "tflops", "bound_ms",
                  "plain_ms", "library_ms", "library_backend",
                  "max_abs_err_vs_plain")} for r in rows if r["path"] == "sliced"])
    log(dict(phase="kernels", **k5))
    return k5


def attn_big_batch(torch, fk, gen) -> list:
    """K5 on a batch past grid.z's 65,535 cap (B=65,537, T=128, H=1, D=64),
    held on its first and last 64 rows against the plain version and exact
    f64 attention with the per-case gates; returns the failures."""
    b, t, h, d = 65_537, 128, 1, 64
    q, k, v = attn_inputs(torch, b, t, h, d, gen)
    o = fk.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    row = {"phase": "attn_kernel", "case": "batch past the grid.z cap", "b": b,
           "t": t, "h": h, "d": d, "finite": bool(torch.isfinite(o).all()),
           "ms": time_ms(torch, lambda: fk.flash_attention_cuda(q, k, v), 5)}
    bad = []
    for lo in (0, b - 64):
        sl = slice(lo, lo + 64)
        p = fk.flash_attention_plain(q[sl], k[sl], v[sl])
        scale = attention_f64(torch, q[sl], k[sl], v[sl].abs(), False)
        err = (o[sl].float() - p.float()).abs().max().item()
        ulps = bf16_ulps(torch, o[sl], p, scale)
        row[f"rows_{lo}_max_abs_err_vs_plain"] = err
        row[f"rows_{lo}_max_ulps_vs_plain"] = ulps
        if not row["finite"] or err > 0.05 or ulps > ULPS_MAX:
            bad.append(f"K5 at B={b} rows {lo}+64: {err} from its plain "
                       f"version, {ulps} ulps (bounds 0.05, {ULPS_MAX})")
    log(row)
    del q, k, v, o
    torch.cuda.empty_cache()
    return bad


def _emb(df) -> np.ndarray:
    return np.stack(list(df.column("emb")))


def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.reshape(len(a), -1).astype(np.float64)
    b = b.reshape(len(b), -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def transformer_main(torch, smi):
    """The main path: the reference's sequence-benchmark encoder served
    through ``DNNModel`` over 256 rows of 2048 token ids in 2 partitions
    (4 batches of 64). K5 must launch exactly depth x batches = 16 times;
    the output is held against plain attention on the card and, for the
    first 2 rows, against the port on the CPU (``COS_GAP_MAX``,
    ``OUT_MAX_DIFF``, ``OUT_MEAN_DIFF``)."""
    import os

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, transformer_encoder
    from mmlspark_tpu_torch.models import flash_kernel as fk
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    model = transformer_encoder(seq_len=SEQ_LEN, dim=SEQ_DIM, depth=SEQ_DEPTH,
                                num_heads=SEQ_HEADS, vocab_size=SEQ_VOCAB, seed=0)
    ids = np.random.default_rng(0).integers(0, SEQ_VOCAB, (SEQ_ROWS, SEQ_LEN))
    df = DataFrame.from_dict({"tokens": ids}, num_partitions=2)
    stage = DNNModel(inputCol="tokens", outputCol="emb", batchSize=SEQ_BATCH)
    stage.set_model(model)
    log({"phase": "transformer_main", "setup_seconds": time.perf_counter() - t0,
         "params": model.num_params(), "rows": SEQ_ROWS,
         "tokens": SEQ_ROWS * SEQ_LEN})
    fk.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = stage.transform(df)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fk.launches
    out = _emb(res)
    ring1 = stage.last_ingest_stats.summary()
    t0 = time.perf_counter()
    res = stage.transform(df)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    again = _emb(res)
    del res
    ring2 = stage.last_ingest_stats.summary()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log({"phase": "transformer_main", "card": smi, "first_transform_seconds": first_s,
         "second_transform_seconds": second_s,
         "tokens_per_s_second": SEQ_ROWS * SEQ_LEN / second_s,
         "k5_launches": launches, "peak_device_gb": peak_gb,
         "second_bitwise_first": bool(np.array_equal(out, again)),
         "readback_ms_per_batch_first": ring1.get("readback_ms_per_batch"),
         "readback_ms_per_batch_second": ring2.get("readback_ms_per_batch"),
         "ring_first": ring1, "ring_second": ring2})
    del again
    # where one batch's time goes, each part alone: the forward on the card
    # (CUDA events) and the readback of its [64, 2048, 512] f32 output
    x = torch.from_numpy(ids[:SEQ_BATCH]).to(DEVICE)
    params = model.device_params(x.device)
    forward_ms = time_ms(torch, lambda: model.apply(x, params=params), 3, 1)
    y = model.apply(x, params=params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y.cpu().numpy()
    readback_ms = (time.perf_counter() - t0) * 1e3
    log({"phase": "transformer_batch", "card": smi, "rows": SEQ_BATCH,
         "forward_ms": forward_ms, "readback_ms": readback_ms,
         "readback_gb_per_s": y.numel() * 4 / readback_ms / 1e6})
    del x, y
    if launches != SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH:
        fail(f"K5 launched {launches} times on the main path, expected "
             f"{SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH}")
    if out.shape != (SEQ_ROWS, SEQ_LEN, SEQ_DIM) or not np.isfinite(out).all():
        fail(f"transformer output: shape {out.shape} or non-finite values")

    os.environ["MMLSPARK_TPU_NO_FLASH"] = "1"
    try:
        t0 = time.perf_counter()
        plain = _emb(stage.transform(df))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        del os.environ["MMLSPARK_TPU_NO_FLASH"]
    cos = row_cosines(out, plain)
    diff = np.abs(out - plain)
    cpu_stage = DNNModel(inputCol="tokens", outputCol="emb", batchSize=2)
    cpu_stage.set_model(model)
    t0 = time.perf_counter()
    with use_device("cpu"):
        cpu = _emb(cpu_stage.transform(DataFrame.from_dict({"tokens": ids[:2]})))
    cpu_s = time.perf_counter() - t0
    cos_cpu = row_cosines(out[:2], cpu)
    diff_cpu = np.abs(out[:2] - cpu)
    log({"phase": "transformer_main", "no_flash_transform_seconds": plain_s,
         "cos_vs_plain_min": float(cos.min()), "max_abs_diff_vs_plain": float(diff.max()),
         "mean_abs_diff_vs_plain": float(diff.mean()), "cpu_seconds_2_rows": cpu_s,
         "cos_vs_cpu_min": float(cos_cpu.min()),
         "max_abs_diff_vs_cpu": float(diff_cpu.max()),
         "mean_abs_diff_vs_cpu": float(diff_cpu.mean())})
    for what, c, dd in (("plain attention on the card", cos, diff),
                        ("the port on the CPU", cos_cpu, diff_cpu)):
        if 1.0 - c.min() > COS_GAP_MAX or dd.max() > OUT_MAX_DIFF \
                or dd.mean() > OUT_MEAN_DIFF:
            fail(f"against {what}: 1 - cosine {1.0 - c.min()} (bound "
                 f"{COS_GAP_MAX}), max |d| {dd.max()} ({OUT_MAX_DIFF}), mean "
                 f"|d| {dd.mean()} ({OUT_MEAN_DIFF})")
    return launches, stage, df, out


def transformer_fused(torch, stage, df, unfused, smi) -> int:
    """``PipelineModel([dnn]).fuse()`` over the same rows, batch size 64:
    bitwise-equal to the unfused transform."""
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.models import flash_kernel as fk

    fused = PipelineModel([stage]).fuse()
    fk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fused.transform(df)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    out = _emb(res)
    del res
    launches = fk.launches
    st = fused.fusion_stats()
    same = bool(np.array_equal(out, unfused))
    log({"phase": "transformer_fused", "card": smi, "fused_seconds": fused_s,
         "k5_launches": launches, "bitwise_vs_unfused": same,
         "max_abs_diff_vs_unfused": float(np.abs(out - unfused).max()),
         "fusion_stats": st})
    if st["fallbacks"] or st["n_fused_segments"] != 1:
        fail(f"fused transformer: fallbacks {st['fallbacks']}, "
             f"{st['n_fused_segments']} fused segments")
    if launches != SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH:
        fail(f"K5 launched {launches} times in the fused transform, expected "
             f"{SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH}")
    if not same:
        fail("the fused transformer output is not the unfused one bit for bit")
    return launches


# ---------------------------------------------------------------------------
# the rest of the training surface: goss, dart, rf, LambdaRank, validation
# and early stopping, numBatches, dense and CSR
# ---------------------------------------------------------------------------


def refit_compare(torch, est_fn, df, n_trees: int, what: str,
                  route="fused"):
    """The same estimator on the card and on the CPU over ``df``, both on
    ``route`` (``fused`` or ``scan``: the card's default for the fit, the
    CPU pinned to it; the native engine off, as these cuts are small
    enough for it); returns the card's and the CPU's boosters, the first
    difference of each of the first ``n_trees`` trees and the seconds of
    each fit."""
    from mmlspark_tpu_torch.runtime import use_device

    out = {}
    pin = CPU_SCAN if route == "scan" else CPU_FUSED
    for dev, env in ((DEVICE, NATIVE_OFF), ("cpu", {**NATIVE_OFF, **pin})):
        with use_device(dev), Env(**env):
            t0 = time.perf_counter()
            out[dev] = (est_fn().fit(df).booster, time.perf_counter() - t0)
    (bc, cuda_s), (bp, cpu_s) = out[DEVICE], out["cpu"]
    check_route(bc, route, f"{what} refit")
    check_route(bp, route, f"{what} refit (CPU)")
    diffs = [first_diff(bc.trees[i][0], bp.trees[i][0])
             for i in range(min(n_trees, len(bc.trees), len(bp.trees)))]
    info = {"cuda_fit_seconds": cuda_s, "cpu_fit_seconds": cpu_s,
            "routes": [bc.route, bp.route], "first_diff_per_tree": diffs}
    if not diffs or diffs[0] is not None:
        fail(f"{what}: tree 1 differs between the card's and the CPU's fit: "
             f"{diffs[:1]}")
    return bc, bp, info


# dense variants on the main path's data (the reference's bench points:
# GOSS tools/bench_gbdt_train.py, rf tests/test_benchmarks.py)
DENSE_VARIANTS = {
    "goss": dict(boostingType="goss", topRate=0.2, otherRate=0.1),
    "dart": dict(boostingType="dart", dropRate=0.1, maxDrop=50),
    "rf": dict(boostingType="rf", baggingFraction=0.9, baggingFreq=1),
}
# the route each variant takes on the card by default: rf and goss (its
# selection made on the device) join the scan, dart (host-side drops) keeps
# the per-iteration loop over the fused grower
DENSE_VARIANT_ROUTES = {"goss": "scan", "dart": "fused", "rf": "scan"}
# DART's fit runs 10 iterations: its host traversals of the dropped trees
# grow with the forest (~40 s at 20), and the script keeps to its time;
# fewer would put 2,097,152 rows x iterations under the native engine's
# 2e7 and take the fit off the card
DENSE_VARIANT_ITERS = {"dart": 10}
# rows of the card-against-CPU refits of the new paths: a CPU refit of the
# full 2,097,152 rows costs minutes (262,144 until the script neared its
# time limit on a slow host)
N_CUT = 131_072
ITERS_REFIT = 3


def dense_variants(torch, X, y, smi) -> dict:
    """goss, dart and rf through ``LightGBMClassifier.fit`` at the main
    path's width (20 iterations, 31 leaves, 255 bins): fit seconds, K1 and
    K2 launches (counted through the scan's replays) and K1's device time
    outside graphs; the scan fits' loops under
    ``set_sync_debug_mode("error")``, GOSS's rows selected each iteration
    (exactly top_n + other_n); each model's transform against the host f64
    traversal and its train AUC, K1 and K2 on the fit's own first-tree
    inputs against their plain versions (``hist_on_path``: GOSS's selected
    rows and the bagging row masks included), GOSS's draws and top-k on the
    card bit for bit the CPU's on the fit's keys and gradients
    (``goss_device_parts``), and a refit of the first trees on the card and
    the CPU over the first N_CUT rows, on the same route. Returns each
    kernel's launches (and, under ``goss_scan``, the GOSS fit's)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    df = DataFrame.from_dict({"features": X, "label": y})
    small = DataFrame.from_dict({"features": X[:N_SCORE]})
    cut = DataFrame.from_dict({"features": X[:N_CUT], "label": y[:N_CUT]})
    base = dict(numLeaves=31, maxBin=255)
    launches = {"hist": 0, "hist_count": 0, "select": 0}
    for name, extra in DENSE_VARIANTS.items():
        zero_launches()
        torch.cuda.synchronize()
        bst.scan_loop_sync_mode = "error"
        t0 = time.perf_counter()
        try:
            with Timed(torch, hk, "histogram_cuda") as k1, \
                    Watch(bst, "_train_scan") as loop_w, PathInputs() as inputs:
                model = LightGBMClassifier(
                    numIterations=DENSE_VARIANT_ITERS.get(name, 20), **base,
                    **extra).fit(df)
                torch.cuda.synchronize()
        finally:
            bst.scan_loop_sync_mode = None
        fit_s = time.perf_counter() - t0
        got = read_launches()
        for k in launches:
            launches[k] += got[k]
        if name == "goss":
            goss_scan = dict(got)
        info = {"phase": "dense_variants", "variant": name, "card": smi,
                "rows": len(y), "route": model.booster.route,
                "fit_seconds": fit_s, "launches": got,
                "k1_device_ms_outside_graphs": k1.device_ms(),
                "k1_calls_outside_graphs": k1.calls,
                **check_dense_scores(model.transform(small), model.booster,
                                     X, y, name)}
        route = DENSE_VARIANT_ROUTES[name]
        if route == "scan":
            info.update(loop_seconds=loop_w.results[0] if loop_w.results
                        else None, loop_sync_debug_mode="error",
                        rows_grown_per_iteration=bst.last_scan_rows.tolist())
        log(info)
        check_route(model.booster, route, name)
        check_launches(got, name)
        hist_on_path(torch, inputs, name)
        del inputs
        if name == "goss":
            n = len(y)
            want = int(n * 0.2) + int(n * 0.1)
            if (bst.last_scan_rows != want).any():
                fail(f"goss: the scan selected {bst.last_scan_rows.tolist()} "
                     f"rows, not {want} each iteration")
            goss_device_parts(torch, model.booster, X, y)
        # the card against the CPU, on a cut, both on the variant's route
        # (GOSS and rf: the CPU's forced scan)
        bc, bp, ref = refit_compare(
            torch, lambda: LightGBMClassifier(numIterations=ITERS_REFIT,
                                              **base, **extra),
            cut, ITERS_REFIT, name, route=route)
        log({"phase": "dense_variants", "variant": name, "refit_rows": N_CUT,
             "trees_held": ITERS_REFIT, **ref})
        bad = [d for d in ref["first_diff_per_tree"] if d is not None]
        if bad:
            fail(f"{name}: the card's trees part from the CPU's: {bad[0]}")
    return dict(launches, goss_scan=goss_scan)


def goss_device_parts(torch, booster, X, y) -> None:
    """The GOSS scan's selection at the main path's width, on the fit's own
    keys (``split(prng_key(seed or bagging_seed), 20)``) and on the
    gradient at the fitted model's scores (its |g| has many distinct
    values; the first iteration's has two): every key's 2,097,152-row
    uniform draw and the two exact top-k selections of the last key, card
    against the port's CPU versions bit for bit, each timed on the card."""
    from mmlspark_tpu_torch.core import threefry
    from mmlspark_tpu_torch.gbdt import DeviceEnsemble
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt.sparse import _exact_topk_mask

    dev = torch.device(DEVICE)
    n = len(y)
    p = booster.params
    seed = p.seed or p.bagging_seed
    top_n, other_n = int(n * p.top_rate), int(n * p.other_rate)
    raw = DeviceEnsemble(booster.trees, 1, device=dev).predict_raw(X)[:, 0] \
        + booster.base_score[0]
    g, _ = bst.grad_hess("binary", torch.as_tensor(raw, dtype=torch.float32,
                                                   device=dev),
                         torch.as_tensor(y, dtype=torch.float32, device=dev))
    keys = threefry.split(threefry.prng_key(seed, dev), p.num_iterations)
    keys_cpu = threefry.split(threefry.prng_key(seed), p.num_iterations)
    same_keys = bool(torch.equal(keys.cpu(), keys_cpu))
    draws_equal = [bool(torch.equal(threefry.uniform(keys[j], n).cpu(),
                                    threefry.uniform(keys_cpu[j], n)))
                   for j in range(p.num_iterations)]
    u = threefry.uniform(keys[-1], n)
    top = _exact_topk_mask(g.abs(), top_n, n)
    other = _exact_topk_mask(u, other_n, n, exclude=top)
    g_cpu, u_cpu = g.cpu(), u.cpu()
    top_cpu = _exact_topk_mask(g_cpu.abs(), top_n, n)
    other_cpu = _exact_topk_mask(u_cpu, other_n, n, exclude=top_cpu)
    out = {"phase": "dense_variants", "goss_device_parts_rows": n,
           "distinct_abs_g": int(torch.unique(g.abs()).numel()),
           "keys_bitwise": same_keys, "draws_bitwise": draws_equal,
           "top_k_bitwise": bool(torch.equal(top.cpu(), top_cpu)),
           "other_k_bitwise": bool(torch.equal(other.cpu(), other_cpu)),
           "selected": [int(top.sum()), int(other.sum())],
           "uniform_draw_ms": time_ms(torch, lambda: threefry.uniform(keys[0], n),
                                      5),
           "top_k_ms": time_ms(torch, lambda: _exact_topk_mask(g.abs(), top_n, n),
                               5),
           "other_k_ms": time_ms(torch, lambda: _exact_topk_mask(
               u, other_n, n, exclude=top), 5)}
    log(out)
    if not (same_keys and all(draws_equal) and out["top_k_bitwise"]
            and out["other_k_bitwise"]):
        fail(f"goss: the card's draws or top-k differ from the CPU's: {out}")
    if out["selected"] != [top_n, other_n]:
        fail(f"goss: the top-k selected {out['selected']}, not "
             f"{[top_n, other_n]}")


def mslr_like(n: int, seed: int):
    """Seeded synthetic stand-in shaped like MSLR-WEB30K (Microsoft
    Research's learning-to-rank set; its Fold1 is the usual LightGBM
    lambdarank benchmark): 136 dense features (term counts, BM25/LMIR-like
    scores, quality scores, a few few-level ones), relevance 0-4 skewed to 0
    (about 51/33/13/2/1%), query sizes from 1 to 1,251 (lognormal, mean
    ~120), rows sorted by query. Returns (X [n, 136] f64, relevance, query
    ids)."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.lognormal(np.log(90.0), 0.8, n // 30 + 16)
                    .astype(np.int64), 1, 1251)
    cum = np.cumsum(sizes)
    m = int(np.searchsorted(cum, n)) + 1
    sizes = sizes[:m]
    sizes[-1] -= int(cum[m - 1]) - n
    qid = np.repeat(np.arange(m, dtype=np.int64), sizes)
    X = np.empty((F_RANK, n), dtype=np.float64)      # feature-major
    X[:25] = rng.poisson(rng.uniform(0.2, 6.0, (25, 1)), (25, n))
    X[25:50] = rng.lognormal(0.0, 0.8, (25, n))
    X[50:100] = rng.standard_normal((50, n), dtype=np.float32)
    X[100:130] = rng.random((30, n), dtype=np.float32)
    X[130:] = rng.integers(0, 21, (F_RANK - 130, n))
    qual = (0.6 * np.log1p(X[3]) + 0.5 * X[30] + 0.4 * X[55] - 0.3 * X[60]
            + 0.8 * X[105] + 0.05 * X[131]
            + rng.standard_normal(m)[qid] * 0.7 + rng.standard_normal(n))
    rel = np.searchsorted(np.quantile(qual, [0.514, 0.839, 0.973, 0.992]),
                          qual).astype(np.float64)
    return X.T, rel, qid


N_RANK = 2_097_152
F_RANK = 136
# rows of the ranker's card-against-CPU checks (whole queries)
N_RANK_CUT = 65_536
# the card's LambdaRank g and h against the CPU's on the same scores: the
# [m, G, G] pairwise sums reduce in another order on each device
LAMBDARANK_RTOL, LAMBDARANK_ATOL = 1e-5, 1e-6


class LogLines(logging.Handler):
    """Collects the fit's log lines (the stages log through
    ``logging.getLogger("mmlspark_tpu_torch.gbdt")`` at verbosity >= 0)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        lg = logging.getLogger("mmlspark_tpu_torch.gbdt")
        self.prev = lg.level
        lg.setLevel(logging.INFO)
        lg.addHandler(self)
        return self

    def __exit__(self, *exc):
        lg = logging.getLogger("mmlspark_tpu_torch.gbdt")
        lg.removeHandler(self)
        lg.setLevel(self.prev)


def ranker_main(torch, smi) -> tuple:
    """``LightGBMRanker`` on MSLR-WEB30K-shaped data (2,097,152 x 136, 10%
    of the queries flagged as validation rows, early stopping after 5
    rounds, 20 iterations, 31 leaves, 255 bins), then ``.transform`` and a
    fused transform of the first N_SCORE rows. Logs the fit's seconds, the
    LambdaRank gradient's seconds per iteration, the valid NDCG@10 per
    iteration and the best iteration, K1 and K2 launches and peak device
    memory. Gates: K1 (136 features: several feature groups) and K2 on the
    fit's own first-tree inputs against their plain versions
    (``hist_on_path``), the card's iteration-0 g and h against the CPU's,
    the first tree against a CPU refit (both on the first whole queries of
    N_RANK_CUT rows), the transform against the host traversal, and the
    fused transform bit for bit against the unfused one. Returns its
    launches and the paths of its rows saved for mesh_ranker."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import LightGBMRanker
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk

    t0 = time.perf_counter()
    X, rel, qid = mslr_like(N_RANK, SEED)
    n_q = int(qid[-1]) + 1
    is_val = (np.random.default_rng(SEED + 1).random(n_q) < 0.1)[qid]
    # mesh_ranker's inputs, memory-mapped by its ranks (X as f32: the ranks
    # and its single-card reference read the same values)
    saved = mesh_save("ranker", X=X.astype(np.float32), rel=rel, qid=qid,
                      is_val=is_val)
    df = DataFrame.from_dict({"features": X, "label": rel, "query": qid,
                              "isVal": is_val})
    sizes = np.bincount(qid)
    pairs = sum(m * gb * gb for gb, _, _, _, m in
                bst.segment_groups(qid[~is_val]).buckets if gb > 1)
    log({"phase": "ranker_main", "card": smi, "rows": N_RANK,
         "features": F_RANK, "queries": n_q, "valid_rows": int(is_val.sum()),
         "query_size_mean": float(sizes.mean()),
         "query_size_max": int(sizes.max()),
         "lambdarank_pair_elements_per_iteration": int(pairs),
         "relevance_shares": np.bincount(rel.astype(np.int64), minlength=5)
         .tolist(), "data_seconds": time.perf_counter() - t0})
    est = LightGBMRanker(groupCol="query", validationIndicatorCol="isVal",
                         earlyStoppingRound=5, numIterations=20, numLeaves=31,
                         maxBin=255, verbosity=0)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Timed(torch, bst, "grad_hess") as gh, LogLines() as lines, \
            PathInputs() as inputs:
        model = est.fit(df)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    booster = model.booster
    ndcg = [float(ln.split("=")[1]) for ln in lines.lines
            if "valid ndcg=" in ln]
    log({"phase": "ranker_main", "fit_seconds": fit_s, "launches": launches,
         "route": booster.route,
         "lambdarank_device_ms_per_iteration": gh.per_call_ms(),
         "lambdarank_host_seconds_per_iteration": gh.host_s,
         "valid_ndcg10_per_iteration": ndcg,
         "best_iteration": booster.best_iteration,
         "trees": len(booster.trees),
         "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9})
    check_route(booster, "fused", "ranker_main")
    check_launches(launches, "ranker_main")
    if len(ndcg) != len(booster.trees) or not all(0 < v <= 1 for v in ndcg):
        fail(f"valid NDCG per iteration is off: {ndcg}")
    hist_on_path(torch, inputs, "ranker")
    del inputs

    small = DataFrame.from_dict({"features": X[:N_SCORE]})
    t0 = time.perf_counter()
    unfused = np.asarray(model.transform(small).column("prediction"),
                         dtype=np.float64)
    score_s = time.perf_counter() - t0
    diff = float(np.abs(unfused - host_raw32(booster, X[:N_SCORE])).max())
    fused = PipelineModel([model]).fuse()
    out = np.asarray(fused.transform(small).column("prediction"),
                     dtype=np.float64)
    st = fused.fusion_stats()
    bitwise = bool(np.array_equal(out, unfused))
    log({"phase": "ranker_main", "transform_rows": N_SCORE,
         "transform_seconds": score_s, "max_abs_diff_vs_host_f64": diff,
         "fused_bitwise": bitwise, "fallbacks": st["fallbacks"]})
    if not np.isfinite(unfused).all() or diff > 1e-5:
        fail(f"ranker transform differs from the host traversal by {diff}")
    if st["fallbacks"] or not bitwise:
        fail(f"fused ranker scores are not the unfused ones bit for bit "
             f"(fallbacks {st['fallbacks']})")

    # the card against the CPU on the first whole queries of N_RANK_CUT rows
    n_cut = int(np.searchsorted(qid, qid[N_RANK_CUT]))
    gh_err = {}
    out = {}
    for dev in (DEVICE, "cpu"):
        seg = bst.segment_groups(qid[:n_cut], dev)
        g, h = bst.grad_hess("lambdarank", torch.zeros(n_cut, device=dev),
                             torch.as_tensor(rel[:n_cut], dtype=torch.float32,
                                             device=dev), group_segments=seg)
        out[dev] = (g.cpu().double().numpy(), h.cpu().double().numpy())
    for k, name in enumerate(("g", "h")):
        a, b = out[DEVICE][k], out["cpu"][k]
        err = np.abs(a - b)
        gh_err[name] = {"max_abs_err": float(err.max()),
                        "ok": bool((err <= LAMBDARANK_ATOL
                                    + LAMBDARANK_RTOL * np.abs(b)).all())}
    cut = DataFrame.from_dict({"features": X[:n_cut], "label": rel[:n_cut],
                               "query": qid[:n_cut]})
    _, _, ref = refit_compare(
        torch, lambda: LightGBMRanker(groupCol="query", numIterations=1,
                                      numLeaves=31, maxBin=255),
        cut, 1, "ranker")
    log({"phase": "ranker_main", "refit_rows": n_cut,
         "iteration0_grad_hess_vs_cpu": gh_err,
         "tolerance": {"rtol": LAMBDARANK_RTOL, "atol": LAMBDARANK_ATOL},
         **ref})
    if not all(v["ok"] for v in gh_err.values()):
        fail(f"the card's LambdaRank g/h differ from the CPU's: {gh_err}")
    return launches, saved


# the airline on-time benchmark's shape (szilard/benchm-ml: ASA Data Expo
# 2009 flights, dep_delayed_15min, run through LightGBM with its categorical
# features): six categorical columns with their cardinalities, DepTime
# (hhmm) and Distance (miles); Origin and Dest have more categories than
# maxBin=255 holds, so the binning keeps 254 of them (the lowest ids, here
# the most frequent) and bins the rest as missing
N_CAT = 2_097_152
N_CAT_HOLDOUT = 262_144
CAT_COLUMNS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
               ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
CAT_NUMERIC = ("DepTime", "Distance")
CAT_ITERS_CONTINUED = 10
CAT_CKPT_ITERS, CAT_CKPT_EVERY, CAT_CKPT_FAULT_AT = 9, 3, 6


def airline_like(n: int, seed: int):
    """Seeded rows shaped like the airline benchmark: categories as
    non-negative integer ids (Origin and Dest Zipf-skewed, as airports
    are), DepTime an hhmm integer, Distance integer miles. The label (about
    19% positive) has a seeded logit offset per category value, so it is
    not monotone in the ids and a set split is needed. Returns (X [n, 8]
    f64, y)."""
    rng = np.random.default_rng(seed)
    offsets = np.random.default_rng(seed ^ 0x5EED)
    X = np.empty((n, len(CAT_COLUMNS) + 2), dtype=np.float64)
    logit = np.full(n, -1.9)
    for j, (_, k) in enumerate(CAT_COLUMNS):
        if k >= 300:
            p = 1.0 / np.arange(1, k + 1) ** 0.9
            ids = rng.choice(k, size=n, p=p / p.sum())
        else:
            ids = rng.integers(0, k, n)
        X[:, j] = ids
        logit += offsets.normal(0.0, 0.45 if k < 300 else 0.6, k)[ids]
    minutes = np.clip(rng.normal(800, 280, n), 300, 1439).astype(np.int64)
    X[:, 6] = minutes // 60 * 100 + minutes % 60
    X[:, 7] = np.round(rng.lognormal(6.4, 0.6, n)).clip(30, 4983)
    logit += 0.0012 * (minutes - 800) + 0.0001 * (X[:, 7] - 700)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
    return X, y


def cat_trees_differ(a, b):
    """The first field where two trees part: structure, bins, set words
    and category sets equal, leaf values within rtol 1e-5
    (``refit_compare``'s rule), or None."""
    d = first_diff(a, b)
    if d is not None:
        return d
    if (a.cat_bin_words is None) != (b.cat_bin_words is None) or (
            a.cat_bin_words is not None
            and not np.array_equal(a.cat_bin_words, b.cat_bin_words)):
        return {"field": "cat_bin_words"}
    for i, (s, t) in enumerate(zip(a.cat_sets or [], b.cat_sets or [])):
        if (s is None) != (t is None) or (s is not None
                                          and not np.array_equal(s, t)):
            return {"field": "cat_sets", "node": i}
    if not np.allclose(a.value, b.value, rtol=1e-5, atol=0):
        return {"field": "value", "max_abs_diff": float(
            np.abs(a.value - b.value).max())}
    return None


def categorical_main(torch, dense_model, X_dense, smi) -> dict:
    """``LightGBMClassifier`` with six categorical slots on airline-shaped
    rows (N_CAT x 8, 20 iterations, 31 leaves, maxBin 255, catSmooth 10,
    catL2 10, maxCatThreshold 32), then the slice's own gates: (a) K1 and
    K2 on the fit's first-tree inputs; (b) a set split of >= 2 categories
    in the first tree; (c) the first 3 trees against a CPU refit on
    N_CUT rows; (d) the card's ``DeviceEnsemble`` against the host
    traversal; (e) the fused transform bit for bit; (f) LightGBM text out
    and back for this model and the dense main model, re-export stable;
    (g) stage save, load and transform bit for bit; (h) a ``modelString``
    continuation's first tree against the CPU's; (i) a checkpointed fit
    preempted and resumed against an uninterrupted one. Logs fit seconds,
    launches, K1's device time, holdout AUC against the same fit without
    categorical slots, transform seconds and peak memory. Returns K1's and
    K2's launches in the main fit."""
    import os
    import tempfile

    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel, PipelineStage
    from mmlspark_tpu_torch.gbdt import (DeviceEnsemble, LightGBMClassificationModel,
                                         LightGBMClassifier, booster as bst,
                                         predict_ensemble)
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import lgbm_format
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.gbdt.checkpoint import CheckpointConfig, load_checkpoint
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    X_all, y_all = airline_like(N_CAT + N_CAT_HOLDOUT, SEED + 9)
    X, y = X_all[:N_CAT], y_all[:N_CAT]
    Xh, yh = X_all[N_CAT:], y_all[N_CAT:]
    df = DataFrame.from_dict({"features": X, "label": y})
    cat_slots = list(range(len(CAT_COLUMNS)))
    base = dict(numLeaves=31, maxBin=255, catSmooth=10.0, catL2=10.0,
                maxCatThreshold=32)
    log({"phase": "categorical_main", "card": smi, "rows": N_CAT,
         "features": [c for c, _ in CAT_COLUMNS] + list(CAT_NUMERIC),
         "cardinalities": [k for _, k in CAT_COLUMNS],
         "positives": float(y.mean()), "data_seconds": time.perf_counter() - t0})

    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Timed(torch, hk, "histogram_cuda") as k1, PathInputs() as inputs:
        model = LightGBMClassifier(numIterations=20, categoricalSlotIndexes=cat_slots,
                                   **base).fit(df)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    booster = model.booster
    t0 = time.perf_counter()
    plain = LightGBMClassifier(numIterations=20, **base).fit(df)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    auc_cat = auc(booster.raw_predict(Xh), yh)
    auc_plain = auc(plain.booster.raw_predict(Xh), yh)
    t0_tree = booster.trees[0][0]
    set_sizes = [len(s) for s in (t0_tree.cat_sets or []) if s is not None]
    log({"phase": "categorical_main", "fit_seconds": fit_s,
         "fit_rows_per_s": N_CAT / fit_s, "launches": launches,
         "route": booster.route, "route_without_categorical_slots":
         plain.booster.route,
         "k1_device_ms_outside_graphs": k1.device_ms(),
         "k1_calls_outside_graphs": k1.calls,
         "peak_device_gb": peak_gb, "holdout_rows": N_CAT_HOLDOUT,
         "holdout_auc": auc_cat, "holdout_auc_without_categorical_slots": auc_plain,
         "fit_seconds_without_categorical_slots": plain_s,
         "first_tree_set_sizes": set_sizes,
         "set_nodes": sum(t.cat_sets is not None and sum(
             s is not None for s in t.cat_sets) for g in booster.trees for t in g)})
    check_route(booster, "scan", "categorical_main")
    check_launches(launches, "categorical_main")
    # (a) K1 and K2 on this fit's own first-tree inputs
    hist_on_path(torch, inputs, "categorical_main")
    del inputs
    # (b) a set split with >= 2 categories on the left in the first tree
    if not set_sizes or max(set_sizes) < 2:
        fail(f"the first categorical tree has no set split of >= 2 "
             f"categories: {set_sizes}")

    # (c) the card's first 3 trees against a CPU refit on a cut
    cut = DataFrame.from_dict({"features": X[:N_CUT], "label": y[:N_CUT]})
    fits = {}
    for dev, env in ((DEVICE, {}), ("cpu", CPU_SCAN)):
        with use_device(dev), Env(**env):
            t0 = time.perf_counter()
            fits[dev] = (LightGBMClassifier(numIterations=ITERS_REFIT,
                                            categoricalSlotIndexes=cat_slots,
                                            **base).fit(cut).booster,
                         time.perf_counter() - t0)
        check_route(fits[dev][0], "scan", f"categorical refit on {dev}")
    diffs = [cat_trees_differ(fits[DEVICE][0].trees[i][0], fits["cpu"][0].trees[i][0])
             for i in range(ITERS_REFIT)]
    log({"phase": "categorical_main", "refit_rows": N_CUT,
         "cuda_fit_seconds": fits[DEVICE][1], "cpu_fit_seconds": fits["cpu"][1],
         "first_diff_per_tree": diffs})
    if any(d is not None for d in diffs):
        fail(f"categorical: the card's first {ITERS_REFIT} trees part from "
             f"the CPU's: {diffs}")

    # (d) the card's traversal against the host f64 one; (e) fused = unfused
    Xs = X[:N_SCORE]
    ens = DeviceEnsemble(booster.trees, 1, device=DEVICE)
    dev_raw = ens.predict_raw(Xs.astype(np.float32))[:, 0]
    host_raw = predict_ensemble(booster.trees, Xs, 1)[:, 0]
    d_err = np.abs(dev_raw - host_raw)
    small = DataFrame.from_dict({"features": Xs})
    cols = ("rawPrediction", "probability", "prediction")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = model.transform(small)
    unfused_s = time.perf_counter() - t0
    fused = PipelineModel([model]).fuse()
    fused.transform(small)                       # plans and warms the program
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused.transform(small)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    st = fused.fusion_stats()
    same = {c: bool(np.array_equal(np.stack(list(unfused.column(c))),
                                   np.stack(list(out.column(c))))) for c in cols}
    log({"phase": "categorical_main", "transform_rows": N_SCORE,
         "gather_cat_table": list(ens.cat_vals.shape),
         "host_fallback": ens.cat_host_fallback,
         "device_vs_host_max_abs_err": float(d_err.max()),
         "unfused_seconds": unfused_s, "fused_seconds": fused_s,
         "fused_bitwise": same, "fallbacks": st["fallbacks"]})
    if ens.cat_host_fallback or not bool(
            (d_err <= 1e-5 + 1e-5 * np.abs(host_raw)).all()):
        fail(f"categorical: the card's traversal differs from the host's by "
             f"{float(d_err.max())} (host fallback {ens.cat_host_fallback})")
    if st["fallbacks"] or not all(same.values()):
        fail(f"categorical: fused scores are not the unfused ones: {same}, "
             f"fallbacks {st['fallbacks']}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cat_")
    # (f) LightGBM text out and back, for both models
    text_info = {}
    for name, m, Xq in (("categorical", model, Xs), ("dense_main", dense_model,
                                                     X_dense)):
        path = os.path.join(tmp, f"{name}.txt")
        m.save_native_model(path)
        loaded = LightGBMClassificationModel.load_native_model_from_file(
            path, featuresCol="features")
        want = m.booster.raw_predict(Xq)
        got = loaded.booster.raw_predict(Xq)
        q = DataFrame.from_dict({"features": Xq})
        card_want = np.stack(list(m.transform(q).column("rawPrediction")))[:, 1]
        card_got = np.stack(list(loaded.transform(q).column("rawPrediction")))[:, 1]
        t2 = lgbm_format.to_lightgbm_string(loaded.booster)
        t3 = lgbm_format.to_lightgbm_string(lgbm_format.from_lightgbm_string(t2))
        with open(path) as f:
            t1 = f.read()
        text_info[name] = {
            "bytes": len(t1), "max_abs_err_host": float(np.abs(got - want).max()),
            "host_bitwise": bool(np.array_equal(got, want)),
            "card_max_abs_err": float(np.abs(card_got - card_want).max()),
            "card_bitwise": bool(np.array_equal(card_got, card_want)),
            "reexport_identical": t3 == t2,
            "export_deterministic": lgbm_format.to_lightgbm_string(m.booster) == t1}
        if not np.allclose(got, want, rtol=1e-9, atol=1e-9):
            fail(f"{name}: the LightGBM text model scores "
                 f"{text_info[name]['max_abs_err_host']} off the model")
        if not np.allclose(card_got, card_want, rtol=1e-5, atol=1e-5):
            fail(f"{name}: the loaded text model's card scores are "
                 f"{text_info[name]['card_max_abs_err']} off")
        if t3 != t2 or not text_info[name]["export_deterministic"]:
            fail(f"{name}: re-exported LightGBM text is not byte-identical")
    # (g) stage save -> load -> transform on the card, bit for bit
    model.save(os.path.join(tmp, "stage"))
    again = PipelineStage.load(os.path.join(tmp, "stage")).transform(small)
    saved_same = {c: bool(np.array_equal(np.stack(list(unfused.column(c))),
                                         np.stack(list(again.column(c)))))
                  for c in cols}
    log({"phase": "categorical_main", "text_models": text_info,
         "stage_save_load_bitwise": saved_same})
    if not all(saved_same.values()):
        fail(f"categorical: a saved and loaded stage scores otherwise: "
             f"{saved_same}")

    # (h) a modelString continuation, card against CPU, on the cut
    with use_device(DEVICE):
        first = LightGBMClassifier(numIterations=CAT_ITERS_CONTINUED,
                                   categoricalSlotIndexes=cat_slots,
                                   **base).fit(cut)
    text = lgbm_format.to_lightgbm_string(first.booster)
    cont = {}
    for dev, env in ((DEVICE, {}), ("cpu", CPU_SCAN)):
        with use_device(dev), Env(**env):
            t0 = time.perf_counter()
            cont[dev] = (LightGBMClassifier(
                numIterations=CAT_ITERS_CONTINUED, modelString=text,
                categoricalSlotIndexes=cat_slots, **base).fit(cut).booster,
                time.perf_counter() - t0)
        check_route(cont[dev][0], "scan", f"categorical continuation on {dev}")
    k = CAT_ITERS_CONTINUED
    cdiff = cat_trees_differ(cont[DEVICE][0].trees[k][0], cont["cpu"][0].trees[k][0])
    log({"phase": "categorical_main", "continued_trees": len(cont[DEVICE][0].trees),
         "continued_cuda_seconds": cont[DEVICE][1],
         "continued_cpu_seconds": cont["cpu"][1],
         "first_continued_tree_diff": cdiff})
    if len(cont[DEVICE][0].trees) != 2 * k or cdiff is not None:
        fail(f"categorical: the modelString continuation parts from the "
             f"CPU's: {cdiff}")

    # (i) a checkpointed fit preempted and resumed, against an uninterrupted one
    params = bst.TrainParams(
        objective="binary", num_iterations=CAT_CKPT_ITERS, num_leaves=31,
        max_bin=255, bagging_fraction=0.8, bagging_freq=1, seed=7,
        categorical_feature=tuple(cat_slots))
    Xc, yc = X[:N_CUT], y[:N_CUT]
    t0 = time.perf_counter()
    full = bst.train(params, Xc, yc, device=DEVICE, checkpoint=CheckpointConfig(
        os.path.join(tmp, "full.ckpt"), every_k=CAT_CKPT_EVERY))
    full_s = time.perf_counter() - t0
    check_route(full, "fused", "categorical checkpointed fit")
    calls = [0]

    def preempt(point, **ctx):
        if point == faults.TRAIN_STEP:
            calls[0] += 1
            if calls[0] == CAT_CKPT_FAULT_AT:
                raise faults.InjectedFault("preempted")

    ckpt = os.path.join(tmp, "interrupted.ckpt")
    prev = faults.install(preempt)
    try:
        bst.train(params, Xc, yc, device=DEVICE, checkpoint=CheckpointConfig(
            ckpt, every_k=CAT_CKPT_EVERY))
        fail("the injected preemption did not stop the fit")
    except faults.InjectedFault:
        pass
    finally:
        faults.install(prev)
    at = load_checkpoint(ckpt)["iteration"]
    t0 = time.perf_counter()
    resumed = bst.train(params, Xc, yc, device=DEVICE, checkpoint=CheckpointConfig(
        ckpt, every_k=CAT_CKPT_EVERY))
    resume_s = time.perf_counter() - t0
    identical = resumed.to_string() == full.to_string()
    log({"phase": "categorical_main", "checkpoint_rows": N_CUT,
         "checkpoint_iterations": CAT_CKPT_ITERS, "checkpoint_every": CAT_CKPT_EVERY,
         "preempted_at_call": CAT_CKPT_FAULT_AT, "resumed_from": at,
         "uninterrupted_seconds": full_s, "resume_seconds": resume_s,
         "resumed_identical": identical})
    if at != 3 or not identical:
        fail(f"categorical: the resumed fit (from iteration {at}) is not the "
             f"uninterrupted one")
    return launches


SPARSE_VARIANTS = {
    "goss": dict(boosting_type="goss", top_rate=0.2, other_rate=0.1),
    "dart": dict(boosting_type="dart", drop_rate=0.1, max_drop=50),
}
# a second GOSS fit whose depth bound passes the reference's lazy-routing
# rule (0.3 * 30 + 8 < 0.9 * 30): per-split routing over the selected rows,
# one level-synchronous pass over every row a tree
SPARSE_GOSS_DEPTH = 8
# the route each sparse variant takes on the card: goss joins the scan,
# dart (host-side drops) keeps the per-iteration loop over the fused grower
SPARSE_VARIANT_ROUTES = {"goss": "scan", "goss_depth": "scan", "dart": "fused"}


class CompactedInputs:
    """While active, keeps a copy of the first K4 call on a stream of
    another width than the dataset's ``nnz`` entries (the scan's compacted
    stream, in its eager first iteration): the [3, width] stats and the
    remapped bin ends. It reads nothing on the host (the loop runs under
    the sync debug mode)."""

    def __init__(self, torch, shk, nnz: int):
        self.torch, self.shk, self.nnz, self.args = torch, shk, nnz, None

    def __enter__(self):
        self.orig = self.shk.sparse_histogram_cuda

        def rec(data, bin_end, **kw):
            if self.args is None and data.shape[1] != self.nnz and not \
                    self.torch.cuda.is_current_stream_capturing():
                self.args = (data.clone(), bin_end.clone())
            return self.orig(data, bin_end, **kw)

        self.shk.sparse_histogram_cuda = rec
        return self

    def __exit__(self, *exc):
        self.shk.sparse_histogram_cuda = self.orig


def compacted_k4(torch, shk, args, full_ms: float) -> dict:
    """K4 on a fit's own compacted stream (``CompactedInputs``) against its
    plain version (K4's gate), timed beside the full-width call of the
    kernel phase, with its bound for the valid entries."""
    data, bin_end = args
    width, tb = data.shape[1], bin_end.shape[0]
    valid = int(bin_end[-1])
    err = check_sparse_hist(torch, shk, data, bin_end, "compacted goss stream")
    ms = time_ms(torch, lambda: shk.sparse_histogram_cuda(data, bin_end))
    t_bound, by = bound_ms(12 * valid + 4 * tb + 12 * tb, 3 * valid)
    out = {"width": width, "valid_entries": valid, "bins": tb,
           "max_abs_err": err, "ms": ms,
           "device_only_ms": queued_ms(
               torch, lambda: shk.sparse_histogram_cuda(data, bin_end), 50),
           "plain_ms": time_ms(torch, lambda: shk.sparse_histogram_plain(
               data, bin_end), 5),
           "bound_ms": t_bound, "bound_by": by, "full_width_ms": full_ms,
           "ms_over_full_width": ms / full_ms}
    log({"phase": "sparse_variants", "k4_compacted": out})
    return out


def sparse_variants(torch, data: dict, smi, full_ms: float) -> tuple:
    """``train_sparse`` with goss (twice: unbounded, and at ``maxDepth`` 8
    for lazy routing) and dart (31 leaves, 10 iterations) on the full-width
    sparse dataset the main path built: the route (goss on the scan, its
    loop under ``set_sync_debug_mode("error")``; dart on the fused loop),
    loop seconds and K4 launches; for goss the compaction the reference's
    rule picks here (``compact_cap``, ``sel_cap``, the selected rows and
    entries each iteration, lazy routing in the depth-bounded fit), and K4
    on the fit's own compacted stream against its plain version; the
    card's ``predict_csr`` of each model against the CPU's on the first
    N_SCORE rows, and the train accuracy there. Returns K4's launches and
    the compacted call's row (None where the reference's rule kept the
    full stream)."""
    from mmlspark_tpu_torch.gbdt import TrainParams, sparse
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.obs.metrics import TrainRecorder, default_registry

    ds, y = data["ds"], data["y"]
    indptr, idx, vals = data["csr"]
    cut = int(indptr[N_SCORE])
    steps = default_registry().histogram(
        "mmlspark_train_step_seconds", labelnames=("engine",),
        buckets=TrainRecorder.STEP_BUCKETS).labels(engine="gbdt_sparse")
    launches = compacted_launches = 0
    compacted = None
    fits = dict(SPARSE_VARIANTS,
                goss_depth=dict(SPARSE_VARIANTS["goss"],
                                max_depth=SPARSE_GOSS_DEPTH))
    for name, kw in fits.items():
        params = TrainParams(objective="binary", num_iterations=ITERS_SPARSE,
                             num_leaves=31, learning_rate=0.1,
                             min_data_in_leaf=20, **kw)
        route = SPARSE_VARIANT_ROUTES[name]
        shk.launches = 0
        before = steps.value["sum"]
        sparse.last_scan_stats.clear()
        torch.cuda.synchronize()
        bst.scan_loop_sync_mode = "error"
        t0 = time.perf_counter()
        try:
            with Watch(sparse, "_train_scan_sparse") as loop_w, \
                    CompactedInputs(torch, shk, len(idx)) as cin:
                b = sparse.train_sparse(params, ds, y, device=DEVICE)
                torch.cuda.synchronize()
        finally:
            bst.scan_loop_sync_mode = None
        fit_s = time.perf_counter() - t0
        loop_s = (loop_w.results[0] if loop_w.results
                  else steps.value["sum"] - before)
        got = shk.launches
        launches += got
        q = (indptr[:N_SCORE + 1], idx[:cut], vals[:cut])
        card = sparse.predict_csr(b.trees, *q, 1, device=DEVICE)[:, 0]
        cpu = sparse.predict_csr(b.trees, *q, 1, device="cpu")[:, 0]
        diff = float(np.abs(card - cpu).max())
        acc = float(((card + b.base_score[0] > 0) == (y[:N_SCORE] > 0.5))
                    .mean())
        stats = {k: (v.tolist() if hasattr(v, "tolist") else v)
                 for k, v in sparse.last_scan_stats.items()}
        log({"phase": "sparse_variants", "variant": name, "card": smi,
             "route": b.route, "rows": ds.num_rows, "width": ds.num_features,
             "nnz": int(len(idx)), "train_sparse_seconds": fit_s,
             "loop_seconds": loop_s,
             "loop_sync_debug_mode": "error" if route == "scan" else None,
             "scan_selection": stats,
             "launches": {"sparse_hist": got},
             "trees": len(b.trees),
             "leaves": [t.num_leaves for g in b.trees for t in g],
             "max_abs_diff_card_vs_cpu_predict_csr": diff,
             "train_accuracy_65536": acc})
        check_route(b, route, f"sparse {name}")
        if got < 1:
            fail(f"sparse {name}: K4 never launched")
        if diff > 1e-12 or not np.isfinite(card).all():
            fail(f"sparse {name}: the card's predict_csr differs from the "
                 f"CPU's by {diff}")
        if acc <= 0.7:
            fail(f"sparse {name}: train accuracy {acc} is not above 0.7")
        if route == "scan":
            n = ds.num_rows
            want = int(n * 0.2) + int(n * 0.1)
            if any(r != want for r in stats["rows"]):
                fail(f"sparse {name}: the scan selected {stats['rows']} rows, "
                     f"not {want}")
            if not stats["compact_cap"]:
                # the reference's rule (cap > 0.75 nnz) turned it off here:
                # logged, and the anchor refits still force it
                log({"phase": "sparse_variants", "variant": name,
                     "compaction": "off by the reference's rule"})
            else:
                compacted_launches += got
                if name == "goss" and cin.args is not None:
                    compacted = compacted_k4(torch, shk, cin.args, full_ms)
            if name == "goss_depth" and stats["compact_cap"] \
                    and not stats["lazy"]:
                fail("sparse goss_depth: lazy routing was not taken")
        del cin
    return {"sparse_hist": launches,
            "compacted_stream": compacted_launches}, compacted


# the reference benchmark's anchor shape (tools/bench_gbdt_sparse.py)
N_ANCHOR, W_ANCHOR = 100_000, 1 << 12


def anchor_variants(torch, smi, full_ms: float):
    """At the reference benchmark's anchor shape (100,000 x 2^12), the
    card against the CPU on the same route: goss through ``train_sparse``
    on the scan with its stream compacted (forced on both sides: the
    reference's rule keeps a stream this small whole) and dart on the fused
    loop (2 iterations, both trees identical: DART's second iteration
    drops the first tree and adds it back rescaled); through the stage
    entry point a fit with ``validationIndicatorCol`` (10% of the rows, 30%
    of their labels flipped so the metric turns within a few iterations)
    and ``earlyStoppingRound=3`` (the fused loop), and one with
    ``numBatches=2`` (the scan): identical first trees and the same best
    iteration. Returns K4's launches and K4 on the card goss fit's
    compacted stream (``compacted_k4``)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier, TrainParams, sparse
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.runtime import use_device

    n, w = N_ANCHOR, W_ANCHOR
    indptr, idx, vals, y = make_csr_text(n, w, 50, 1)
    ds = sparse.SparseDataset.from_csr(indptr, idx, vals, w)
    shk.launches = 0
    compacted = None
    compact = {"MMLSPARK_TPU_SPARSE_COMPACT": "1"}
    for name, kw in SPARSE_VARIANTS.items():
        params = TrainParams(objective="binary", num_iterations=2,
                             num_leaves=31, learning_rate=0.1,
                             min_data_in_leaf=20, **kw)
        route = SPARSE_VARIANT_ROUTES[name]
        envs = ((compact, {**compact, **CPU_SCAN}) if route == "scan"
                else ({}, {}))
        out, stats = {}, None
        for dev, env in zip((DEVICE, "cpu"), envs):
            t0 = time.perf_counter()
            with Env(**env), CompactedInputs(torch, shk, len(idx)) as cin:
                out[dev] = (sparse.train_sparse(params, ds, y, device=dev),
                            time.perf_counter() - t0)
            if dev == DEVICE and route == "scan":
                stats = {k: (v.tolist() if hasattr(v, "tolist") else v)
                         for k, v in sparse.last_scan_stats.items()}
                if cin.args is None:
                    fail(f"anchor {name}: the forced compaction made no "
                         f"compacted K4 call")
                compacted = compacted_k4(torch, shk, cin.args, full_ms)
        bc, bp = out[DEVICE][0], out["cpu"][0]
        diffs = [first_diff(bc.trees[i][0], bp.trees[i][0]) for i in range(2)]
        log({"phase": "sparse_variants", "variant": name, "anchor_rows": n,
             "width": w, "routes": [bc.route, bp.route],
             "scan_selection": stats, "cuda_fit_seconds": out[DEVICE][1],
             "cpu_fit_seconds": out["cpu"][1], "first_diff_per_tree": diffs,
             "tree_1_values_bitwise": bool(np.array_equal(
                 bc.trees[0][0].value, bp.trees[0][0].value))})
        check_route(bc, route, f"anchor {name}")
        check_route(bp, route, f"anchor {name} (CPU)")
        bad = [(i + 1, d) for i, d in enumerate(diffs) if d is not None]
        if bad:
            fail(f"anchor {name}: tree {bad[0][0]} differs between the card's "
                 f"and the CPU's fit: {bad[0][1]}")
        if route == "scan" and not np.array_equal(bc.trees[0][0].value,
                                                  bp.trees[0][0].value):
            fail(f"anchor {name}: tree 1's leaf values are not bit for bit "
                 f"the CPU's")

    rng = np.random.default_rng(5)
    is_val = rng.random(n) < 0.1
    y_flip = np.where(is_val & (rng.random(n) < 0.3), 1.0 - y, y)
    rows = np.empty(n, dtype=object)
    for i in range(n):
        a, b = indptr[i], indptr[i + 1]
        rows[i] = {"indices": idx[a:b], "values": vals[a:b], "size": w}
    df = DataFrame.from_dict({"features": rows, "label": y_flip,
                              "isVal": is_val})
    fits = {"validation": (dict(validationIndicatorCol="isVal",
                                earlyStoppingRound=3, numIterations=10,
                                learningRate=0.3), "fused", {}),
            "num_batches": (dict(numBatches=2, numIterations=1), "scan",
                            CPU_SCAN)}
    for name, (kw, route, cpu_env) in fits.items():
        out = {}
        for dev, env in ((DEVICE, {}), ("cpu", cpu_env)):
            t0 = time.perf_counter()
            with use_device(dev), Env(**env):
                out[dev] = (LightGBMClassifier(numLeaves=31, **kw).fit(df)
                            .booster, time.perf_counter() - t0)
        bc, bp = out[DEVICE][0], out["cpu"][0]
        diff = first_diff(bc.trees[0][0], bp.trees[0][0])
        log({"phase": "sparse_variants", "stage_fit": name, "anchor_rows": n,
             "routes": [bc.route, bp.route],
             "cuda_fit_seconds": out[DEVICE][1],
             "cpu_fit_seconds": out["cpu"][1], "trees": [len(bc.trees),
                                                         len(bp.trees)],
             "best_iteration": [bc.best_iteration, bp.best_iteration],
             "first_diff_tree_1": diff})
        check_route(bc, route, f"anchor stage fit {name}")
        check_route(bp, route, f"anchor stage fit {name} (CPU)")
        if diff is not None or bc.best_iteration != bp.best_iteration:
            fail(f"anchor stage fit {name}: the card and the CPU part: "
                 f"{diff}, best {bc.best_iteration} / {bp.best_iteration}")
    return shk.launches, compacted


# the per-split host loop's cell: the full-width dataset at 127 leaves, whose
# fused-grower state [253, 1,310,720, 3] f32 (3.98 GB) passes the 2 GiB gate
WIDE_LEAVES = 127
WIDE_ITERS = 1


def sparse_wide(torch, data: dict, smi) -> int:
    """``train_sparse`` at 127 leaves, 2 iterations, on the full-width
    dataset: above the grower-state gate, so route ``host``, the reference's
    per-split loop (checked): seconds a tree, host reads a split, peak
    device memory, the card's ``predict_csr`` against the CPU's. Then the
    anchor shape refit for one iteration on the card and on the CPU, both
    on that loop (``MMLSPARK_TPU_FUSED_TREE_BYTES=0`` forces it), the first
    tree identical. Returns K4's launches."""
    from mmlspark_tpu_torch.gbdt import TrainParams, sparse
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.obs.metrics import TrainRecorder, default_registry

    ds, y = data["ds"], data["y"]
    state = (2 * WIDE_LEAVES - 1) * ds.total_bins * 3 * 4
    params = TrainParams(objective="binary", num_iterations=WIDE_ITERS,
                         num_leaves=WIDE_LEAVES, learning_rate=0.1,
                         min_data_in_leaf=20)
    steps = default_registry().histogram(
        "mmlspark_train_step_seconds", labelnames=("engine",),
        buckets=TrainRecorder.STEP_BUCKETS).labels(engine="gbdt_sparse")
    before = steps.value["sum"]
    shk.launches = 0
    reads = sparse.host_reads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = sparse.train_sparse(params, ds, y, device=DEVICE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    loop_s = steps.value["sum"] - before
    reads = sparse.host_reads - reads
    launches = shk.launches
    splits = sum(t.num_leaves - 1 for g in b.trees for t in g)
    indptr, idx, vals = data["csr"]
    cut = int(indptr[N_SCORE])
    q = (indptr[:N_SCORE + 1], idx[:cut], vals[:cut])
    diff = float(np.abs(sparse.predict_csr(b.trees, *q, 1, device=DEVICE)
                        - sparse.predict_csr(b.trees, *q, 1,
                                             device="cpu")).max())
    log({"phase": "sparse_wide", "card": smi, "route": b.route,
         "leaves": WIDE_LEAVES, "fused_state_bytes": state,
         "train_sparse_seconds": fit_s, "loop_seconds": loop_s,
         "seconds_per_tree": loop_s / max(len(b.trees), 1),
         "splits": splits, "host_reads": reads,
         "host_reads_per_split": reads / max(splits, 1),
         "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": {"sparse_hist": launches},
         "max_abs_diff_card_vs_cpu_predict_csr": diff})
    check_route(b, "host", "sparse_wide")
    if state <= 2 << 30:
        fail(f"sparse_wide: the state ({state} bytes) is under the gate")
    if launches < 1 or splits < 1:
        fail("sparse_wide: no split or no K4 launch")
    if reads > 2 * splits + 2 * len(b.trees):
        fail(f"sparse_wide: {reads} host reads for {splits} splits")
    if diff > 1e-12:
        fail(f"sparse_wide: the card's predict_csr differs from the CPU's by "
             f"{diff}")

    # the anchor refit, both sides on the per-split loop
    ai, ax, av, ay = make_csr_text(N_ANCHOR, W_ANCHOR, 50, 1)
    ads = sparse.SparseDataset.from_csr(ai, ax, av, W_ANCHOR)
    params = TrainParams(objective="binary", num_iterations=1,
                         num_leaves=WIDE_LEAVES, learning_rate=0.1,
                         min_data_in_leaf=20)
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        with Env(MMLSPARK_TPU_FUSED_TREE_BYTES="0"):
            out[dev] = (sparse.train_sparse(params, ads, ay, device=dev),
                        time.perf_counter() - t0)
    bc, bp = out[DEVICE][0], out["cpu"][0]
    d = first_diff(bc.trees[0][0], bp.trees[0][0])
    log({"phase": "sparse_wide", "anchor_rows": N_ANCHOR, "width": W_ANCHOR,
         "routes": [bc.route, bp.route], "leaves": bc.trees[0][0].num_leaves,
         "cuda_fit_seconds": out[DEVICE][1], "cpu_fit_seconds": out["cpu"][1],
         "first_diff_tree_1": d,
         "tree_1_values_bitwise": bool(np.array_equal(
             bc.trees[0][0].value, bp.trees[0][0].value))})
    check_route(bc, "host", "sparse_wide anchor")
    check_route(bp, "host", "sparse_wide anchor (CPU)")
    if d is not None:
        fail(f"sparse_wide: the anchor's tree differs between the card's and "
             f"the CPU's per-split loop: {d}")
    return launches


# ---------------------------------------------------------------------------
# serving: the HTTP server, the pipelined replica executor, the binary and
# CSR wire and the routing front, on the card
# ---------------------------------------------------------------------------

SERVE_ROWS = 4096          # requests of the sparse and dense serving loads
SERVE_CONNS = 64           # keep-alive client connections
SERVE_CROSS_ROWS = 256     # rows replayed across the 4 modes x 2 wires
SERVE_TRACED_ROWS = 1024   # requests of the traced sparse load
SERVE_SEQ_REQUESTS = 128   # token frames of the transformer serving load
FRONT_REQUESTS = 512       # requests through the routing front
FRONT_KILL_AFTER = 128     # replies before one worker is stopped
SERVE_PROBA_TOL = 1e-6     # the fused-CSR gate (``fused_sparse``)


def http_load(address, bodies, headers, conns, timeout=300.0, on_reply=None):
    """POST every body over ``conns`` keep-alive connections (one client
    thread each, body i on connection i % conns); returns [(status, body,
    seconds)] in body order. A transport error fails the phase."""
    import http.client
    import threading
    from urllib.parse import urlsplit

    parts = urlsplit(address)
    path = parts.path or "/"
    out = [None] * len(bodies)
    errors = []

    def run(k):
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=timeout)
        try:
            for i in range(k, len(bodies), conns):
                t0 = time.perf_counter()
                conn.request("POST", path, body=bodies[i], headers=headers)
                resp = conn.getresponse()
                out[i] = (resp.status, resp.read(), time.perf_counter() - t0)
                if on_reply is not None:
                    on_reply()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(min(conns, len(bodies)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors or any(t.is_alive() for t in threads) or any(o is None for o in out):
        fail(f"serving load at {address}: {errors[:3]}, "
             f"{sum(o is None for o in out)} requests unanswered")
    return out


def http_get(address, path, timeout=60.0) -> bytes:
    import urllib.request
    from urllib.parse import urlsplit

    parts = urlsplit(address)
    with urllib.request.urlopen(f"http://{parts.netloc}{path}",
                                timeout=timeout) as resp:
        return resp.read()


def latency_summary(replies, stats) -> dict:
    """Client-side p50/p99 of the replies' round trips, the server's own
    rolling-window decomposition, and the p99 bucket of its latency
    histogram (the bucket whose upper edge the 99th percentile is under)."""
    rt = np.array([r[2] for r in replies]) * 1e3
    hist = stats.get("latency_histogram") or {}
    p99_le = None
    count = hist.get("count") or 0
    for le, cum in (hist.get("buckets") or {}).items():
        if count and cum >= 0.99 * count:
            p99_le = le
            break
    return {"client_p50_ms": float(np.percentile(rt, 50)),
            "client_p99_ms": float(np.percentile(rt, 99)),
            "server_total_ms": stats.get("total_ms"),
            "server_queue_ms": stats.get("queue_ms"),
            "server_compute_ms": stats.get("compute_ms"),
            "server_mean_batch": stats.get("mean_batch"),
            "server_p99_bucket_le_s": p99_le}


class FusionWatch:
    """While active, counts what the fused executor did on every batch of
    every replica: partitions that took the host fallback and sparse
    columns that were densified (both must stay 0 on the CSR route)."""

    def __enter__(self):
        from mmlspark_tpu_torch.core import fusion
        from mmlspark_tpu_torch.parallel import ingest

        self.fusion, self.ingest = fusion, ingest
        self.host = self.densify = 0
        self.orig_host = fusion.SegmentExecutor._host_partition
        self.orig_densify = ingest.IngestStats.note_densify
        watch = self

        def host(ex, *a, **kw):
            watch.host += 1
            return watch.orig_host(ex, *a, **kw)

        def densify(st, *a, **kw):
            watch.densify += 1
            return watch.orig_densify(st, *a, **kw)

        fusion.SegmentExecutor._host_partition = host
        ingest.IngestStats.note_densify = densify
        return self

    def __exit__(self, *exc):
        self.fusion.SegmentExecutor._host_partition = self.orig_host
        self.ingest.IngestStats.note_densify = self.orig_densify


def serving_sparse(torch, model, rows, smi) -> int:
    """The sparse main model served fused with the CSR layout and
    ``forest.csr``: 4,096 rows as CSR frames over 64 keep-alive
    connections (async transport, pipelined executor, 2 replicas on the
    card); every reply 200, its probability within ``SERVE_PROBA_TOL`` of
    the unfused transform and its class (argmax of the served probability)
    equal to the unfused prediction; K3 launched, no fallback and no
    densify; 256 of the rows bitwise-equal across the 4 modes (thread/async
    transport x serial/pipelined executor) and the 2 wires (JSON sparse
    dict, CSR frame). Returns K3's launches under the main load."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk
    from mmlspark_tpu_torch.io.binary import (FRAME_CONTENT_TYPE,
                                              encode_csr_columns, encode_frame)
    from mmlspark_tpu_torch.serving import serve_pipeline

    label = "LightGBMClassificationModel"
    sel = rows[:SERVE_ROWS]
    unfused = model.transform(DataFrame.from_dict({"features": sel}))
    want_p = np.stack(list(unfused.column("probability")))
    want_pred = np.asarray(unfused.column("prediction"), dtype=np.float64)
    frames = [encode_frame(encode_csr_columns(
        "features", np.array([0, len(r["indices"])]), r["indices"], r["values"],
        W_SPARSE)) for r in sel]
    jsons = [json.dumps({"indices": np.asarray(r["indices"]).tolist(),
                         "values": np.asarray(r["values"]).tolist(),
                         "size": W_SPARSE}).encode() for r in sel[:SERVE_CROSS_ROWS]]
    frame_hdr = {"Content-Type": FRAME_CONTENT_TYPE}
    fused = PipelineModel([model]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})

    def server(http_mode="async", async_exec=True):
        return serve_pipeline(fused, "features", reply_col="probability",
                              fused=True, async_exec=async_exec, replicas=2,
                              http_mode=http_mode, max_batch_size=256)

    with FusionWatch() as watch:
        srv = server()
        with srv:
            gk.launches = 0
            t0 = time.perf_counter()
            replies = http_load(srv.address, frames, frame_hdr, SERVE_CONNS)
            wall = time.perf_counter() - t0
            launches = gk.launches
            # a shorter load again, traced on the device (core.profiling):
            # its busy share (the trace slows the server, so the load above
            # is not traced)
            t0 = time.perf_counter()
            _, busy, marked, _ = marked_trace(torch, lambda: http_load(
                srv.address, frames[:SERVE_TRACED_ROWS], frame_hdr,
                SERVE_CONNS))
            traced_wall = time.perf_counter() - t0
            stats = json.loads(http_get(srv.address, "/_mmlspark/stats"))
            metrics = http_get(srv.address, "/_mmlspark/metrics").decode()
        cross = {}
        for http_mode in ("thread", "async"):
            for async_exec in (False, True):
                for wire, bodies, hdr in (("json", jsons, {}),
                                          ("frame", frames[:SERVE_CROSS_ROWS],
                                           frame_hdr)):
                    with server(http_mode, async_exec) as s:
                        out = http_load(s.address, bodies, hdr, 16)
                    cross[f"{http_mode}/{'pipelined' if async_exec else 'serial'}"
                          f"/{wire}"] = [o[:2] for o in out]
    statuses = sorted({r[0] for r in replies})
    got_p = np.array([json.loads(r[1]) for r in replies if r[0] == 200])
    ok = statuses == [200] and got_p.shape == want_p.shape
    diff = float(np.abs(got_p - want_p).max()) if ok else None
    pred_equal = ok and np.array_equal(np.argmax(got_p, axis=1).astype(np.float64),
                                       want_pred)
    first = [r[:2] for r in replies[:SERVE_CROSS_ROWS]]
    cross_equal = {k: v == first for k, v in cross.items()}
    wire_in_metrics = 'mmlspark_wire_requests_total{format="binary"}' in metrics
    mem_in_metrics = 'mmlspark_device_memory_bytes{device="cuda:0"' in metrics
    log({"phase": "serving_sparse", "card": smi, "requests": len(frames),
         "connections": SERVE_CONNS, "replicas": 2, "wall_seconds": wall,
         "requests_per_s": len(frames) / wall, "statuses": statuses,
         "k3_launches": launches, "host_fallbacks": watch.host,
         "densifies": watch.densify, "max_abs_proba_diff_vs_unfused": diff,
         "prediction_equal_unfused": bool(pred_equal),
         "bitwise_across_modes_and_wires": cross_equal,
         "metrics_have_wire_counters": wire_in_metrics,
         "metrics_have_device_memory": mem_in_metrics,
         "wire": stats.get("wire"), "async": stats.get("async"),
         "ingest": stats.get("ingest"), **latency_summary(replies, stats)})
    log({"phase": "profile", "card": smi, "load": "serving_sparse",
         "requests": SERVE_TRACED_ROWS, "window_marked": marked,
         "wall_seconds_traced": traced_wall, **busy})
    if not ok:
        fail(f"serving_sparse: statuses {statuses}, replies {got_p.shape}")
    if diff > SERVE_PROBA_TOL or not pred_equal:
        fail(f"serving_sparse: served probability differs by {diff} "
             f"(gate {SERVE_PROBA_TOL}) or the class differs from the unfused "
             f"prediction ({pred_equal})")
    if launches < 1 or watch.host or watch.densify:
        fail(f"serving_sparse: K3 launched {launches} times, {watch.host} host "
             f"fallbacks, {watch.densify} densifies")
    if not all(cross_equal.values()):
        fail(f"serving_sparse: replies differ across modes or wires: {cross_equal}")
    if not (wire_in_metrics and mem_in_metrics):
        fail("serving_sparse: /_mmlspark/metrics lacks the wire counters or "
             "the card's device memory")
    return launches


def serving_dense(torch, model, X, smi):
    """The dense HIGGS-shaped model served fused: 4,096 frames of 28 f64
    values; every reply's probability bitwise-equal to the unfused
    transform's. Scoring is the plain GEMM/gather traversal: no kernel of
    the port runs on this path. Returns the fused model and the unfused
    probabilities (the routing front serves them again)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.io.binary import FRAME_CONTENT_TYPE, encode_frame
    from mmlspark_tpu_torch.serving import serve_pipeline

    sel = X[:SERVE_ROWS]
    unfused = model.transform(DataFrame.from_dict({"features": sel}))
    want = [json.dumps(np.asarray(p).tolist()).encode()
            for p in unfused.column("probability")]
    frames = [encode_frame({"x": np.asarray(r, dtype=np.float64)}) for r in sel]
    fused = PipelineModel([model]).fuse()
    with FusionWatch() as watch:
        srv = serve_pipeline(fused, "features", reply_col="probability",
                             fused=True, async_exec=True, replicas=2,
                             http_mode="async", max_batch_size=256)
        with srv:
            t0 = time.perf_counter()
            replies = http_load(srv.address, frames,
                                {"Content-Type": FRAME_CONTENT_TYPE}, SERVE_CONNS)
            wall = time.perf_counter() - t0
            stats = json.loads(http_get(srv.address, "/_mmlspark/stats"))
    same = sum(r[0] == 200 and r[1] == w for r, w in zip(replies, want))
    log({"phase": "serving_dense", "card": smi, "requests": len(frames),
         "wall_seconds": wall, "requests_per_s": len(frames) / wall,
         "bitwise_equal_unfused": same, "host_fallbacks": watch.host,
         "async": stats.get("async"), **latency_summary(replies, stats)})
    if same != len(frames) or watch.host:
        fail(f"serving_dense: {len(frames) - same} replies are not the unfused "
             f"probability bit for bit ({watch.host} host fallbacks)")
    return fused, want


def serving_front(torch, fused, want, X, smi) -> None:
    """A ``RoutingFront`` over two ``ServingServer`` workers on the card,
    serving the dense model: 512 requests over 8 keep-alive connections to
    the front; after 128 replies one worker is stopped hard (its transport
    closes, as a crashed worker's would). Every request must be answered
    200 with the unfused probability bit for bit, apart from what the
    reference's routing contract allows: a 504 for a POST whose worker read
    timed out (never replayed, non-idempotent)."""
    import threading

    from mmlspark_tpu_torch.io.binary import FRAME_CONTENT_TYPE, encode_frame
    from mmlspark_tpu_torch.serving import RoutingFront, serve_pipeline

    frames = [encode_frame({"x": np.asarray(r, dtype=np.float64)})
              for r in X[:FRONT_REQUESTS]]
    workers = [serve_pipeline(fused, "features", reply_col="probability",
                              fused=True, async_exec=True, http_mode="async")
               for _ in range(2)]
    for w in workers:
        w.start()
    front = RoutingFront(http_mode="async", max_failures=2)
    answered = [0]
    lock = threading.Lock()
    killed = threading.Event()

    def on_reply():
        with lock:
            answered[0] += 1
            kill = answered[0] == FRONT_KILL_AFTER
        if kill:
            workers[0].stop(drain=False)
            killed.set()

    try:
        with front:
            for w in workers:
                front.register(w.address, capacity=w.capacity)
            t0 = time.perf_counter()
            replies = http_load(front.address, frames,
                                {"Content-Type": FRAME_CONTENT_TYPE}, 8,
                                on_reply=on_reply)
            wall = time.perf_counter() - t0
            states = front.worker_states
            survivor_served = workers[1].requests_served
            fstats = json.loads(http_get(front.address, "/_mmlspark/workers"))
    finally:
        for w in workers:
            w.stop(drain=False)
    ok = sum(r[0] == 200 and r[1] == w for r, w in zip(replies, want))
    allowed = sum(r[0] == 504 and b"not replayed" in r[1] for r in replies)
    log({"phase": "serving_front", "card": smi, "requests": len(frames),
         "wall_seconds": wall, "killed_after": FRONT_KILL_AFTER,
         "killed": killed.is_set(), "answered_200_bitwise": ok,
         "allowed_504_unreplayed": allowed,
         "other": len(frames) - ok - allowed,
         "worker_states": states, "survivor_requests_served": survivor_served,
         "front": fstats})
    if not killed.is_set() or ok + allowed != len(frames) or ok == 0:
        fail(f"serving_front: {len(frames) - ok - allowed} requests were not "
             f"answered by the survivor (killed {killed.is_set()})")


def _frame_reply_stage(col: str):
    """Host stage for the transformer's serving phase: ``col`` as one
    binary frame per row in the ``reply`` column (the encoder output is
    4 MiB of f32 a row, which JSON text would turn into ~21 MB)."""
    from mmlspark_tpu_torch.core.pipeline import Transformer
    from mmlspark_tpu_torch.io.binary import encode_frame

    class _FrameReplyStage(Transformer):
        def transform(self, df):
            return df.with_column("reply", lambda p: [
                encode_frame({col: np.asarray(v)}) for v in p[col]])

    return _FrameReplyStage()


def serving_transformer(torch, stage, ids, unfused, smi) -> int:
    """The sequence-benchmark encoder (dim 512, depth 4, 8 heads, vocab
    32,000, seq_len 2048) served through ``serve_pipeline(DNNModel(
    batchSize=64), fused=True, async_exec=True)``: 128 requests of int32
    token frames, replies the encoder output as f32 frames. K5 must launch
    at least 2 batches x 4 layers; every reply is held to the transformer
    gates (1 - cosine ``COS_GAP_MAX``, max and mean |difference|
    ``OUT_MAX_DIFF``, ``OUT_MEAN_DIFF``) against ``DNNModel.transform`` of
    the same rows, not to bits: a served batch can hold other rows than the
    transform's, and an f32 GEMM may take another cuBLAS algorithm at
    another batch size. Returns K5's launches."""
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.io.binary import FRAME_CONTENT_TYPE, decode_frame, encode_frame
    from mmlspark_tpu_torch.models import flash_kernel as fk
    from mmlspark_tpu_torch.serving import serve_pipeline

    n = SERVE_SEQ_REQUESTS
    frames = [encode_frame({"tokens": ids[i].astype(np.int32)}) for i in range(n)]
    chain = PipelineModel([stage, _frame_reply_stage("emb")])
    srv = serve_pipeline(chain, "tokens", fused=True, async_exec=True,
                         max_batch_size=SEQ_BATCH, http_mode="async")
    with srv:
        fk.launches = 0
        t0 = time.perf_counter()
        # every request in flight at once, so batches fill to 64 rows
        replies = http_load(srv.address, frames,
                            {"Content-Type": FRAME_CONTENT_TYPE}, n)
        wall = time.perf_counter() - t0
        launches = fk.launches
        stats = json.loads(http_get(srv.address, "/_mmlspark/stats"))
    statuses = sorted({r[0] for r in replies})
    if statuses != [200]:
        fail(f"serving_transformer: statuses {statuses}")
    got = np.stack([decode_frame(r[1])["emb"] for r in replies])
    want = unfused[:n]
    cos = row_cosines(got, want)
    diff = np.abs(got - want)
    log({"phase": "serving_transformer", "card": smi, "requests": n,
         "tokens": n * SEQ_LEN, "wall_seconds": wall,
         "tokens_per_s": n * SEQ_LEN / wall, "k5_launches": launches,
         "bitwise_rows": int(sum(np.array_equal(a, b) for a, b in zip(got, want))),
         "cos_vs_transform_min": float(cos.min()),
         "max_abs_diff_vs_transform": float(diff.max()),
         "mean_abs_diff_vs_transform": float(diff.mean()),
         "fusion": stats.get("fusion", {}).get("segments"),
         **latency_summary(replies, stats)})
    if launches < 2 * SEQ_DEPTH:
        fail(f"serving_transformer: K5 launched {launches} times, expected at "
             f"least {2 * SEQ_DEPTH}")
    if not np.isfinite(got).all() or 1.0 - cos.min() > COS_GAP_MAX \
            or diff.max() > OUT_MAX_DIFF or diff.mean() > OUT_MEAN_DIFF:
        fail(f"serving_transformer: against DNNModel.transform, 1 - cosine "
             f"{1.0 - cos.min()}, max |d| {diff.max()}, mean |d| {diff.mean()}")
    return launches


# ---------------------------------------------------------------------------
# training: K6/K7 (the flash-attention backward), the encoder's train loop,
# the BiLSTM tagger
# ---------------------------------------------------------------------------

# the reference's sequence-benchmark encoder trained per token: 8 rows of
# 2048 tokens a step, 16 tag classes (tag = token // 2000)
TRAIN_ROWS = 8
TRAIN_STEPS = 20
TRAIN_CLASSES = 16
TRAIN_LR = 0.01               # 0.1 diverges (train_transformer's docstring)
TRAIN_RESUME_STEPS = 6        # gate (d): 6 steps against 3 + resume + 3
TRAIN_SERVE_ROWS = 64         # gate (e): served through DNNModel
TRAIN_GRAD_REL_L2 = 2e-2      # gate (b): per leaf, K5-K7 against plain
# K6/K7 cases: the train shape, causal and not, and the other head dims;
# from 384 up the 128-column slices (the wide train paths' 384 and 512)
ATTN_BWD_CASES = [(8, 2048, 8, 64, False), (8, 2048, 8, 64, True),
                  (8, 2048, 8, 128, False), (8, 2048, 8, 128, True),
                  (4, 2048, 8, 256, False), (4, 2048, 8, 256, True),
                  (2, 2048, 4, 384, False), (2, 2048, 4, 384, True),
                  (2, 2048, 4, 512, False), (2, 2048, 4, 512, True),
                  (1, 2048, 4, 640, False), (1, 2048, 4, 640, True)]
# the encoder trained at the head dims of the sliced K6/K7 (dim, heads):
# D = 384 and 512 at depth 2, a few steps each (gates a and b)
WIDE_TRAIN = ((1536, 4), (2048, 4))
WIDE_TRAIN_DEPTH = 2
WIDE_TRAIN_STEPS = 3
# the encoder served at D = 640 through K5's general path (dim, heads)
WIDE_SERVE = (2560, 4)
WIDE_SERVE_DEPTH = 2
WIDE_SERVE_ROWS = 16
WIDE_SERVE_BATCH = 8
# the tools/bench_seq.py tagger at 64 rows
LSTM_SEQ = 512
LSTM_EMBED = 128
LSTM_HIDDEN = 256
LSTM_TAGS = 16
LSTM_ROWS = 64
LSTM_STEPS = 5
LSTM_LR = 0.2


def attention_vjp_f64(torch, q, k, v, do, causal):
    """Exact attention's (dq, dk, dv) in f64 from the same bf16 inputs, one
    batch row at a time (autograd of ``attention_f64``'s formula)."""
    out = [torch.empty(x.shape, dtype=torch.float64, device=x.device)
           for x in (q, k, v)]
    t, d = q.shape[1], q.shape[-1]
    mask = torch.ones(t, k.shape[1], dtype=torch.bool, device=q.device).triu(1) \
        if causal else None
    with torch.enable_grad():
        for i in range(q.shape[0]):
            leaves = [x[i].double().requires_grad_(True) for x in (q, k, v)]
            s = torch.einsum("qhd,khd->hqk", leaves[0], leaves[1]) / d ** 0.5
            if mask is not None:
                s = s.masked_fill(mask, float("-inf"))
            o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                             leaves[2])
            grads = torch.autograd.grad(o, leaves, do[i].double())
            for dst, g in zip(out, grads):
                dst[i] = g
            del s, o, grads, leaves
    return out


def bwd_ptxas() -> dict:
    """K6's and K7's instantiations as ptxas reported them in this run's
    build: {(which, head dim or slice width, causal, sliced): {registers,
    spill_stores, spill_loads, notes}}; empty when the library came from an
    earlier build."""
    from mmlspark_tpu_torch import _kernels

    out = {}
    for row in _kernels.ptxas_summary(_kernels.build_logs.get("flash_attn_bwd", "")):
        m = re.search(r"flash_bwd_(dkv|dq)_(sm90|sliced)ILi(\d+)ELb([01])E",
                      row["function"] or "")
        if m:
            out[(m.group(1), int(m.group(3)), m.group(4) == "1",
                 m.group(2) == "sliced")] = {
                "registers": row.get("registers"),
                "spill_stores": row.get("spill_stores"),
                "spill_loads": row.get("spill_loads"), "notes": row["warnings"]}
    return out


def attn_bwd_kernel_phase(torch) -> dict:
    """K6 (dK, dV) and K7 (dQ) against the plain backward and both against
    an exact f64 backward, on K5's own output and lse at the train shape
    (B=8, T=2048, H=8, D=64), causal and not, and at D=128 and 256: every
    gradient finite, its max and rms error against f64 no more than
    ``F64_RATIO_MAX`` times the plain version's, two calls bit for bit.
    Each case logs each kernel's ms and TFLOP/s beside the plain
    backward's (all three gradients), the whole ``flash_attention_bwd_cuda``
    call (``bwd_total_ms``), the backward of ``scaled_dot_product_attention``
    on the same inputs (timed only), the bound (K6 8, K7 6 * B*H*T*T*D
    flops, halved under causal masking, at the bf16 peak) and the
    instantiation's ptxas registers and spills; from D = 384 up (the
    128-column slices) also the backend the library call took. At the
    train shape (K6 + K7) over the library call must not pass
    ``BWD_LIBRARY_RATIO_MAX``; no instantiation built in this run may have
    its wgmma pipeline serialised, and the train paths' (D = 64, and the
    sliced ones of the wide train paths' 384 and 512) may not spill."""
    from mmlspark_tpu_torch.models import flash_kernel as fk

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(SEED + 14)
    ptxas = bwd_ptxas()
    main, rows, bad = None, [], []
    for (which, d, causal, sliced), info in sorted(ptxas.items()):
        spills = info["spill_stores"] or info["spill_loads"]
        if (spills and (sliced or d == SEQ_DIM // SEQ_HEADS)) or any(
                "Performance Loss" in n for n in info["notes"]):
            bad.append(f"K6/K7 {which} {'sliced ' if sliced else ''}at {d} "
                       f"causal={causal}: ptxas spills on a train path or "
                       f"serialises its wgmma ({info})")
    for b, t, h, d, causal in ATTN_BWD_CASES:
        t_case = time.perf_counter()
        sliced = d > fk.BWD_TUNED_MAX
        q, k, v = attn_inputs(torch, b, t, h, d, gen)
        do = torch.randn(b, t, h, d, generator=gen).to(DEVICE).to(torch.bfloat16)
        o, lse = fk.flash_attention_cuda(q, k, v, causal, lse=True)
        got = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        again = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        plain = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        exact = attention_vjp_f64(torch, q, k, v, do, causal)
        torch.cuda.synchronize()
        row = {"phase": "attn_bwd_kernel", "b": b, "t": t, "h": h, "d": d,
               "causal": causal, "bitwise_two_calls": all(
                   torch.equal(x, y) for x, y in zip(got, again))}
        for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            row[f"{name}_finite"] = bool(torch.isfinite(g).all())
            row[f"{name}_max_abs_err_vs_plain"] = (g.float() - p.float()).abs().max().item()
            for who, x in (("kernel", g), ("plain", p)):
                err = x.double() - e
                row[f"{name}_{who}_err_vs_f64"] = err.abs().max().item()
                row[f"{name}_{who}_rms_vs_f64"] = err.square().mean().sqrt().item()
        del got, again, plain, exact
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bufs = [torch.empty_like(x) for x in (q, k, v)]
        for which in ("dkv", "dq"):
            row[f"{which}_ms"] = time_ms(torch, lambda: fk.launch_bwd(
                which, q, k, v, do, lse, di, *bufs, causal), 10)
            flops, nbytes = fk.bwd_cost(b, t, t, h, d, causal, which)
            row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = bound_ms(
                nbytes, flops, BF16_OPS_PER_S)
            row[f"{which}_tflops"] = flops / row[f"{which}_ms"] / 1e9
            row[f"{which}_ptxas"] = ptxas.get(
                (which, fk.SLICE if sliced else d, causal, sliced))
        row["bwd_total_ms"] = time_ms(torch, lambda: fk.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal), 10)
        row["plain_ms"] = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal), 3, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        if d >= 384:
            row["library_backend"] = sdpa_backend(torch, qt, kt, vt, causal)
        dot = do.transpose(1, 2).contiguous()
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 10)
        row["pair_over_library"] = (row["dkv_ms"] + row["dq_ms"]) / row["library_ms"]
        row["total_over_library"] = row["bwd_total_ms"] / row["library_ms"]
        row["case_seconds"] = time.perf_counter() - t_case
        log(row)
        rows.append(row)
        if (b, t, h, d) == (TRAIN_ROWS, SEQ_LEN, SEQ_HEADS, SEQ_DIM // SEQ_HEADS) \
                and not causal:
            main = row
        del q, k, v, do, o, lse, di, bufs, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
        msgs = []
        if not row["bitwise_two_calls"]:
            msgs.append("two calls differ")
        for name in ("dq", "dk", "dv"):
            if not row[f"{name}_finite"]:
                msgs.append(f"{name} not finite")
            for stat in ("err", "rms"):
                kern = row[f"{name}_kernel_{stat}_vs_f64"]
                plain_v = row[f"{name}_plain_{stat}_vs_f64"]
                if kern > F64_RATIO_MAX * plain_v:
                    msgs.append(f"{name}'s {stat} against f64, {kern}, exceeds "
                                f"{F64_RATIO_MAX}x the plain version's {plain_v}")
        bad += [f"{m} at b={b} t={t} h={h} d={d} causal={causal}" for m in msgs]
    log({"phase": "attn_bwd_kernel", "card_limits": {
        "max_f64_err_ratio": max(r[f"{n}_kernel_err_vs_f64"] / r[f"{n}_plain_err_vs_f64"]
                                 for r in rows for n in ("dq", "dk", "dv")),
        "max_f64_rms_ratio": max(r[f"{n}_kernel_rms_vs_f64"] / r[f"{n}_plain_rms_vs_f64"]
                                 for r in rows for n in ("dq", "dk", "dv")),
        "max_pair_over_library": max(r["pair_over_library"] for r in rows),
        "sliced_min_tflops": min(min(r["dkv_tflops"], r["dq_tflops"])
                                 for r in rows if r["d"] > fk.BWD_TUNED_MAX)},
         "sliced_cases_seconds": sum(r["case_seconds"] for r in rows
                                     if r["d"] > fk.BWD_TUNED_MAX)})
    log({"phase": "attn_bwd_kernel", "main_path_pair_ms": main["dkv_ms"] + main["dq_ms"],
         "main_path_bwd_total_ms": main["bwd_total_ms"],
         "main_path_library_ms": main["library_ms"],
         "main_path_pair_over_library": main["pair_over_library"],
         "bound": f"<= {BWD_LIBRARY_RATIO_MAX} x the backward of "
                  "scaled_dot_product_attention", "ptxas_instantiations": len(ptxas)})
    if main["pair_over_library"] > BWD_LIBRARY_RATIO_MAX:
        bad.append(f"K6 + K7 at the train shape take {main['pair_over_library']:.3f}x "
                   f"the library backward (bound {BWD_LIBRARY_RATIO_MAX})")
    if bad:
        fail("; ".join(bad))
    common = dict(route="cuda", source="mmlspark_tpu_torch/csrc/flash_attn_bwd.cu",
                  status="Hopper design: a TMA producer warp, two wgmma consumer "
                         "warpgroups taking turns, no column split up to D = 256; "
                         "from 384 up 128-column slices with D streamed in "
                         "64-column chunks",
                  plain_ms=main["plain_ms"], library_ms=main["library_ms"],
                  bwd_total_ms=main["bwd_total_ms"],
                  plain_call="flash_attention_bwd_plain: dq, dk and dv",
                  library_call="the backward of torch.nn.functional."
                               "scaled_dot_product_attention on bf16 [B, H, T, D] "
                               "(dq, dk and dv; timed only)",
                  shape=dict(b=TRAIN_ROWS, t=SEQ_LEN, h=SEQ_HEADS,
                             d=SEQ_DIM // SEQ_HEADS, causal=False),
                  bound_peak="989 TFLOP/s bf16 dense (spec), 3.35 TB/s")
    out = {}
    for name, which, grads, replaces in (
            ("flash_attn_bwd_dkv", "dkv", ("dk", "dv"),
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
            ("flash_attn_bwd_dq", "dq", ("dq",),
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1456")):
        wide = [{"b": r["b"], "t": r["t"], "h": r["h"], "d": r["d"],
                 "causal": r["causal"], "ms": r[f"{which}_ms"],
                 "tflops": r[f"{which}_tflops"],
                 "bound_ms": r[f"{which}_bound_ms"],
                 "bwd_total_ms": r["bwd_total_ms"], "plain_ms": r["plain_ms"],
                 "library_ms": r["library_ms"],
                 "library_backend": r.get("library_backend"),
                 "ptxas": r[f"{which}_ptxas"]}
                for r in rows if r["d"] > fk.BWD_TUNED_MAX]
        out[name] = dict(name=name, replaces=replaces, ms=main[f"{which}_ms"],
                         tflops=main[f"{which}_tflops"],
                         max_abs_err=max(main[f"{g}_max_abs_err_vs_plain"]
                                         for g in grads),
                         bound_ms=main[f"{which}_bound_ms"],
                         bound_by=main[f"{which}_bound_by"], wide=wide, **common)
        log(dict(phase="kernels", **out[name]))
    return out


def zero_attn_launches() -> None:
    from mmlspark_tpu_torch.models import flash_kernel as fk

    fk.launches = fk.bwd_dkv_launches = fk.bwd_dq_launches = 0


def read_attn_launches() -> dict:
    from mmlspark_tpu_torch.models import flash_kernel as fk

    return {"flash_attn": fk.launches, "flash_attn_bwd_dkv": fk.bwd_dkv_launches,
            "flash_attn_bwd_dq": fk.bwd_dq_launches}


def train_batches(n: int, seed: int, rows: int, t: int, vocab: int,
                  classes_every: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, vocab, (rows, t))
        out.append({"x": x, "y": (x // classes_every).astype(np.int32)})
    return out


def grads_rel_l2(torch, module, params, batch) -> dict:
    """Per leaf, the relative L2 difference of step-1 gradients with K5-K7
    against the same gradients with ``MMLSPARK_TPU_NO_FLASH=1`` (plain
    attention under autograd, on the card)."""
    import os

    from mmlspark_tpu_torch.models import training

    _, _, flash = training.loss_and_grads(module, params, batch)
    os.environ["MMLSPARK_TPU_NO_FLASH"] = "1"
    try:
        _, _, plain = training.loss_and_grads(module, params, batch)
    finally:
        del os.environ["MMLSPARK_TPU_NO_FLASH"]
    fl, pl = training._flatten(flash), training._flatten(plain)
    return {n: ((fl[n].double() - pl[n].double()).norm()
                / pl[n].double().norm().clamp_min(1e-30)).item() for n in pl}


def train_run(torch, depth: int, causal: bool, steps: int, smi, what: str,
              dim: int = SEQ_DIM, heads: int = SEQ_HEADS):
    """``run_train_loop`` of the encoder (width ``dim``, ``heads`` heads) at
    ``depth`` for ``steps`` steps: gates (a) each of K5, K6 and K7 launched
    depth times a step, (b) step 1's gradients within ``TRAIN_GRAD_REL_L2``
    of plain attention's. Returns (launches, model, step fn, first state,
    batches, result, losses)."""
    from mmlspark_tpu_torch.models import training, transformer_encoder

    model = transformer_encoder(seq_len=SEQ_LEN, dim=dim, depth=depth,
                                num_heads=heads, vocab_size=SEQ_VOCAB,
                                num_classes=TRAIN_CLASSES, causal=causal, seed=0)
    opt = training.make_optimizer(learning_rate=TRAIN_LR, momentum=0.9)
    state0 = training.init_train_state(model.module, (SEQ_LEN,), opt, seed=0,
                                       device=DEVICE)
    step = training.make_train_step(model.module, opt)
    batches = train_batches(steps, SEED + depth, TRAIN_ROWS, SEQ_LEN, SEQ_VOCAB,
                            SEQ_VOCAB // TRAIN_CLASSES)
    rel = grads_rel_l2(torch, model.module, state0.params, batches[0])
    losses, times = [], []

    def timed_step(st, batch):
        t0 = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))   # reads the device: the step's end
        times.append(time.perf_counter() - t0)
        return st, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attn_launches()
    t0 = time.perf_counter()
    res = training.run_train_loop(state0, timed_step, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_attn_launches()
    ms = sorted(x * 1e3 for x in times)
    step_ms = ms[len(ms) // 2]
    log({"phase": what, "card": smi, "dim": dim, "heads": heads,
         "head_dim": dim // heads, "depth": depth, "causal": causal,
         "steps": steps, "rows": TRAIN_ROWS, "params": model.num_params(),
         "wall_seconds": wall, "first_step_ms": times[0] * 1e3,
         "median_step_ms": step_ms,
         "tokens_per_s": TRAIN_ROWS * SEQ_LEN / (step_ms / 1e3),
         "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": launches, "losses": losses,
         "grad_rel_l2_vs_plain_max": max(rel.values()),
         "grad_rel_l2_vs_plain": rel})
    want = depth * steps
    if any(v != want for v in launches.values()):
        fail(f"{what}: K5/K6/K7 launched {launches}, expected {want} each "
             f"({depth} a step)")
    worst = max(rel, key=rel.get)
    if rel[worst] > TRAIN_GRAD_REL_L2:
        fail(f"{what}: step 1's gradient of {worst} differs from plain "
             f"attention's by {rel[worst]} (relative L2; bound "
             f"{TRAIN_GRAD_REL_L2})")
    return launches, model, step, state0, batches, res, losses


def train_transformer(torch, smi) -> tuple:
    """The reference's sequence-benchmark encoder (dim 512, depth 4, 8 heads,
    vocab 32,000, seq_len 2048) with a 16-class per-token head trained by
    ``run_train_loop``: 20 steps of 8 rows (seeded tokens, tag = token //
    2000), SGD 0.01, momentum 0.9 (at 0.1 the loss climbed from 3.1 to
    20-36 on the card, and on the CPU at T=256, depth 2). Gates: (a) K5, K6 and K7 four times a
    step each; (b) step 1's gradients against plain attention on the card,
    per leaf; (c) the mean loss of the last 5 steps below the first 5's;
    (d) 6 steps against 3 + a checkpoint + resume + 3, params and trace bit
    for bit; (e) the trained params served through ``DNNModel(batchSize=64)``
    on 64 rows bit for bit ``FunctionModel.apply`` on the same batch, K5
    launched and K6/K7 not. Logs step ms, tokens/s, peak memory and the
    device's busy share of one step. Then a causal depth-1 run of 3 steps
    (gates a and b). Returns (main-path launches, the causal run's)."""
    import tempfile

    from mmlspark_tpu_torch.core import profiling
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, training

    launches, model, step, state0, batches, res, losses = train_run(
        torch, SEQ_DEPTH, False, TRAIN_STEPS, smi, "train_transformer")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first or not np.isfinite(losses).all():
        fail(f"train_transformer: the loss did not fall: first 5 {first}, "
             f"last 5 {last} ({losses})")
    # one more step under the profiler: the device's busy share
    with profiling.trace() as prof:
        st, m = step(res.state, batches[0])
        float(m["loss"])
        torch.cuda.synchronize()
    busy = profiling.device_busy(prof, top=8, gaps=5)
    log({"phase": "train_transformer", "card": smi, "profiled_step": busy,
         "loss_first_5": first, "loss_last_5": last})
    del st, m, prof
    # (d) resume bit for bit
    n = TRAIN_RESUME_STEPS
    full = training.run_train_loop(state0, step, batches[:n])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/state.pt"
        half = training.run_train_loop(state0, step, batches[:n // 2],
                                       checkpoint_path=ckpt, every_k=n // 2)
        t0 = time.perf_counter()
        resumed = training.run_train_loop(state0, step, batches[:n],
                                          checkpoint_path=ckpt)
        resume_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for tree in ("params", "opt_state")
               for a, b in zip(training._flatten(getattr(resumed.state, tree)).values(),
                               training._flatten(getattr(full.state, tree)).values()))
    log({"phase": "train_transformer", "resume_steps": [half.steps_run,
                                                        resumed.steps_run],
         "resume_seconds": resume_s, "resumed_bitwise_uninterrupted": same})
    if half.steps_run != n // 2 or resumed.steps_run != n - n // 2 or not same:
        fail(f"train_transformer: 3 steps + resume + 3 is not 6 steps bit for "
             f"bit (steps {half.steps_run}, {resumed.steps_run}, same {same})")
    del full, half, resumed
    # (e) serve the trained params
    training.assign_params(model.module, res.state.params)
    ids = np.random.default_rng(SEED + 15).integers(
        0, SEQ_VOCAB, (TRAIN_SERVE_ROWS, SEQ_LEN))
    stage = DNNModel(inputCol="tokens", outputCol="logits",
                     batchSize=TRAIN_SERVE_ROWS).set_model(model)
    zero_attn_launches()
    served = np.stack(list(stage.transform(DataFrame.from_dict(
        {"tokens": ids})).column("logits")))
    torch.cuda.synchronize()
    serve_launches = read_attn_launches()
    x = torch.from_numpy(ids).to(DEVICE)
    want = model.apply(x, params=model.device_params(x.device)).cpu().numpy()
    log({"phase": "train_transformer", "served_rows": TRAIN_SERVE_ROWS,
         "served_launches": serve_launches,
         "served_bitwise_apply": bool(np.array_equal(served, want)),
         "served_max_abs_diff": float(np.abs(served - want).max())})
    if serve_launches["flash_attn"] != SEQ_DEPTH or \
            serve_launches["flash_attn_bwd_dkv"] or serve_launches["flash_attn_bwd_dq"]:
        fail(f"train_transformer: serving launched {serve_launches}, expected "
             f"K5 {SEQ_DEPTH} times and K6/K7 never")
    if served.shape != (TRAIN_SERVE_ROWS, SEQ_LEN, TRAIN_CLASSES) \
            or not np.array_equal(served, want):
        fail("train_transformer: the served trained model is not "
             "FunctionModel.apply bit for bit")
    del model, step, state0, res, stage, x
    torch.cuda.empty_cache()
    causal = train_run(torch, 1, True, 3, smi, "train_transformer_causal")[0]
    torch.cuda.empty_cache()
    return launches, causal


def train_wide_heads(torch, smi) -> dict:
    """The encoder (vocab 32,000, seq_len 2048, depth 2) trained by
    ``run_train_loop`` at head dims 384 and 512 (``WIDE_TRAIN``: dim 1536
    and 2048, 4 heads): K5 through its tuned 384/512 instantiations, K6 and
    K7 through their 128-column slices, ``WIDE_TRAIN_STEPS`` steps of 8
    rows each, gates (a) and (b) of ``train_run``. Returns each run's
    launches by path name."""
    out = {}
    for dim, heads in WIDE_TRAIN:
        what = f"train_wide_d{dim // heads}"
        t0 = time.perf_counter()
        out[what] = train_run(torch, WIDE_TRAIN_DEPTH, False, WIDE_TRAIN_STEPS,
                              smi, what, dim=dim, heads=heads)[0]
        torch.cuda.empty_cache()
        log({"phase": what, "seconds": time.perf_counter() - t0})
    return out


def serve_wide_heads(torch, smi) -> dict:
    """The encoder at head dim 640 (``WIDE_SERVE``: dim 2560, 4 heads,
    depth 2, vocab 32,000, seq_len 2048) served through
    ``DNNModel.transform`` over ``WIDE_SERVE_ROWS`` rows in batches of
    ``WIDE_SERVE_BATCH``: K5's general path launched depth times a batch,
    the output held against plain attention on the card
    (``MMLSPARK_TPU_NO_FLASH=1``) with transformer_main's gates
    (``COS_GAP_MAX``, ``OUT_MAX_DIFF``, ``OUT_MEAN_DIFF``)."""
    import os

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, transformer_encoder

    dim, heads = WIDE_SERVE
    t0 = time.perf_counter()
    model = transformer_encoder(seq_len=SEQ_LEN, dim=dim, depth=WIDE_SERVE_DEPTH,
                                num_heads=heads, vocab_size=SEQ_VOCAB, seed=0)
    ids = np.random.default_rng(SEED + 22).integers(
        0, SEQ_VOCAB, (WIDE_SERVE_ROWS, SEQ_LEN))
    df = DataFrame.from_dict({"tokens": ids})
    stage = DNNModel(inputCol="tokens", outputCol="emb",
                     batchSize=WIDE_SERVE_BATCH).set_model(model)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    zero_attn_launches()
    t0 = time.perf_counter()
    out = _emb(stage.transform(df))
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    launches = read_attn_launches()
    os.environ["MMLSPARK_TPU_NO_FLASH"] = "1"
    try:
        plain = _emb(stage.transform(df))
    finally:
        del os.environ["MMLSPARK_TPU_NO_FLASH"]
    cos = row_cosines(out, plain)
    diff = np.abs(out - plain)
    want = WIDE_SERVE_DEPTH * WIDE_SERVE_ROWS // WIDE_SERVE_BATCH
    log({"phase": "serve_wide_d640", "card": smi, "dim": dim, "heads": heads,
         "head_dim": dim // heads, "depth": WIDE_SERVE_DEPTH,
         "rows": WIDE_SERVE_ROWS, "params": model.num_params(),
         "setup_seconds": setup_s, "transform_seconds": transform_s,
         "tokens_per_s": WIDE_SERVE_ROWS * SEQ_LEN / transform_s,
         "launches": launches, "cos_vs_plain_min": float(cos.min()),
         "max_abs_diff_vs_plain": float(diff.max()),
         "mean_abs_diff_vs_plain": float(diff.mean())})
    if launches["flash_attn"] != want or launches["flash_attn_bwd_dkv"] \
            or launches["flash_attn_bwd_dq"]:
        fail(f"serve_wide_d640: launched {launches}, expected K5 {want} times "
             f"and K6/K7 never")
    if out.shape != (WIDE_SERVE_ROWS, SEQ_LEN, dim) or not np.isfinite(out).all():
        fail(f"serve_wide_d640: output shape {out.shape} or non-finite values")
    if 1.0 - cos.min() > COS_GAP_MAX or diff.max() > OUT_MAX_DIFF \
            or diff.mean() > OUT_MEAN_DIFF:
        fail(f"serve_wide_d640 against plain attention: 1 - cosine "
             f"{1.0 - cos.min()} (bound {COS_GAP_MAX}), max |d| {diff.max()} "
             f"({OUT_MAX_DIFF}), mean |d| {diff.mean()} ({OUT_MEAN_DIFF})")
    del model, stage, out, plain
    torch.cuda.empty_cache()
    return {"serve_wide_d640": {"flash_attn": launches["flash_attn"]}}


def bilstm_train(torch, smi) -> None:
    """``tools/bench_seq.py``'s tagger (seq 512, vocab 32,000, embed 128,
    hidden 256, 16 tags) on 64 rows: the card's forward within
    ``DEEP_BF16_TOL`` of the CPU's on the same params and ids, then 5 train
    steps on those rows (tag = token // 2000; SGD 0.2, momentum 0.9, the
    reference's tagger test's) whose loss must fall: one batch, since at
    init the BiLSTM's features are ~1e-2 and a fresh batch's loss moves
    less in 5 steps than from batch to batch. No kernel of the port runs
    here (the LSTM scan is torch.matmul a step)."""
    from mmlspark_tpu_torch.models import bilstm_tagger, training
    from mmlspark_tpu_torch.runtime import use_device

    model = bilstm_tagger(LSTM_SEQ, SEQ_VOCAB, LSTM_EMBED, LSTM_HIDDEN,
                          LSTM_TAGS, seed=0)
    ids = np.random.default_rng(SEED + 16).integers(0, SEQ_VOCAB,
                                                    (LSTM_ROWS, LSTM_SEQ))
    x = torch.from_numpy(ids)
    t0 = time.perf_counter()
    card = model.apply(x.to(DEVICE), params=model.device_params(DEVICE)).cpu()
    card_s = time.perf_counter() - t0
    with use_device("cpu"):
        cpu = model.apply(x)
    diff = (card - cpu).abs().max().item()
    opt = training.make_optimizer(learning_rate=LSTM_LR, momentum=0.9)
    state = training.init_train_state(model.module, (LSTM_SEQ,), opt, seed=0,
                                      device=DEVICE)
    step = training.make_train_step(model.module, opt)
    losses, times = [], []
    batch = {"x": ids, "y": (ids // (SEQ_VOCAB // LSTM_TAGS)).astype(np.int32)}
    for _ in range(LSTM_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    log({"phase": "bilstm_train", "card": smi, "rows": LSTM_ROWS,
         "forward_seconds": card_s, "max_abs_diff_vs_cpu": diff,
         "losses": losses, "step_seconds": times,
         "tokens_per_s": LSTM_ROWS * LSTM_SEQ / float(np.median(times))})
    if diff > DEEP_BF16_TOL:
        fail(f"bilstm_train: the card's forward is {diff} from the CPU's "
             f"(bound {DEEP_BF16_TOL})")
    if not losses[-1] < losses[0]:
        fail(f"bilstm_train: the loss did not fall: {losses}")


# ---------------------------------------------------------------------------
# K-step mega dispatch as captured CUDA graphs, the cost model and the Tuner,
# serving with the Tuner, and slot-deposit staging
# ---------------------------------------------------------------------------

# the K of the GBDT mega phases (K = 4 was cut for the script's time: K = 8
# groups batches the same way, at twice the group length)
MEGA_KS = (1, 8)
MEGA_SEQ_KS = (1, 4)          # and of the transformer's (4 batches of 64)
TUNER_STEPS = 3
TUNER_ROWS = 16_384           # rows a Tuner measurement scores
AUTOTUNE_REQUESTS = 1024      # 2,048 until PR 23: cut for the script's time
AUTOTUNE_EVERY = 50
BOUND_RATIO_MAX = 1.05        # a segment's bound / measured wall per batch
DEPOSIT_FRAMES = 512
STITCH_TOL = 1e-5             # the classifier's declared finalize_tolerance


def _mega_fused(model, k: int, csr: bool, label: str):
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel

    fused = FusedPipelineModel([model], cache=CompileCache())
    tuning = {"mega_k": {label: k}}
    if csr:
        tuning.update(layout={label: "csr"},
                      kernel_variants={label: {"*": "forest.csr"}})
    fused.set_tuning(**tuning)
    return fused


def _graphs_of(fused) -> int:
    """CUDA graphs the fused model's K-step programs have captured."""
    return sum(getattr(getattr(e, "program", e), "graphs", 0)
               for e in list(fused.compile_cache._entries.values()))


def mega_run(torch, fused, df, read, kernel, what: str) -> dict:
    """One fused model over ``df`` through ``transform_submit`` twice: the
    first call builds its programs (K=1 eagerly; K>1 runs each group's
    batches eagerly once and captures the graph), the second is the
    measured one, with every launch counter set to 0 before it and, for
    K>1, its dispatch (the replays) under
    ``set_sync_debug_mode("error")``. Returns the output, seconds, the
    kernel's launches and the executor's decomposition."""
    from mmlspark_tpu_torch.core import graphs

    k = fused.mega_k_max
    read(fused.transform_submit(df)())
    graphs.set_counters({c: 0 for c in graphs.COUNTERS})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if k > 1:
        torch.cuda.set_sync_debug_mode("error")
    try:
        resolve = fused.transform_submit(df)
    except RuntimeError as e:
        fail(f"{what}: a host sync in the dispatch at K={k}: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dispatch_s = time.perf_counter() - t0
    out = read(resolve())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    label = next(iter(fused._seg_stats))
    records = fused._seg_stats[label].records
    seg = fused.fusion_stats()["per_segment"][label]
    return {"k": k, "out": out, "seconds": seconds,
            "submit_seconds": dispatch_s,
            "launches": getattr(kernel, "launches", None) if kernel else None,
            "batches": len(records),
            "mega_groups": sum(t.mega_k > 1 for t in records) // max(k, 1)
            if k > 1 else 0,
            "graphs": _graphs_of(fused),
            "dispatch_ms_per_batch": seg.get("dispatch_ms_per_batch"),
            "h2d_ms_per_batch": seg.get("h2d_ms_per_batch"),
            "compute_ms_per_batch": seg.get("compute_ms_per_batch"),
            "readback_ms_per_batch": seg.get("readback_ms_per_batch"),
            "fallbacks": fused.fusion_stats()["fallbacks"], "fused": fused}


def _mega_report(phase, runs, smi, extra=None) -> dict:
    rows = [{k: v for k, v in r.items() if k not in ("out", "fused")}
            for r in runs]
    log({"phase": phase, "card": smi, "runs": rows, **(extra or {})})
    return {r["k"]: r for r in runs}


def mega_sparse(torch, model, rows, smi) -> dict:
    """The fused CSR scoring path (``layout="csr"``, ``forest.csr``) over
    the sparse rows through ``transform_submit`` at ``MEGA_KS``: the
    outputs at K > 1 equal K=1's bit for bit and the unfused transform's
    within the fused-CSR gate (``SERVE_PROBA_TOL``; the fused CSR scores
    are not the unfused ones bit for bit, ``fused_sparse``), K3 launched
    once a batch through the graph replays, the replays free of host syncs.
    Returns the runs by K."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk

    label = "LightGBMClassificationModel"
    df = DataFrame.from_dict({"features": rows})
    unfused = _raw(model.transform(df))
    runs = [mega_run(torch, _mega_fused(model, k, True, label), df, _raw, gk,
                     "mega_sparse") for k in MEGA_KS]
    base = runs[0]["out"]
    bitwise = {r["k"]: bool(np.array_equal(r["out"].view(np.uint64),
                                           base.view(np.uint64))) for r in runs}
    diff = float(np.abs(base - unfused).max())
    out = _mega_report("mega_sparse", runs, smi, {
        "rows": len(rows), "bitwise_vs_k1": bitwise,
        "max_abs_diff_vs_unfused": diff})
    for r in runs:
        if r["fallbacks"]:
            fail(f"mega_sparse K={r['k']}: fell back {r['fallbacks']}")
        if r["launches"] != r["batches"] or r["batches"] != len(rows) // 256:
            fail(f"mega_sparse K={r['k']}: K3 launched {r['launches']} times "
                 f"over {r['batches']} batches")
        if r["k"] > 1 and (r["mega_groups"] != r["batches"] // r["k"]
                           or r["graphs"] != 1):
            fail(f"mega_sparse K={r['k']}: {r['mega_groups']} mega groups, "
                 f"{r['graphs']} graphs")
    if not all(bitwise.values()) or diff > SERVE_PROBA_TOL:
        fail(f"mega_sparse: not K=1's bits {bitwise}, or {diff} from unfused")
    return out


def mega_dense(torch, model, X, smi) -> dict:
    """The dense HIGGS-shaped rows fused, through ``transform_submit`` at
    ``MEGA_KS``: the GEMM traversal (an f32 cuBLAS GEMM, TF32 off) under
    graph capture equals K=1 and the unfused transform bit for bit, and the
    replays make no host sync."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame

    label = "LightGBMClassificationModel"
    df = DataFrame.from_dict({"features": X})
    unfused = _raw(model.transform(df))
    runs = [mega_run(torch, _mega_fused(model, k, False, label), df, _raw,
                     None, "mega_dense") for k in MEGA_KS]
    bitwise = {r["k"]: bool(np.array_equal(r["out"].view(np.uint64),
                                           unfused.view(np.uint64)))
               for r in runs}
    out = _mega_report("mega_dense", runs, smi, {
        "rows": len(X), "bitwise_vs_unfused": bitwise})
    for r in runs:
        if r["fallbacks"] or (r["k"] > 1 and r["graphs"] != 1):
            fail(f"mega_dense K={r['k']}: fallbacks {r['fallbacks']}, "
                 f"{r['graphs']} graphs")
    if not all(bitwise.values()):
        fail(f"mega_dense: outputs are not the unfused ones bit for bit "
             f"{bitwise}")
    return out


def mega_transformer(torch, stage, df, smi) -> dict:
    """The sequence benchmark's encoder through ``DNNModel`` fused, the 256
    rows of ``df`` in one partition (4 batches of 64: a K-step group never
    spans partitions), at K = 1 and 4: K=4's graph replay equals K=1 bit for
    bit and launches K5 as many times as the eager program."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import flash_kernel as fk

    df = DataFrame.from_dict({"tokens": np.asarray(list(df.column("tokens")))})
    runs = [mega_run(torch, _mega_fused(stage, k, False, "DNNModel"), df, _emb,
                     fk, "mega_transformer") for k in MEGA_SEQ_KS]
    bitwise = bool(np.array_equal(runs[1]["out"].view(np.uint32),
                                  runs[0]["out"].view(np.uint32)))
    out = _mega_report("mega_transformer", runs, smi,
                       {"rows": SEQ_ROWS, "bitwise_vs_k1": bitwise})
    want = SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH
    for r in runs:
        if r["fallbacks"] or r["launches"] != want:
            fail(f"mega_transformer K={r['k']}: K5 launched {r['launches']} "
                 f"times (expected {want}), fallbacks {r['fallbacks']}")
    if not bitwise or runs[1]["graphs"] != 1 or runs[1]["mega_groups"] != 1:
        fail(f"mega_transformer: bitwise {bitwise}, {runs[1]['graphs']} graphs, "
             f"{runs[1]['mega_groups']} groups")
    return out


def tuner_phase(torch, sparse_runs, dense_runs, model, rows, smi) -> dict:
    """The cost model folded from the fused sparse and dense runs (their
    cache's tallied costs and their executors' timings), then
    ``Tuner.tune(measure)`` for ``TUNER_STEPS`` steps on the fused sparse
    path at K=1, ``measure`` its rows/s over ``TUNER_ROWS`` rows: the
    proposed and applied knobs, the journal, the prediction error and each
    segment's roofline attribution. A segment's bound must not pass its
    measured wall per batch (``BOUND_RATIO_MAX``): the tally would be
    overcounting."""
    from mmlspark_tpu_torch.core.costmodel import SegmentCostModel
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.tune import Tuner
    from mmlspark_tpu_torch.obs.perf import attribute_segments, device_peaks

    label = "LightGBMClassificationModel"
    model_cm = SegmentCostModel()
    roofline = {}
    for name, runs in (("sparse", sparse_runs), ("dense", dense_runs)):
        for k, r in runs.items():
            fused = r["fused"]
            model_cm.ingest_costs(fused.compile_cache.costs())
            model_cm.observe_stats(label, fused._seg_stats[label])
            st = fused.fusion_stats()
            att = attribute_segments(st["per_segment"], st["segment_costs"],
                                     peaks=device_peaks(),
                                     layout={label: "csr"} if name == "sparse"
                                     else None)
            roofline[f"{name}/K={k}"] = att.get(label)
    # the tuned model feeds the cost model too (its host timings and the
    # sparse density behind choose_layout): warm it over a few transforms,
    # or the first proposal, lacking a calibrated layout, would clear "csr"
    fused = _mega_fused(model, 1, True, label)
    fused.set_tuning(cost_model=model_cm)
    df = DataFrame.from_dict({"features": rows[:TUNER_ROWS]})
    for _ in range(model_cm.min_obs):
        fused.transform(df)
    tuner = Tuner(fused=fused, model=model_cm)

    def measure() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.transform_submit(df)()
        return TUNER_ROWS / (time.perf_counter() - t0)

    tuner.refit()
    proposed = tuner.propose().to_dict()
    t0 = time.perf_counter()
    summary = tuner.tune(measure, steps=TUNER_STEPS)
    tune_s = time.perf_counter() - t0
    st = fused.fusion_stats()
    att = attribute_segments(st["per_segment"], st["segment_costs"],
                             peaks=device_peaks(), cost_model=model_cm,
                             layout={label: "csr"})
    roofline["sparse/tuned"] = att.get(label)
    ratios = {k: (v or {}).get("roofline_ratio") for k, v in roofline.items()}
    log({"phase": "tuner", "card": smi, "seconds": tune_s,
         "proposed": proposed, "applied": tuner.knobs.to_dict(),
         "summary": summary, "journal": tuner.journal,
         "prediction_error": model_cm.prediction_error(),
         "peaks": device_peaks(), "costs": st["segment_costs"],
         "roofline": roofline, "bound_ratio": ratios,
         "model": model_cm.stats()})
    bad = {k: v for k, v in ratios.items() if v is None or v > BOUND_RATIO_MAX}
    if bad:
        fail(f"tuner: bound over measured wall per batch {bad} (no cost "
             f"recorded, or over {BOUND_RATIO_MAX})")
    if len(summary["steps"]) < 2:
        fail(f"tuner: no tuning step ran: {summary}")
    return {"applied": tuner.knobs.to_dict(), "rollbacks": tuner.rollbacks}


def serving_autotune(torch, model, rows, smi) -> dict:
    """``serve_pipeline(autotune=True, tune_every=AUTOTUNE_EVERY)`` on the
    sparse CSR path, 2,048 CSR frames over 64 connections, against the same
    server without a Tuner, in two modes: pipelined (2 replicas, async
    transport, as ``serving_sparse``) and serial (the batcher loop, where
    each batch's timings are folded before the next one starts). Two tuned
    servers run in each mode:

      - ``unstitched``: the Tuner's cost model declines every stitch, so
        the plan keeps the classifier's host finalize. Every reply equals
        the un-tuned server's byte for byte.
      - ``autotune``: the cost model as it comes. Once it is calibrated the
        planner may stitch the classifier's finalize onto the card
        (``plan()`` asks ``stitch_decision``, as the reference does), whose
        f32 probabilities differ from the host's f64 ones. Every reply
        equals the un-tuned server's byte for byte or, bit for bit, the
        probabilities of a fused model pinned stitched (``stitch=``) on the
        same rows; those stitched ones lie within the stage's declared
        ``finalize_tolerance`` (``STITCH_TOL``) of the host's.

    The ``tuner`` section of ``/_mmlspark/stats`` and the
    ``mmlspark_tuner_*`` families must be present. Logs requests/s,
    p50/p99 and the knobs applied; returns K3's launches under the tuned
    pipelined load."""
    from mmlspark_tpu_torch.core.costmodel import SegmentCostModel
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk
    from mmlspark_tpu_torch.io.binary import (FRAME_CONTENT_TYPE,
                                              encode_csr_columns, encode_frame)
    from mmlspark_tpu_torch.serving import serve_pipeline

    class Unstitched(SegmentCostModel):
        def stitch_decision(self, *args, **kwargs):
            return False

    label = "LightGBMClassificationModel"
    sel = rows[:AUTOTUNE_REQUESTS]
    frames = [encode_frame(encode_csr_columns(
        "features", np.array([0, len(r["indices"])]), r["indices"], r["values"],
        W_SPARSE)) for r in sel]
    hdr = {"Content-Type": FRAME_CONTENT_TYPE}
    ref = _mega_fused(model, 1, True, label)
    ref.set_tuning(stitch={label: True})
    want_stitched = [np.asarray(p, dtype=np.float64) for p in ref.transform(
        DataFrame.from_dict({"features": sel})).column("probability")]
    if not ref.fusion_stats().get("stitched"):
        fail("serving_autotune: the fused model pinned stitched did not stitch")
    launches = {}
    for mode, async_exec in (("pipelined", True), ("serial", False)):
        res = {}
        for name in ("untuned", "unstitched", "autotune"):
            fused = _mega_fused(model, 1, True, label)
            if name == "unstitched":
                fused.set_tuning(cost_model=Unstitched())
            srv = serve_pipeline(fused, "features", reply_col="probability",
                                 fused=True, async_exec=async_exec,
                                 replicas=2, http_mode="async",
                                 max_batch_size=256,
                                 autotune=name != "untuned",
                                 tune_every=AUTOTUNE_EVERY)
            with srv:
                gk.launches = 0
                t0 = time.perf_counter()
                replies = http_load(srv.address, frames, hdr, SERVE_CONNS)
                wall = time.perf_counter() - t0
                stats = json.loads(http_get(srv.address, "/_mmlspark/stats"))
                metrics = http_get(srv.address, "/_mmlspark/metrics").decode()
            res[name] = {"replies": replies, "wall": wall, "stats": stats,
                         "metrics": metrics, "launches": gk.launches,
                         "fused": fused}
        plain = res["untuned"]
        launches[mode] = res["autotune"]["launches"]
        same, stitched_equal, other, diffs = {}, 0, 0, []
        for name in ("unstitched", "autotune"):
            same[name] = sum(a[:2] == b[:2] for a, b in
                             zip(plain["replies"], res[name]["replies"]))
        for i, (a, b) in enumerate(zip(plain["replies"],
                                       res["autotune"]["replies"])):
            if a[:2] == b[:2] or b[0] != 200:
                continue
            got = np.asarray(json.loads(b[1]), dtype=np.float64)
            if np.array_equal(got.view(np.uint64),
                              want_stitched[i].view(np.uint64)):
                stitched_equal += 1
                diffs.append(float(np.abs(
                    got - np.asarray(json.loads(a[1]))).max()))
            else:
                other += 1
        row = {}
        for name, r in res.items():
            t = r["stats"].get("tuner") or {}
            row[name] = {
                "requests_per_s": len(frames) / r["wall"],
                "k3_launches": r["launches"],
                "bitwise_equal_untuned": same.get(name, len(frames)),
                "stitched": r["fused"].fusion_stats().get("stitched"),
                "knobs_applied": t.get("knobs"),
                "tuner": {k: t.get(k) for k in (
                    "epochs", "applies", "rollbacks", "calibrated",
                    "journal")} if t else None,
                "tuner_families": sorted({
                    line.split()[2] for line in r["metrics"].splitlines()
                    if line.startswith("# TYPE mmlspark_tuner_")}),
                "mega_k_max": r["fused"].mega_k_max,
                **latency_summary(r["replies"], r["stats"])}
        log({"phase": "serving_autotune", "mode": mode, "card": smi,
             "requests": len(frames), "every": AUTOTUNE_EVERY,
             "stitched_bitwise_pinned_stitched": stitched_equal,
             "neither": other,
             "stitched_max_abs_diff_to_host": max(diffs, default=0.0),
             **row})
        for name in ("unstitched", "autotune"):
            r = res[name]
            if sorted({x[0] for x in r["replies"]}) != [200]:
                fail(f"serving_autotune {mode} {name}: statuses "
                     f"{sorted({x[0] for x in r['replies']})}")
            if not row[name]["tuner"] or \
                    "mmlspark_tuner_epochs_total" not in row[name]["tuner_families"]:
                fail(f"serving_autotune {mode} {name}: tuner section "
                     f"{bool(row[name]['tuner'])}, families "
                     f"{row[name]['tuner_families']}")
        if same["unstitched"] != len(frames):
            fail(f"serving_autotune {mode}: {len(frames) - same['unstitched']} "
                 f"replies of the unstitched tuned server differ from the "
                 f"un-tuned server's")
        if other or max(diffs, default=0.0) > STITCH_TOL:
            fail(f"serving_autotune {mode}: {other} replies equal neither the "
                 f"un-tuned server's nor the pinned stitched model's; "
                 f"stitched max diff {max(diffs, default=None)}")
    return {"csr_gather": launches["pipelined"]}


def deposit_phase(torch, model, X, smi) -> None:
    """Slot-deposit staging on the card: the dense model's rows as f32
    per-row arrays (what the binary wire's frames decode to) through a
    fused transform with slot staging (pinned slots, filled on a thread)
    and without, then served as f32 frames both ways: the outputs and the
    replies bit for bit the copying path's, ``slot_deposits`` a batch and
    the fallback copies accounted. Logs both servers' requests/s and
    latencies, so that what the default (slots on) costs serving shows."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.io.binary import (FRAME_CONTENT_TYPE, decode_frame,
                                              encode_frame)
    from mmlspark_tpu_torch.serving import serve_pipeline

    frames = [encode_frame({"x": np.asarray(r, dtype=np.float32)}) for r in X]
    col = np.empty(len(X), dtype=object)
    for i, f in enumerate(frames):
        col[i] = decode_frame(f)["x"]
    df = DataFrame.from_dict({"features": col})
    out, summ, secs = {}, {}, {}
    for staging in (False, True):
        fused = FusedPipelineModel([model], cache=CompileCache(),
                                   slot_staging=staging)
        _raw(fused.transform(df))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[staging] = _raw(fused.transform(df))
        secs[staging] = time.perf_counter() - t0
        summ[staging] = fused.last_ingest_stats.summary()
        pool = fused.fusion_stats().get("slot_pool")
    replies, served_rate, served = {}, {}, {}
    for staging in (False, True):
        fused = FusedPipelineModel([model], cache=CompileCache(),
                                   slot_staging=staging)
        srv = serve_pipeline(fused, "features", reply_col="probability",
                             fused=True, async_exec=True, replicas=2,
                             http_mode="async", max_batch_size=256)
        with srv:
            t0 = time.perf_counter()
            replies[staging] = http_load(srv.address, frames[:DEPOSIT_FRAMES],
                                         {"Content-Type": FRAME_CONTENT_TYPE},
                                         SERVE_CONNS)
            served_rate[staging] = DEPOSIT_FRAMES / (time.perf_counter() - t0)
            served[staging] = json.loads(http_get(srv.address,
                                                  "/_mmlspark/stats"))
    same = bool(np.array_equal(out[True].view(np.uint64),
                               out[False].view(np.uint64)))
    same_replies = [a[:2] for a in replies[True]] == [a[:2] for a in replies[False]]
    s = summ[True]
    log({"phase": "deposit", "card": smi, "rows": len(X),
         "seconds": {"slots": secs[True], "copying": secs[False]},
         "bitwise_vs_copying": same, "replies_equal": same_replies,
         "ingest": {k: s.get(k) for k in (
             "n_batches", "slot_deposits", "fallback_copies", "slot_fill_s",
             "slot_transfer_s", "slot_overlap_ratio", "h2d_ms_per_batch")},
         "copying_ingest": {k: summ[False].get(k) for k in (
             "n_batches", "copied_batches", "h2d_ms_per_batch")},
         "slot_pool": pool, "served_ingest": served[True].get("ingest"),
         "served": {name: {"requests_per_s": served_rate[st],
                           **latency_summary(replies[st], served[st])}
                    for name, st in (("slots", True), ("copying", False))}})
    if not same or not same_replies:
        fail(f"deposit: slot staging changed the scores ({same}) or the "
             f"replies ({same_replies})")
    if s.get("slot_deposits") != s.get("n_batches") or "fallback_copies" not in s:
        fail(f"deposit: {s.get('slot_deposits')} deposits over "
             f"{s.get('n_batches')} batches, copies {s.get('fallback_copies')}")


# ---------------------------------------------------------------------------
# The image path: ResNet-50 (torchvision layout) through ImageFeaturizer and
# its training; the switch-MoE sequence model (K5-K7)
# ---------------------------------------------------------------------------

IMG_COUNT = 512         # tools/bench_image_e2e.py's images on an accelerator
IMG_SRC = 256           # their side; the featurizer resizes to the model's 224
IMG_SIZE = 224
IMG_BATCH = 128
IMG_CHECK_ROWS = 32     # gate (a): the card against the port on the CPU
IMG_SMALL_ROWS = 16     # gates (c) and (d)
IMG_FUSED_ROWS = 256    # gate (b): two batches
# gate (a) in bf16, per row: 1 - cosine, and max |card - CPU| over the row's
# max |value|. Both sides round every conv's and BatchNorm's output to bf16
# and sum in f32, in other orders (cuDNN, oneDNN): a sum near a rounding
# boundary lands on the other bf16 value (one ulp, 2^-8), and the layers
# after it carry that
IMG_BF16_COS_GAP = 1e-4
IMG_BF16_REL_DIFF = 2e-2
# gate (a) under matmul_precision("float32"): full-f32 convs on both sides
# (TF32 off on the card; TF32 rounds the operands to 2^-11)
IMG_F32_REL = 1e-4
RESNET_TRAIN_ROWS = 32
RESNET_TRAIN_STEPS = 5
RESNET_TRAIN_LR = 0.01
# resnet_train: step 1's f32 gradients, card against the port on the CPU.
# At this init they are ill-conditioned: scaling the input by (1 + 2^-23),
# one ulp, moves the CPU's own gradients by 2-3% (relative L2 per leaf: 2.4%
# median, 3.0% max on the 32 rows here), so the card is held to that
# sensitivity, measured in the same run, per leaf and at the median, times
# this factor. TF32 (operands rounded to 2^-11, ~1e4 ulps) would move them
# far past it
RESNET_GRAD_SENSITIVITY_RATIO = 2.0
# and the loss, a well-conditioned sum: card against CPU in f32
RESNET_LOSS_REL = 1e-5
MOE_EXPERTS = 8         # Switch-Base-8 (Fedus et al. 2021, "Switch Transformers")
MOE_CAPACITY = 1.5      # the reference's default capacity factor
MOE_TRAIN_STEPS = 10
MOE_CPU_ROWS = 2
# moe_main, card against CPU: the share of (token, layer) routings that
# agree; a near-tie of two f32 router logits may fall either way once K5's
# attention and the plain version's differ in the last bits
MOE_ROUTING_AGREE_MIN = 0.999


def write_bmp(path: str, img: np.ndarray) -> None:
    """A 24-bit BMP (bottom-up BGR rows, each padded to 4 bytes), as
    tools/bench_image_e2e.py writes its images."""
    import struct

    h, w, _ = img.shape
    row_pad = (4 - (w * 3) % 4) % 4
    data_size = (w * 3 + row_pad) * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 54 + data_size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                            2835, 2835, 0, 0))
        pad = b"\x00" * row_pad
        for row in img[::-1, :, ::-1]:
            f.write(row.tobytes() + pad)


def torchvision_resnet_state(torch, depth: int, classes: int, seed: int) -> dict:
    """A torchvision-layout resnet``depth`` state_dict from seeded tensors
    (torchvision is not installed, and no weights can be fetched): its key
    names and shapes, He-scaled OIHW convs, and BatchNorm with scale 1 +
    0.1 N, bias 0.1 N, running mean 0.2 N and running variance 0.5 + U."""
    from mmlspark_tpu_torch.models.resnet import _CONFIGS

    gen = torch.Generator().manual_seed(seed)
    kind, blocks = _CONFIGS[depth]
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.randn(cout, cin, k, k, generator=gen) \
            * (2.0 / (cin * k * k)) ** 0.5

    def bn(key, c):
        sd[key + ".weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[key + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[key + ".running_mean"] = 0.2 * torch.randn(c, generator=gen)
        sd[key + ".running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for i, n in enumerate(blocks):
        ch = 64 * 2 ** i
        for j in range(n):
            tk = f"layer{i + 1}.{j}"
            if kind == "bottleneck":
                out = ch * 4
                shapes = [(ch, in_ch, 1), (ch, ch, 3), (out, ch, 1)]
            else:
                out = ch
                shapes = [(ch, in_ch, 3), (ch, ch, 3)]
            for c, (co, ci, k) in enumerate(shapes, 1):
                conv(f"{tk}.conv{c}", co, ci, k)
                bn(f"{tk}.bn{c}", co)
            if (i > 0 and j == 0) or in_ch != out:
                conv(f"{tk}.downsample.0", out, in_ch, 1)
                bn(f"{tk}.downsample.1", out)
            in_ch = out
    sd["fc.weight"] = torch.randn(classes, in_ch, generator=gen) * in_ch ** -0.5
    sd["fc.bias"] = 0.1 * torch.randn(classes, generator=gen)
    return sd


def _features(df, col: str = "features") -> np.ndarray:
    return np.stack([np.asarray(v) for v in df.column(col)])


def _row_rel_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.reshape(len(a), -1).astype(np.float64)
    b = b.reshape(len(b), -1).astype(np.float64)
    return np.abs(a - b).max(1) / np.maximum(np.abs(b).max(1), 1e-30)


def image_main(torch, smi) -> None:
    """The north-star path at full width: 512 seeded 256x256 BMPs read by
    ``io.image.read_images`` and featurized by ``ImageFeaturizer(batchSize=
    128, cutOutputLayers=1, scaleFactor=1/255)`` over ResNet-50 (the
    torchvision layout, built by ``from_torch_resnet`` from a seeded
    state_dict) into 2048-d features. Logs images/s end to end (read,
    decode, resize, the forward), the host prep (decode, resize) against the
    device's forward time, peak memory and one traced batch's top device
    operations. Gates: (a) the first 32 images' features against the port
    on the CPU, per row, bf16 (``IMG_BF16_COS_GAP``,
    ``IMG_BF16_REL_DIFF``) and under ``matmul_precision("float32")``
    (``IMG_F32_REL``, cuDNN's TF32 flag left at PyTorch's default, on: the
    conv turns it off); (b) ``PipelineModel([ImageTransformer().resize(224,
    224).flip(1), featurizer]).fuse()`` bit for bit the unfused chain on 256
    images, no fallback (the resize in prepare, the flip and the forward on
    the device; a flip alone would meet 256x256 batches the backbone does
    not take and fall back); (c) ``cutOutputLayers=0`` (the 1000 logits)
    and 3 (layer3, 14x14x1024) finite, of those shapes; (d) the stage saved,
    loaded and run again bit for bit."""
    import os
    import tempfile

    from mmlspark_tpu_torch.core import profiling
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel, PipelineStage
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.image import ImageFeaturizer, ImageTransformer
    from mmlspark_tpu_torch.io.image import read_images
    from mmlspark_tpu_torch.models import from_torch_resnet, matmul_precision
    from mmlspark_tpu_torch.ops import image as imops
    from mmlspark_tpu_torch.parallel.ingest import PreprocessSpec
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    model = from_torch_resnet(torchvision_resnet_state(torch, 50, 1000, SEED))
    build_s = time.perf_counter() - t0

    def featurizer(**kw):
        kw.setdefault("batchSize", IMG_BATCH)
        return ImageFeaturizer(inputCol="image", outputCol="features",
                               scaleFactor=1 / 255, **kw).set_model(model)

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i in range(IMG_COUNT):
            write_bmp(os.path.join(tmp, f"img_{i:05d}.bmp"),
                      rng.integers(0, 256, (IMG_SRC, IMG_SRC, 3), dtype=np.uint8))
        gen_s = time.perf_counter() - t0
        feat = featurizer()
        # first batch: cuDNN's first calls at these shapes
        t0 = time.perf_counter()
        _features(feat.transform(read_images(tmp).limit(IMG_BATCH)))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        df = read_images(tmp, num_partitions=4)
        read_s = time.perf_counter() - t0
        feats = _features(feat.transform(df))
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ring = feat.last_ingest_stats.summary()
        # the host prep alone: decode (read_images) and the resize to 224
        t0 = time.perf_counter()
        imgs = [ImageSchema.to_array(r) for r in read_images(tmp).column("image")]
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = np.stack([imops.resize(a, IMG_SIZE, IMG_SIZE) for a in imgs])
        resize_s = time.perf_counter() - t0
    # the device alone: the featurizer's forward on staged uint8 batches
    spec = PreprocessSpec(scale=1 / 255)
    params = model.device_params(DEVICE)
    xb = torch.from_numpy(small[:IMG_BATCH]).to(DEVICE)

    def forward():
        return model.apply_taps(spec.apply_device(xb), ["avgpool"],
                                params=params)["avgpool"]

    batch_ms = time_ms(torch, forward, 5, 2)
    with profiling.trace() as prof:
        forward()
        torch.cuda.synchronize()
    busy = profiling.device_busy(prof, top=10, gaps=5)
    del prof
    log({"phase": "image_main", "card": smi, "images": IMG_COUNT,
         "model_build_seconds": build_s, "params": model.num_params(),
         "datagen_seconds": gen_s, "first_batch_seconds": warm_s,
         "e2e_seconds": e2e_s, "e2e_images_per_s": IMG_COUNT / e2e_s,
         "read_decode_seconds_in_e2e": read_s,
         "host_decode_seconds": decode_s, "host_resize_seconds": resize_s,
         "device_forward_ms_per_batch": batch_ms,
         "device_seconds": batch_ms * IMG_COUNT / IMG_BATCH / 1e3,
         "device_images_per_s": IMG_BATCH / (batch_ms / 1e3),
         "peak_device_gb": peak_gb, "features_shape": list(feats.shape),
         "ring": ring, "traced_batch": busy})
    if feats.shape != (IMG_COUNT, 2048) or not np.isfinite(feats).all():
        fail(f"image_main: features of shape {feats.shape} or not finite")
    order = np.argsort([str(p) for p in df.column("path")])
    feats = feats[order]
    first = small[:IMG_CHECK_ROWS]
    del small, imgs, xb

    # (a) the card against the port on the CPU, bf16 and f32
    structs = np.empty(len(first), dtype=object)
    structs[:] = [ImageSchema.make(a) for a in first]
    small_df = DataFrame([{"image": structs}])
    card = {}
    cpu = {}
    t0 = time.perf_counter()
    card["bf16"] = _features(featurizer().transform(small_df))
    with use_device("cpu"):
        cpu["bf16"] = _features(featurizer(batchSize=IMG_CHECK_ROWS).transform(small_df))
    tf32_flag = torch.backends.cudnn.allow_tf32
    with matmul_precision("float32"):
        card["f32"] = _features(featurizer().transform(small_df))
        with use_device("cpu"):
            cpu["f32"] = _features(featurizer(batchSize=IMG_CHECK_ROWS)
                                   .transform(small_df))
    cpu_s = time.perf_counter() - t0
    cos = 1.0 - row_cosines(card["bf16"], cpu["bf16"])
    rel = _row_rel_diff(card["bf16"], cpu["bf16"])
    rel32 = _row_rel_diff(card["f32"], cpu["f32"])
    # the e2e run's rows are these images (resized the same way) at batch 128
    same = bool(np.array_equal(card["bf16"], feats[:IMG_CHECK_ROWS]))
    log({"phase": "image_main", "gate": "a", "rows": IMG_CHECK_ROWS,
         "seconds": cpu_s, "bf16_cos_gap_max": float(cos.max()),
         "bf16_rel_diff_max": float(rel.max()),
         "f32_rel_diff_max": float(rel32.max()),
         "cudnn_allow_tf32_flag": tf32_flag,
         "flag_after": torch.backends.cudnn.allow_tf32,
         "card_rows_bitwise_e2e_rows": same})
    if cos.max() > IMG_BF16_COS_GAP or rel.max() > IMG_BF16_REL_DIFF:
        fail(f"image_main (a): bf16 features against the CPU: 1 - cosine "
             f"{cos.max()} (bound {IMG_BF16_COS_GAP}), max |d| over the row's "
             f"max {rel.max()} ({IMG_BF16_REL_DIFF})")
    if rel32.max() > IMG_F32_REL or torch.backends.cudnn.allow_tf32 != tf32_flag:
        fail(f"image_main (a): f32 features {rel32.max()} from the CPU's "
             f"(bound {IMG_F32_REL}) or the TF32 flag changed")

    # (b) fused against unfused
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(IMG_FUSED_ROWS):
            write_bmp(os.path.join(tmp, f"img_{i:05d}.bmp"),
                      rng.integers(0, 256, (IMG_SRC, IMG_SRC, 3), dtype=np.uint8))
        df = read_images(tmp, num_partitions=2)
    pm = PipelineModel([ImageTransformer().resize(IMG_SIZE, IMG_SIZE).flip(1),
                        featurizer()])
    t0 = time.perf_counter()
    want = _features(pm.transform(df))
    unfused_s = time.perf_counter() - t0
    fused = pm.fuse()
    _features(fused.transform(df))
    t0 = time.perf_counter()
    got = _features(fused.transform(df))
    fused_s = time.perf_counter() - t0
    stats = fused.fusion_stats()
    log({"phase": "image_main", "gate": "b", "rows": IMG_FUSED_ROWS,
         "unfused_seconds": unfused_s, "fused_seconds": fused_s,
         "fused_bitwise_unfused": bool(np.array_equal(got, want)),
         "segments": stats["segments"], "fallbacks": stats["fallbacks"]})
    if not np.array_equal(got, want) or stats["fallbacks"] \
            or [s["kind"] for s in stats["segments"]] != ["fused"]:
        fail("image_main (b): the fused featurizer is not the unfused chain "
             f"bit for bit on the device (fallbacks {stats['fallbacks']})")
    del pm, fused, got, want

    # (c) logits and a layer3 tap; (d) save -> load -> transform
    small_df = DataFrame([{"image": structs[:IMG_SMALL_ROWS]}])
    shapes = {}
    for cut in (0, 3):
        out = _features(featurizer(cutOutputLayers=cut).transform(small_df))
        shapes[cut] = list(out.shape[1:])
        if not np.isfinite(out).all():
            fail(f"image_main (c): cutOutputLayers={cut} gave non-finite values")
    stage = featurizer()
    want = _features(stage.transform(small_df))
    with tempfile.TemporaryDirectory() as tmp:
        stage.save(f"{tmp}/feat")
        loaded = PipelineStage.load(f"{tmp}/feat")
    got = _features(loaded.transform(small_df))
    log({"phase": "image_main", "gate": "c,d", "shapes": shapes,
         "loaded_class": type(loaded).__name__,
         "loaded_bitwise": bool(np.array_equal(got, want))})
    if shapes != {0: [1000], 3: [14, 14, 1024]}:
        fail(f"image_main (c): shapes {shapes}")
    if type(loaded) is not ImageFeaturizer or not np.array_equal(got, want):
        fail("image_main (d): the loaded stage is not the saved one bit for bit")
    torch.cuda.empty_cache()


def resnet_train(torch, smi) -> None:
    """ResNet-50 (the torchvision layout, 1000 classes) trained by
    ``models.training.run_train_loop`` for 5 steps of 32 seeded 224x224
    images (SGD 0.01, momentum 0.9), BatchNorm on its batch statistics.
    Gates: every BatchNorm's moving mean and variance change at every step;
    step 1 on the card against the port on the CPU from the same params and
    batch, both under ``matmul_precision("float32")`` (TF32 off for the
    convs and their backward): the loss within ``RESNET_LOSS_REL``, and the
    gradients (relative L2 per leaf, the largest and the median) within
    ``RESNET_GRAD_SENSITIVITY_RATIO`` times what scaling the input by (1 +
    2^-23) does to the CPU's own; the loss finite. Training runs under
    PyTorch's deterministic algorithms (the conv and max-pool backward
    included). Logs step ms and peak memory."""
    from mmlspark_tpu_torch.models import from_torch_resnet, matmul_precision
    from mmlspark_tpu_torch.models import training

    model = from_torch_resnet(torchvision_resnet_state(torch, 50, 1000, SEED + 1))
    opt = training.make_optimizer(learning_rate=RESNET_TRAIN_LR, momentum=0.9)
    params = training.params_of(model.module, DEVICE)
    state = training.TrainState(params, opt.init(params), 0)
    rng = np.random.default_rng(SEED + 2)
    batches = [{"x": (rng.integers(0, 256, (RESNET_TRAIN_ROWS, IMG_SIZE, IMG_SIZE, 3))
                      / 255.0).astype(np.float32),
                "y": rng.integers(0, 1000, RESNET_TRAIN_ROWS).astype(np.int32)}
               for _ in range(RESNET_TRAIN_STEPS)]
    step = training.make_train_step(model.module, opt)
    stats_names = [n for n in training._flatten(params)
                   if n.endswith((".mean", ".var"))]
    unchanged, losses, times = [], [], []

    def timed_step(st, batch):
        before = training._flatten(st.params)
        t0 = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        after = training._flatten(st.params)
        unchanged.append([n for n in stats_names
                          if torch.equal(before[n], after[n])])
        return st, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = training.run_train_loop(state, timed_step, batches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # step 1's loss and gradients, card against CPU, in f32; the CPU's own
    # gradients under a one-ulp change of the input
    nudged = dict(batches[0], x=(batches[0]["x"] * np.float32(1 + 2 ** -23)
                                 ).astype(np.float32))
    with matmul_precision("float32"):
        m_card, stats, card = training.loss_and_grads(model.module, params,
                                                      batches[0])
        cpu_params = training.params_of(model.module, "cpu")
        t0 = time.perf_counter()
        m_cpu, _, cpu = training.loss_and_grads(model.module, cpu_params,
                                                batches[0])
        cpu_s = time.perf_counter() - t0
        _, _, cpu_nudged = training.loss_and_grads(model.module, cpu_params,
                                                   nudged)

    def rel_l2(a, b) -> dict:
        fa, fb = training._flatten(a), training._flatten(b)
        out = {}
        for n, g in fb.items():
            ref = g.double()
            if ref.norm() > 0:          # BatchNorm's statistics: zero
                out[n] = ((fa[n].double().cpu() - ref).norm()
                          / ref.norm()).item()
        return out

    rel, sens = rel_l2(card, cpu), rel_l2(cpu_nudged, cpu)
    zero = [n for n, g in training._flatten(card).items()
            if n not in rel and bool(g.any())]
    worst = max(rel, key=rel.get)
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
        / abs(float(m_cpu["loss"]))
    ms = sorted(t * 1e3 for t in times)
    med_rel, med_sens = float(np.median(list(rel.values()))), \
        float(np.median(list(sens.values())))
    log({"phase": "resnet_train", "card": smi, "rows": RESNET_TRAIN_ROWS,
         "steps": res.steps_run, "params": model.num_params(),
         "first_step_ms": times[0] * 1e3, "median_step_ms": ms[len(ms) // 2],
         "images_per_s": RESNET_TRAIN_ROWS / (ms[len(ms) // 2] / 1e3),
         "peak_device_gb": peak_gb, "losses": losses,
         "batchnorm_layers": len(stats), "stats_leaves": len(stats_names),
         "unchanged_stats_per_step": [len(u) for u in unchanged],
         "cpu_grads_seconds": cpu_s, "loss_rel_vs_cpu": loss_rel,
         "grad_rel_l2_vs_cpu_max": rel[worst],
         "grad_rel_l2_vs_cpu_worst_leaf": worst,
         "grad_rel_l2_vs_cpu_median": med_rel,
         "cpu_one_ulp_sensitivity_max": max(sens.values()),
         "cpu_one_ulp_sensitivity_median": med_sens,
         "fc_kernel_rel_vs_cpu": rel["fc.kernel"]})
    if any(unchanged):
        fail(f"resnet_train: BatchNorm statistics did not move: {unchanged}")
    if len(stats) != 53 or not np.isfinite(losses).all():
        fail(f"resnet_train: {len(stats)} BatchNorm layers wrote statistics "
             f"(53 expected) or the loss is not finite ({losses})")
    ratio = RESNET_GRAD_SENSITIVITY_RATIO
    if loss_rel > RESNET_LOSS_REL or zero or rel[worst] > ratio * max(sens.values()) \
            or med_rel > ratio * med_sens:
        fail(f"resnet_train: step 1 against the CPU: loss {loss_rel} (bound "
             f"{RESNET_LOSS_REL}); gradients max {rel[worst]} ({worst}) and "
             f"median {med_rel} against {ratio} x the CPU's one-ulp "
             f"sensitivity {max(sens.values())} / {med_sens}; nonzero "
             f"gradients where the CPU's are zero: {zero}")
    del model, state, res, card, cpu, cpu_nudged, params, cpu_params
    torch.cuda.empty_cache()


def moe_model(torch):
    """The reference's sequence-benchmark model (``tools/bench_seq.py:41``:
    dim 512, depth 4, 8 heads, vocab 32,000) at seq_len 2048 with every
    block's FFN a top-1 switch MoE of 8 experts (hidden 2048, capacity
    factor 1.5), and a 16-class per-token head: ``Embed``,
    ``transformer_block(moe_experts=8)`` x 4, ``ln_f``, ``head`` (the
    reference's ``transformer_encoder`` takes no ``moe_experts``)."""
    from mmlspark_tpu_torch.models import (Dense, Embed, FunctionModel,
                                           LayerNorm, Sequential,
                                           transformer_block)

    layers = [("embed", Embed(SEQ_VOCAB, SEQ_DIM))]
    layers += [(f"block{i}", transformer_block(
        SEQ_DIM, SEQ_HEADS, moe_experts=MOE_EXPERTS,
        moe_capacity_factor=MOE_CAPACITY)) for i in range(SEQ_DEPTH)]
    layers += [("ln_f", LayerNorm()), ("head", Dense(TRAIN_CLASSES))]
    module = Sequential(layers, name="moe_encoder")
    module.init(torch.Generator().manual_seed(0), (SEQ_LEN,))
    return FunctionModel(module, (SEQ_LEN,),
                         [n for n, _ in reversed(layers)], "moe_encoder")


class PinnedRouting:
    """Records each MoE layer's discrete routing in one forward (every
    token's expert and capacity slot: ``MoE.routing``'s expert and dispatch)
    and replays it in another, the gate taken from the replaying side's own
    router probabilities at the recorded expert (the same value and
    gradient as ``amax`` where the experts agree). Two runs then differ in
    their arithmetic only, not in where tokens go: a near-tie of two router
    logits that falls the other way moves a token to another expert, and
    the capacity slots of the tokens after it, a jump no tolerance on the
    arithmetic covers."""

    def __init__(self, model):
        self.moes = [model.module.get_submodule(f"block{i}.mlp.body.moe")
                     for i in range(SEQ_DEPTH)]
        self.saved = {}

    def _recording(self, i, moe):
        method = type(moe).routing

        def routing(x):
            expert, gate, dispatch = method(moe, x)
            self.saved[i] = (expert.detach(), dispatch.detach())
            return expert, gate, dispatch
        return routing

    def _replaying(self, i, moe):
        import torch

        def routing(x):
            expert, dispatch = (t.to(x.device) for t in self.saved[i])
            probs = torch.softmax(torch.matmul(x.to(torch.float32), moe.router),
                                  dim=-1)
            return expert, probs.gather(-1, expert[..., None])[..., 0], dispatch
        return routing

    def record(self):
        return self._patched(self._recording)

    def replay(self):
        return self._patched(self._replaying)

    def routes(self) -> tuple:
        """([depth, B, T] experts, [depth, B, T] kept) of the last record."""
        return (np.stack([self.saved[i][0].cpu().numpy()
                          for i in range(len(self.moes))]),
                np.stack([self.saved[i][1].sum(dim=(2, 3)).cpu().numpy() > 0
                          for i in range(len(self.moes))]))

    @contextlib.contextmanager
    def _patched(self, make):
        for i, moe in enumerate(self.moes):
            moe.routing = make(i, moe)      # shadows the method on the instance
        try:
            yield
        finally:
            for moe in self.moes:
                del moe.routing


def _moe_taps(model, x) -> tuple:
    """Every MoE layer's input ([depth] of [B, T, D]) and the output, from
    one forward of the model (its own parameters, on ``x``'s device)."""
    taps = [f"block{i}/mlp/body/ln" for i in range(SEQ_DEPTH)]
    acts = model.apply_taps(x, taps + [None])
    return [acts[t] for t in taps], acts[None].float().cpu().numpy()


def _routes_of(model, inputs) -> tuple:
    """Each MoE layer's routing ([depth, B, T] experts and kept) of the
    given layer inputs, by the model's own MoE modules."""
    experts, kept = [], []
    for i, x in enumerate(inputs):
        moe = model.module.get_submodule(f"block{i}.mlp.body.moe")
        e, _, d = moe.routing(x)
        experts.append(e.cpu().numpy())
        kept.append(d.sum(dim=(2, 3)).cpu().numpy() > 0)
    return np.stack(experts), np.stack(kept)


def _leaf_rel(a, b) -> dict:
    """Per leaf, the relative L2 distance of gradient tree ``a`` from
    ``b``."""
    from mmlspark_tpu_torch.models import training

    fa, fb = training._flatten(a), training._flatten(b)
    return {n: ((fa[n].double() - g.double()).norm()
                / g.double().norm().clamp_min(1e-30)).item()
            for n, g in fb.items()}


def _exact_attention(q, k, v, causal=False, q_offset=0, k_offset=0):
    """Attention in f64 from the bf16 q, k, v, rounded once to v's dtype:
    the reference both K5-K7 and the plain version approximate."""
    import math

    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) \
        / math.sqrt(q.shape[-1])
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.arange(tk, device=q.device)[None, :] \
            > torch.arange(tq, device=q.device)[:, None]
        s = s.masked_fill(mask, -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.double())
    return o.to(v.dtype)


def moe_grads(torch, model, params, batch, pin) -> dict:
    """Step 1's gradients three ways on the card, the routing of the first
    pinned for the other two: through K5-K7, through plain attention
    (``MMLSPARK_TPU_NO_FLASH=1``, autograd) and through exact attention
    (``_exact_attention``, autograd in f64)."""
    import os

    from mmlspark_tpu_torch.models import attention, training

    out = {}
    with pin.record():
        out["kernels"] = training.loss_and_grads(model.module, params, batch)[2]
    os.environ["MMLSPARK_TPU_NO_FLASH"] = "1"
    try:
        with pin.replay():
            out["plain"] = training.loss_and_grads(model.module, params, batch)[2]
    finally:
        del os.environ["MMLSPARK_TPU_NO_FLASH"]
    dense = attention.dense_attention
    attention.dense_attention = _exact_attention
    try:
        with pin.replay():
            out["exact"] = training.loss_and_grads(model.module, params, batch)[2]
    finally:
        attention.dense_attention = dense
    return out


def moe_main(torch, smi) -> dict:
    """The switch-MoE sequence model (``moe_model``) on the card. Transform:
    ``DNNModel(batchSize=64)`` over 256 rows of seeded token ids (4 batches),
    K5 launched once a layer a batch (16, counted). Train: 10 steps of
    ``run_train_loop`` at 8 x 2048 tokens (tag = token // 2000, SGD 0.01,
    momentum 0.9), K5, K6 and K7 four times a step each (counted); the mean
    loss of the last 3 steps below the first 3's; step 1's gradients through
    K5-K7 no further from exact attention's (f64, autograd) than
    ``F64_RATIO_MAX`` times the plain version's (relative L2 per leaf, the
    largest and the median), the routing pinned to the kernels' run
    (``PinnedRouting``; their distance from plain attention's gradients,
    pinned and not, is logged: at this init the attention projections'
    gradients are small differences, which bf16's roundings move by a few
    percent either way). Card against CPU on 2 rows: the CPU's MoE layers
    route the card's own MoE inputs as the card did (expert and slot) for
    at least ``MOE_ROUTING_AGREE_MIN`` of the tokens of every layer (f32
    near-ties apart), and with the card's routing pinned the CPU's logits
    are within ``COS_GAP_MAX`` (1 - cosine per row) of the card's. Logs the
    unpinned runs' routing agreement layer by layer (K5's and the plain
    version's bf16 attention differ in the last bits, so a near-tie of two
    router logits may fall either way and the flip changes that token's
    later layers and the slots of the tokens after it), tokens/s of both
    paths, the share of tokens dropped past capacity and peak memory.
    Returns the K5-K7 launches of each path."""
    import os

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, training

    model = moe_model(torch)
    ids = np.random.default_rng(SEED + 3).integers(0, SEQ_VOCAB,
                                                   (SEQ_ROWS, SEQ_LEN))
    df = DataFrame.from_dict({"tokens": ids}, num_partitions=2)
    stage = DNNModel(inputCol="tokens", outputCol="logits",
                     batchSize=SEQ_BATCH).set_model(model)
    stage.transform(DataFrame.from_dict({"tokens": ids[:SEQ_BATCH]}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attn_launches()
    t0 = time.perf_counter()
    out = np.stack(list(stage.transform(df).column("logits")))
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    transform = read_attn_launches()
    peak_transform = torch.cuda.max_memory_allocated() / 1e9
    if out.shape != (SEQ_ROWS, SEQ_LEN, TRAIN_CLASSES) or not np.isfinite(out).all():
        fail(f"moe_main: transform output of shape {out.shape} or not finite")
    if transform["flash_attn"] != SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH \
            or transform["flash_attn_bwd_dkv"] or transform["flash_attn_bwd_dq"]:
        fail(f"moe_main: the transform launched {transform}, expected K5 "
             f"{SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH} times and K6/K7 never")
    del out

    # card against CPU
    x = torch.from_numpy(ids[:MOE_CPU_ROWS])
    pin = PinnedRouting(model)
    model.module.to(DEVICE)
    with torch.inference_mode(), pin.record():
        card_in, card_out = _moe_taps(model, x.to(DEVICE))
    card_e, card_k = pin.routes()
    card_in = [t.cpu() for t in card_in]
    model.module.to("cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        same_e, same_k = _routes_of(model, card_in)
        free_in, _ = _moe_taps(model, x)
        free_e, free_k = _routes_of(model, free_in)
        with pin.replay():
            cpu_in, cpu_out = _moe_taps(model, x)
    cpu_s = time.perf_counter() - t0
    same = ((same_e == card_e) & (same_k == card_k)).mean(axis=(1, 2))
    free = ((free_e == card_e) & (free_k == card_k)).mean(axis=(1, 2))
    gap = 1.0 - row_cosines(card_out, cpu_out)
    with torch.no_grad():
        router_rel = max(
            (torch.matmul(a.float(), m.router) - torch.matmul(b.float(), m.router))
            .abs().max().item() / torch.matmul(b.float(), m.router).abs().max().item()
            for a, b, m in zip(card_in, cpu_in, pin.moes))
    dropped = 1.0 - card_k.mean()
    del card_in, free_in, cpu_in

    # training
    opt = training.make_optimizer(learning_rate=TRAIN_LR, momentum=0.9)
    params = training.params_of(model.module, DEVICE)
    state = training.TrainState(params, opt.init(params), 0)
    step = training.make_train_step(model.module, opt)
    batches = train_batches(MOE_TRAIN_STEPS, SEED + 4, TRAIN_ROWS, SEQ_LEN,
                            SEQ_VOCAB, SEQ_VOCAB // TRAIN_CLASSES)
    unpinned = grads_rel_l2(torch, model.module, params, batches[0])
    grads = moe_grads(torch, model, params, batches[0], pin)
    rel = _leaf_rel(grads["kernels"], grads["plain"])
    err_k = _leaf_rel(grads["kernels"], grads["exact"])
    err_p = _leaf_rel(grads["plain"], grads["exact"])
    del grads
    losses, times = [], []

    def timed_step(st, batch):
        t0 = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        return st, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attn_launches()
    training.run_train_loop(state, timed_step, batches)
    torch.cuda.synchronize()
    train = read_attn_launches()
    ms = sorted(t * 1e3 for t in times)
    step_ms = ms[len(ms) // 2]
    worst = max(rel, key=rel.get)
    log({"phase": "moe_main", "card": smi, "experts": MOE_EXPERTS,
         "capacity_factor": MOE_CAPACITY, "params": model.num_params(),
         "transform_rows": SEQ_ROWS, "transform_seconds": transform_s,
         "transform_tokens_per_s": SEQ_ROWS * SEQ_LEN / transform_s,
         "transform_launches": transform,
         "transform_peak_device_gb": peak_transform,
         "dropped_share": float(dropped),
         "dropped_share_per_layer": [float(1.0 - k.mean()) for k in card_k],
         "cpu_rows": MOE_CPU_ROWS, "cpu_seconds": cpu_s,
         "routing_same_inputs_agree_per_layer": same.tolist(),
         "routing_unpinned_agree_per_layer": free.tolist(),
         "pinned_cos_gap_max": float(gap.max()),
         "pinned_router_logits_rel_max": router_rel,
         "train_steps": MOE_TRAIN_STEPS, "train_rows": TRAIN_ROWS,
         "train_first_step_ms": times[0] * 1e3, "train_median_step_ms": step_ms,
         "train_tokens_per_s": TRAIN_ROWS * SEQ_LEN / (step_ms / 1e3),
         "train_peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
         "train_launches": train, "losses": losses,
         "grad_rel_l2_vs_plain_pinned_max": rel[worst],
         "grad_rel_l2_vs_plain_pinned_worst": worst,
         "grad_err_vs_exact_kernels_max": max(err_k.values()),
         "grad_err_vs_exact_kernels_median": float(np.median(list(err_k.values()))),
         "grad_err_vs_exact_kernels_worst": max(err_k, key=err_k.get),
         "grad_err_vs_exact_plain_max": max(err_p.values()),
         "grad_err_vs_exact_plain_median": float(np.median(list(err_p.values()))),
         "grad_rel_l2_vs_plain_unpinned_max": max(unpinned.values()),
         "grad_rel_l2_vs_plain_unpinned_worst": max(unpinned, key=unpinned.get)})
    if same.min() < MOE_ROUTING_AGREE_MIN or gap.max() > COS_GAP_MAX:
        fail(f"moe_main: card against CPU: on the same inputs the routing "
             f"agrees on {same.tolist()} of the tokens (bound "
             f"{MOE_ROUTING_AGREE_MIN}); with it pinned, 1 - cosine "
             f"{gap.max()} (bound {COS_GAP_MAX})")
    want = SEQ_DEPTH * MOE_TRAIN_STEPS
    if any(v != want for v in train.values()):
        fail(f"moe_main: training launched {train}, expected {want} each")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first or not np.isfinite(losses).all():
        fail(f"moe_main: the loss did not fall: {losses}")
    ek, ep = max(err_k.values()), max(err_p.values())
    mk, mp = float(np.median(list(err_k.values()))), \
        float(np.median(list(err_p.values())))
    if ek > F64_RATIO_MAX * ep or mk > F64_RATIO_MAX * mp:
        fail(f"moe_main: step 1's gradients through K5-K7 are {ek} (max) / "
             f"{mk} (median) from exact attention's, the plain version's "
             f"{ep} / {mp} (bound {F64_RATIO_MAX} x; routing pinned)")
    del model, stage, state, params
    torch.cuda.empty_cache()
    return {"moe_main.transform": transform, "moe_main.train": train}


# ---------------------------------------------------------------- ONNX, VW

ONNX_COS_GAP = 1e-5     # onnx_main: 1 - cosine, imported vs native, f32
# onnx_multi_input: google-research/bert uncased_L-12_H-768_A-12, 128 tokens
BERT_VOCAB = 30_522
BERT_HIDDEN = 768
BERT_HEADS = 12
BERT_FFN = 3072
BERT_LAYERS = 12
BERT_SEQ = 128
BERT_ROWS = 1024
BERT_BATCH = 64
BERT_CHECK_ROWS = 16
BERT_CPU_REL = 1e-4     # card against the port on the CPU, f32, of max |x|
# vw_main: tools/bench_vw.py's accelerator point, shaped like Criteo's
# Display Advertising Challenge (13 integer and 26 categorical columns)
VW_ROWS = 200_000
VW_BITS = 18
VW_INT_COLS = 13
VW_CAT_COLS = 26
VW_PREFIX = 20_000
VW_RTOL = 1e-3          # the reference's bound between its two engines
VW_ATOL = 2e-4          # (tests/test_vw.py:453)
VW_PREDICT_REL = 1e-6   # transform against the host f64 dot, of sum |w v|


def bert_onnx(vocab: int, hidden: int, heads: int, ffn: int, layers: int,
              seq: int, seed: int) -> bytes:
    """A BERT-shaped encoder written as an ONNX graph with the port's proto
    writer, from seeded weights (N(0, 0.02), LayerNorm scale 1 and bias 0).
    Two graph inputs, ``input_ids`` (int64) and ``attention_mask`` (int64,
    1 for a token, 0 for padding): word embeddings (Gather) plus position
    embeddings, LayerNormalization (eps 1e-12), per layer MatMul/Softmax
    self-attention with the additive mask ((1 - mask) * -10000), the output
    projection, a residual and LayerNormalization, and a Gelu FFN with its
    residual and LayerNormalization. The output is the first token's
    hidden state, [B, hidden]."""
    from mmlspark_tpu_torch.onnx import proto as P

    rng = np.random.default_rng(seed)
    dh = hidden // heads
    nodes, inits = [], []

    def init(name, arr):
        inits.append(P.make_tensor(name, np.ascontiguousarray(arr)))
        return name

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(0.02))

    def node(op, ins, out, **attrs):
        nodes.append(P.make_node(op, ins, [out], name=out, **attrs))
        return out

    def layer_norm(x, key):
        s = init(f"{key}.scale", np.ones(hidden, np.float32))
        b = init(f"{key}.bias", np.zeros(hidden, np.float32))
        return node("LayerNormalization", [x, s, b], f"{key}", axis=-1,
                    epsilon=1e-12)

    def dense(x, key, d_in, d_out):
        w = init(f"{key}.w", normal(d_in, d_out))
        b = init(f"{key}.b", np.zeros(d_out, np.float32))
        return node("Add", [node("MatMul", [x, w], f"{key}.matmul"), b],
                    f"{key}")

    init("heads_shape", np.asarray([0, 0, heads, dh], np.int64))
    init("hidden_shape", np.asarray([0, 0, hidden], np.int64))
    init("mask_axes", np.asarray([1, 2], np.int64))
    init("one", np.asarray(1.0, np.float32))
    init("neg", np.asarray(-10000.0, np.float32))
    init("scale", np.asarray(1.0 / np.sqrt(dh), np.float32))
    init("first", np.asarray(0, np.int64))
    init("token_axis", np.asarray([1], np.int64))
    word = init("embeddings.word", normal(vocab, hidden))
    pos = init("embeddings.position", normal(seq, hidden))
    x = node("Gather", [word, "input_ids"], "embeddings.lookup", axis=0)
    x = node("Add", [x, pos], "embeddings.sum")
    x = layer_norm(x, "embeddings.ln")
    m = node("Cast", ["attention_mask"], "mask.float", to=1)
    m = node("Sub", ["one", m], "mask.inv")
    m = node("Mul", [m, "neg"], "mask.add")
    m = node("Unsqueeze", [m, "mask_axes"], "mask.b11t")
    for li in range(layers):
        key = f"layer{li}"
        heads_of = {}
        for proj, perm in (("q", [0, 2, 1, 3]), ("k", [0, 2, 3, 1]),
                           ("v", [0, 2, 1, 3])):
            y = dense(x, f"{key}.{proj}", hidden, hidden)
            y = node("Reshape", [y, "heads_shape"], f"{key}.{proj}.heads")
            heads_of[proj] = node("Transpose", [y], f"{key}.{proj}.t",
                                  perm=perm)
        sc = node("MatMul", [heads_of["q"], heads_of["k"]], f"{key}.scores")
        sc = node("Mul", [sc, "scale"], f"{key}.scaled")
        sc = node("Add", [sc, m], f"{key}.masked")
        pr = node("Softmax", [sc], f"{key}.softmax", axis=-1)
        ctx = node("MatMul", [pr, heads_of["v"]], f"{key}.context")
        ctx = node("Transpose", [ctx], f"{key}.context.t", perm=[0, 2, 1, 3])
        ctx = node("Reshape", [ctx, "hidden_shape"], f"{key}.context.merge")
        a = dense(ctx, f"{key}.attn_out", hidden, hidden)
        x = layer_norm(node("Add", [x, a], f"{key}.attn_res"), f"{key}.ln1")
        h = node("Gelu", [dense(x, f"{key}.ffn1", hidden, ffn)],
                 f"{key}.gelu")
        f = dense(h, f"{key}.ffn2", ffn, hidden)
        x = layer_norm(node("Add", [x, f], f"{key}.ffn_res"), f"{key}.ln2")
    # the writer stores a 0-d index as [1] (np.ascontiguousarray), so the
    # gather keeps a length-1 token axis: squeezed
    out = node("Squeeze", [node("Gather", [x, "first"], "cls.gather", axis=1),
                           "token_axis"], "cls")
    return P.make_model(
        nodes, inits,
        [P.make_value_info("input_ids", [None, seq], P.DT_INT64),
         P.make_value_info("attention_mask", [None, seq], P.DT_INT64)],
        [P.make_value_info(out, [None, hidden])], graph_name="bert_encoder")


def bert_inputs(n: int, seq: int, vocab: int, seed: int):
    """Seeded token ids and masks: each sequence a [CLS]-like id 101, then
    uniform ids past the vocabulary's first 1,000 (its specials; a tenth of
    it in a small vocabulary) up to a length uniform in [seq / 8, seq],
    zeros after."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(max(1, seq // 8), seq + 1, n)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(min(1000, vocab // 10), vocab, (n, seq)) \
        .astype(np.int64) * mask
    ids[:, 0] = 101 % vocab
    return ids, mask


def onnx_main(torch, smi) -> None:
    """ResNet-50 (the torchvision layout, image_main's seeded state_dict)
    exported with the port's ``export_onnx`` and imported back with
    ``import_onnx`` (a ``GraphModule``, NCHW), then ``ImageFeaturizer(
    batchSize=128, cutOutputLayers=1)`` over image_main's 512 seeded
    256x256 BMPs on the card. Gate: every row's 1 - cosine against the
    native module's features on the same images, both f32 (TF32 off),
    within ``ONNX_COS_GAP``. Logs images/s, the forward's ms a batch, peak
    memory, and the export and import seconds."""
    import os
    import tempfile

    from mmlspark_tpu_torch.image import ImageFeaturizer
    from mmlspark_tpu_torch.io.image import read_images
    from mmlspark_tpu_torch.models import from_torch_resnet, matmul_precision
    from mmlspark_tpu_torch.onnx import export_onnx, import_onnx
    from mmlspark_tpu_torch.parallel.ingest import PreprocessSpec

    model = from_torch_resnet(torchvision_resnet_state(torch, 50, 1000, SEED))
    t0 = time.perf_counter()
    blob = export_onnx(model.module, None, (IMG_SIZE, IMG_SIZE, 3),
                       name="resnet50")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = import_onnx(blob)
    import_s = time.perf_counter() - t0

    def featurizer(m):
        return ImageFeaturizer(inputCol="image", outputCol="features",
                               scaleFactor=1 / 255, batchSize=IMG_BATCH,
                               cutOutputLayers=1).set_model(m)

    rng = np.random.default_rng(0)     # image_main's images
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(IMG_COUNT):
            write_bmp(os.path.join(tmp, f"img_{i:05d}.bmp"),
                      rng.integers(0, 256, (IMG_SRC, IMG_SRC, 3), dtype=np.uint8))
        df = read_images(tmp, num_partitions=4).cache()
        feat = featurizer(imported)
        _features(feat.transform(df.limit(IMG_BATCH)))   # cuDNN's first calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = _features(feat.transform(df))
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with matmul_precision("float32"):
            want = _features(featurizer(model).transform(df))
    node = imported.layer_names[1]
    spec = PreprocessSpec(scale=1 / 255, transpose=(2, 0, 1))
    params = imported.device_params(DEVICE)
    xb = torch.from_numpy(rng.integers(0, 256, (IMG_BATCH, IMG_SIZE, IMG_SIZE, 3),
                                       dtype=np.uint8)).to(DEVICE)
    batch_ms = time_ms(torch, lambda: imported.apply_taps(
        spec.apply_device(xb), [node], params=params)[node], 5, 2)
    gap = 1.0 - row_cosines(got, want)
    log({"phase": "onnx_main", "card": smi, "images": IMG_COUNT,
         "onnx_bytes": len(blob), "nodes": len(imported.module.nodes),
         "export_seconds": export_s, "import_seconds": import_s,
         "e2e_seconds": e2e_s, "e2e_images_per_s": IMG_COUNT / e2e_s,
         "forward_ms_per_batch": batch_ms,
         "device_images_per_s": IMG_BATCH / (batch_ms / 1e3),
         "peak_device_gb": peak_gb, "cut": node,
         "features_shape": list(got.shape),
         "cos_gap_max": float(gap.max()),
         "rel_diff_max": float(_row_rel_diff(got, want).max())})
    if got.shape != (IMG_COUNT, 2048) or not np.isfinite(got).all():
        fail(f"onnx_main: features of shape {got.shape} or not finite")
    if gap.max() > ONNX_COS_GAP:
        fail(f"onnx_main: imported ResNet-50's features against the native "
             f"module's: 1 - cosine {gap.max()} (bound {ONNX_COS_GAP})")
    del blob, imported, model, params, xb
    torch.cuda.empty_cache()


def onnx_multi_input(torch, smi) -> None:
    """``bert_onnx`` at BERT-base's widths (vocab 30,522, hidden 768, 12
    heads, FFN 3,072, 12 layers, 128 tokens) imported with ``import_onnx``
    and served through ``DNNModel(batchSize=64)`` with ``setFeedDict`` over
    two columns (``input_ids``, ``attention_mask``) on 1,024 seeded
    sequences. Gate: the card's output for the first 16 against the port
    on the CPU, f32, within ``BERT_CPU_REL`` of the max |x|. Logs
    sequences/s and peak memory."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel
    from mmlspark_tpu_torch.onnx import import_onnx
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    blob = bert_onnx(BERT_VOCAB, BERT_HIDDEN, BERT_HEADS, BERT_FFN,
                     BERT_LAYERS, BERT_SEQ, SEED)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = import_onnx(blob)
    import_s = time.perf_counter() - t0
    ids, mask = bert_inputs(BERT_ROWS, BERT_SEQ, BERT_VOCAB, SEED)
    df = DataFrame.from_dict({"ids": list(ids), "mask": list(mask)},
                             num_partitions=2)

    def stage(batch):
        return DNNModel(outputCol="emb", batchSize=batch).set_model(
            model).set_feed_dict({"input_ids": "ids", "attention_mask": "mask"})

    dnn = stage(BERT_BATCH)
    dnn.transform(df.limit(BERT_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _features(dnn.transform(df), "emb")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    small = df.limit(BERT_CHECK_ROWS)
    card = _features(stage(BERT_CHECK_ROWS).transform(small), "emb")
    t0 = time.perf_counter()
    with use_device("cpu"):
        cpu = _features(stage(BERT_CHECK_ROWS).transform(small), "emb")
    cpu_s = time.perf_counter() - t0
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    log({"phase": "onnx_multi_input", "card": smi, "sequences": BERT_ROWS,
         "tokens": BERT_ROWS * BERT_SEQ, "layers": BERT_LAYERS,
         "onnx_bytes": len(blob), "build_seconds": build_s,
         "import_seconds": import_s, "seconds": secs,
         "sequences_per_s": BERT_ROWS / secs, "peak_device_gb": peak_gb,
         "output_shape": list(out.shape), "cpu_rows": BERT_CHECK_ROWS,
         "cpu_seconds": cpu_s, "card_vs_cpu_rel": rel,
         "e2e_vs_check_rows_max_diff": float(
             np.abs(out[:BERT_CHECK_ROWS] - card).max())})
    if out.shape != (BERT_ROWS, BERT_HIDDEN) or not np.isfinite(out).all():
        fail(f"onnx_multi_input: output of shape {out.shape} or not finite")
    if rel > BERT_CPU_REL:
        fail(f"onnx_multi_input: card against CPU {rel} of max |x| (bound "
             f"{BERT_CPU_REL})")
    del blob, model
    torch.cuda.empty_cache()


def criteo_like(n: int, seed: int):
    """Seeded columns shaped like Criteo's display-ads rows: I1-I13 counts
    (log-normal, 8% missing, some zeros; a count above 2 as floor(ln(v)^2),
    the Criteo competition winners' transform) and C1-C26 categorical ids (8 hex
    digits, Zipf-drawn from per-column vocabularies of 10 to 100,000
    values, 3% missing); the label (about 25% positive) from a seeded
    logistic model over the columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    logit = np.full(n, -1.4)
    for j in range(VW_INT_COLS):
        v = np.floor(rng.lognormal(1.0 + 0.2 * j, 1.2, n)).astype(np.int64)
        v[rng.random(n) < 0.1] = 0
        # the Criteo winners' transform of a count (v > 2: floor(ln(v)^2)),
        # as VW pipelines feed them
        v = np.where(v > 2, np.floor(np.log(np.maximum(v, 1)) ** 2),
                     v).astype(np.int64)
        logit += rng.normal(0, 0.15) * np.sqrt(v)
        col = np.empty(n, dtype=object)
        col[:] = list(v)
        col[rng.random(n) < 0.08] = None
        cols[f"I{j + 1}"] = col
    for j in range(VW_CAT_COLS):
        size = int(10 * 10 ** (4 * j / (VW_CAT_COLS - 1)))
        codes = np.minimum(rng.zipf(1.3, n) - 1, size - 1)
        effect = rng.normal(0, 0.4, size)
        logit += effect[codes]
        salt = int(rng.integers(0, 2 ** 31))
        vocab = np.array([f"{(k * 2654435761 + salt) & 0xFFFFFFFF:08x}"
                          for k in range(size)], dtype=object)
        col = vocab[codes]
        col[rng.random(n) < 0.03] = None
        cols[f"C{j + 1}"] = col
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return cols


def vw_main(torch, smi) -> tuple:
    """The VW path at tools/bench_vw.py's accelerator point: 200,000
    Criteo-shaped rows through ``VowpalWabbitFeaturizer(numBits=18)``, then
    ``VowpalWabbitClassifier`` (logistic) fit on its default route (the
    native C++ pass) and transformed on the card; then one FTRL pass and
    one adaptive pass with ``MMLSPARK_TPU_NATIVE_VW=0``, both through
    ``vw_scan`` on the card (its launches counted from 0 around them).
    Gates: (a) ``vw_scan`` against its plain version on the card on a
    20,000-example prefix (adaptive and FTRL), and the adaptive kernel pass
    against the native pass, within ``VW_RTOL``/``VW_ATOL``; (b) two kernel
    calls bit for bit; (c) the transform against the host f64 dot within
    ``VW_PREDICT_REL`` of each row's sum |w v|. Returns vw_scan's row of
    the kernels line and the featurized dataset (mesh_vw's input)."""
    import os

    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.vw import (LearnerConfig, SparseDataset,
                                       VowpalWabbitClassifier,
                                       VowpalWabbitFeaturizer)
    from mmlspark_tpu_torch.vw import learner as vl
    from mmlspark_tpu_torch.vw import scan_kernel as vs

    t0 = time.perf_counter()
    cols = criteo_like(VW_ROWS, SEED)
    gen_s = time.perf_counter() - t0
    in_cols = [f"I{j + 1}" for j in range(VW_INT_COLS)] + \
        [f"C{j + 1}" for j in range(VW_CAT_COLS)]
    df = DataFrame.from_dict(cols, num_partitions=4)
    vs.launches = 0
    t0 = time.perf_counter()
    feats = VowpalWabbitFeaturizer(inputCols=in_cols, outputCol="features",
                                   numBits=VW_BITS).transform(df).cache()
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = VowpalWabbitClassifier(numBits=VW_BITS).fit(feats)
    fit_s = time.perf_counter() - t0
    native_ms = model._stats[0].learn_time_ns / 1e6
    t0 = time.perf_counter()
    scored = model.transform(feats)
    raw = np.asarray(scored.column("rawPrediction"), dtype=np.float64)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ftrl = VowpalWabbitClassifier(numBits=VW_BITS,
                                  passThroughArgs="--ftrl").fit(feats)
    ftrl_s = time.perf_counter() - t0
    env = Env(MMLSPARK_TPU_NATIVE_VW="0")
    with env:
        t0 = time.perf_counter()
        scan = VowpalWabbitClassifier(numBits=VW_BITS).fit(feats)
        scan_s = time.perf_counter() - t0
    launches = vs.launches
    if launches != 2:
        fail(f"vw_main: vw_scan launched {launches} times on the FTRL and "
             f"the adaptive scan fits (want 2)")

    rows = list(feats.column("features"))
    nnz = np.array([len(r["indices"]) for r in rows])
    y = np.where(np.asarray(feats.column("label")) > 0, 1.0, -1.0)
    ds = SparseDataset.from_rows(rows, y, num_bits=VW_BITS)
    # (c) the transform against the host f64 dot
    w64 = np.asarray(model.get("weights"), dtype=np.float64)
    terms = w64[ds.indices] * ds.values.astype(np.float64)
    host = terms.sum(1)
    pred_rel = float((np.abs(raw - host) / np.maximum(np.abs(terms).sum(1),
                                                      1e-30)).max())
    # (a) the adaptive kernel pass against the native pass
    w_scan = np.asarray(scan.get("weights"))
    w_nat = np.asarray(model.get("weights"))
    nat_ok = bool(np.allclose(w_scan, w_nat, rtol=VW_RTOL, atol=VW_ATOL))
    # (a), (b): kernel against plain on the prefix, and twice bit for bit
    pre = SparseDataset(ds.indices[:VW_PREFIX], ds.values[:VW_PREFIX],
                        ds.labels[:VW_PREFIX], ds.weights[:VW_PREFIX])
    tens = pre.to(DEVICE)
    gates = {}
    for name, kw in (("adaptive", {}), ("ftrl", {"ftrl": True})):
        cfg = LearnerConfig(num_bits=VW_BITS, loss_function="logistic", **kw)
        st_k = vl.init_state(cfg, DEVICE)
        vs.scan_pass_cuda(st_k, *tens, cfg)
        st_k2 = vl.init_state(cfg, DEVICE)
        vs.scan_pass_cuda(st_k2, *tens, cfg)
        st_p = vl.init_state(cfg, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vs.scan_pass_plain(st_p, *tens, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        a = vl.weights_of(cfg, st_k).cpu().numpy()
        b = vl.weights_of(cfg, st_p).cpu().numpy()
        states = [vl.init_state(cfg, DEVICE) for _ in range(4)]
        ms = time_ms(torch, lambda: vs.scan_pass_cuda(states.pop(), *tens,
                                                      cfg), 3, 1)
        gates[name] = {
            "max_abs_err": float(np.abs(a - b).max()),
            "close": bool(np.allclose(a, b, rtol=VW_RTOL, atol=VW_ATOL)),
            "bitwise_twice": bool(np.array_equal(
                a.view(np.uint32),
                vl.weights_of(cfg, st_k2).cpu().numpy().view(np.uint32))),
            "ms": ms, "plain_ms": plain_ms}
    # the full pass (200,000 rows) through the kernel, timed alone
    cfg = LearnerConfig(num_bits=VW_BITS, loss_function="logistic")
    full = ds.to(DEVICE)
    states = [vl.init_state(cfg, DEVICE) for _ in range(3)]
    pass_ms = time_ms(torch, lambda: vs.scan_pass_cuda(states.pop(), *full,
                                                       cfg), 2, 1)
    active = int((pre.values != 0).sum())
    # bytes: idx, val, labels and weights read once, and each of the two
    # state arrays the step touches gathered and scattered (4 B) per active
    # entry of the prefix
    n_bytes = pre.indices.nbytes + pre.values.nbytes + 8 * VW_PREFIX \
        + 2 * active * 2 * 4
    row = {"name": "vw_scan", "route": "cuda",
           "source": "mmlspark_tpu_torch/csrc/vw_scan.cu",
           "replaces": "not a TPU kernel: mmlspark_tpu/vw/learner.py:92 "
                       "make_scan_pass (lax.scan, plain XLA)",
           "max_abs_err": gates["adaptive"]["max_abs_err"],
           "ms": gates["adaptive"]["ms"],
           "plain_ms": gates["adaptive"]["plain_ms"],
           "bound_ms": bound_ms(n_bytes, 0)[0], "bound_by": "bytes",
           "library_ms": None, "shape": [VW_PREFIX, int(ds.indices.shape[1])],
           "pass_ms_200k": pass_ms,
           "pass_bound_ms_200k": bound_ms(
               ds.indices.nbytes + ds.values.nbytes + 8 * VW_ROWS
               + 2 * int((ds.values != 0).sum()) * 2 * 4, 0)[0],
           "native_pass_ms_200k": native_ms}
    log({"phase": "vw_main", "card": smi, "rows": VW_ROWS,
         "datagen_seconds": gen_s, "featurize_seconds": feat_s,
         "featurizer_rows_per_s": VW_ROWS / feat_s,
         "entries_per_row_mean": float(nnz.mean()),
         "slots_per_row": int(ds.indices.shape[1]),
         "murmur_uses": {f"{k[0]}:{k[1]}": v for k, v in
                         native_loader.uses.items() if k[0] == "murmur3_batch"},
         "fit_seconds": fit_s, "fit_route_native_pass_ms": native_ms,
         "native_examples_per_s": VW_ROWS / (native_ms / 1e3),
         "transform_seconds": transform_s, "ftrl_fit_seconds": ftrl_s,
         "scan_fit_seconds": scan_s,
         "vw_scan_pass_ms": pass_ms,
         "vw_scan_examples_per_s": VW_ROWS / (pass_ms / 1e3),
         "ftrl_pass_ms": ftrl._stats[0].learn_time_ns / 1e6,
         "scan_pass_ms_in_fit": scan._stats[0].learn_time_ns / 1e6,
         "vw_scan_launches": launches, "scan_vs_native_close": nat_ok,
         "scan_vs_native_max_abs": float(np.abs(w_scan - w_nat).max()),
         "predict_rel_max": pred_rel, "prefix_gates": gates,
         "train_logloss_native": model._stats[0].average_loss})
    for name, g in gates.items():
        if not g["close"] or not g["bitwise_twice"]:
            fail(f"vw_main ({name}): vw_scan against its plain version on "
                 f"the card {g['max_abs_err']} (rtol {VW_RTOL}, atol "
                 f"{VW_ATOL}) or two calls not bit for bit")
    if not nat_ok:
        fail("vw_main: the adaptive vw_scan pass against the native pass "
             f"beyond rtol {VW_RTOL} / atol {VW_ATOL}")
    if pred_rel > VW_PREDICT_REL:
        fail(f"vw_main: transform against the host dot {pred_rel} "
             f"(bound {VW_PREDICT_REL})")
    if os.environ.get("MMLSPARK_TPU_NATIVE_VW"):
        fail("vw_main: MMLSPARK_TPU_NATIVE_VW left set")
    return {**row, "launches": launches}, ds


# ---------------------------------------------------------------------------
# data-parallel fits across processes (parallel/mesh.py)
# ---------------------------------------------------------------------------

# the featurization and train layers (ROADMAP A 10.1-10.2): text_main
# (TextFeaturizer -> the sparse fit, K4, and the fused CSR transform, K3),
# adult_main (CleanMissingData -> TrainClassifier, K1 and K2) and
# word2vec_main (Word2Vec's training step on the card)
REVIEW_ROWS = 50_000          # 5x the notebook's 10,000 book reviews
REVIEW_HOLDOUT = 10_000
REVIEW_VOCAB = 30_000         # Zipf-distributed words (exponent 1.07)
REVIEW_TOKENS = 80            # tokens a review (Poisson)
REVIEW_SENTIMENT = 60         # sentiment words a class
REVIEW_REFIT_ROWS = 5_000     # the card-against-CPU refit's prefix
TEXT_ITERS = 50
TEXT_STOPWORDS = ("a", "an", "and", "are", "as", "at", "be", "by", "for",
                  "from", "has", "he", "in", "is", "it", "its", "of", "on",
                  "that", "the", "to", "was", "were", "will", "with")
ADULT_ROWS = 32_561           # the UCI Adult train split
ADULT_HOLDOUT = 16_281        # and its test split
ADULT_ITERS = 100
ADULT_NUMERIC = ("age", "fnlwgt", "education_num", "capital_gain",
                 "capital_loss", "hours_per_week")
# (column, published cardinality with "?" counted, share of "?" -> None)
ADULT_STRINGS = (("workclass", 9, 0.056), ("education", 16, 0.0),
                 ("marital_status", 7, 0.0), ("occupation", 15, 0.057),
                 ("relationship", 6, 0.0), ("race", 5, 0.0), ("sex", 2, 0.0),
                 ("native_country", 42, 0.018))
ADULT_AUC_TOL = 1e-6          # a swap of two scores within the 1e-5 gate
W2V_REVIEWS = 5_000
W2V_CPU_REVIEWS = 500         # the card-against-CPU run's prefix
W2V_PARAMS = dict(vectorSize=100, windowSize=3, minCount=2, numIterations=3,
                  numNegatives=4, batchSize=1024)
# card against CPU, of max |v|: f32 sums of D = 100 products and of the
# batch's mean in another order (~1e-7 relative a step), carried through a
# prefix's ~700 SGD steps of lr 0.1 (measured on the CPU against the
# reference's jitted step: 4.5e-7 of 1.0 after 300 steps)
W2V_VECTOR_TOL = 1e-4


def reviews_like(n: int, seed: int):
    """Seeded stand-ins for the Amazon book reviews of the reference's
    "TextAnalytics - Amazon Book Reviews" notebook: a vocabulary of
    REVIEW_VOCAB made-up words (the stop words first) drawn with Zipf
    frequencies, ~REVIEW_TOKENS tokens a review, two balanced classes
    carried by REVIEW_SENTIMENT mid-frequency words each (~3 a review,
    80% from the review's own class). Returns (texts, labels)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    cand = rng.choice(letters, (2 * REVIEW_VOCAB, 10)).view("S10")[:, 0]
    cut = rng.integers(3, 11, 2 * REVIEW_VOCAB)
    words = dict.fromkeys(TEXT_STOPWORDS)
    for w, k in zip(cand, cut):
        words.setdefault(w[:k].decode())
        if len(words) == REVIEW_VOCAB:
            break
    vocab = np.array(list(words), dtype=object)
    p = 1.0 / (np.arange(1, REVIEW_VOCAB + 1) + 2.7) ** 1.07
    senti = rng.choice(np.arange(200, 2000), 2 * REVIEW_SENTIMENT,
                       replace=False)
    y = (rng.random(n) < 0.5).astype(np.float64)
    n_tok = np.maximum(5, rng.poisson(REVIEW_TOKENS, n))
    total = int(n_tok.sum())
    toks = rng.choice(REVIEW_VOCAB, total, p=p / p.sum())
    label = np.repeat(y, n_tok).astype(bool)
    hit = rng.random(total) < 3.0 / REVIEW_TOKENS
    side = np.where(rng.random(total) < 0.8, label, ~label)
    word = rng.integers(0, REVIEW_SENTIMENT, total) + np.where(
        side, 0, REVIEW_SENTIMENT)
    toks = np.where(hit, senti[word], toks)
    texts = np.empty(n, dtype=object)
    texts[:] = [" ".join(ws) for ws in
                np.split(vocab[toks], np.cumsum(n_tok)[:-1])]
    return texts, y


def text_main(torch, smi):
    """``TextFeaturizer`` at its defaults (2^18 features, IDF) with the
    stop-words remover, fit and transform on REVIEW_ROWS seeded reviews
    (``reviews_like``), then ``LightGBMClassifier`` (31 leaves, TEXT_ITERS
    iterations) on the sparse column on the card's route (the sparse
    scan), and a fused transform of the REVIEW_HOLDOUT holdout with the
    ``csr`` layout. Gates: every token hashed by the native
    ``murmur3_batch``; K4 launched in the fit and K3 in the fused
    transform, which falls back nowhere and is within SERVE_PROBA_TOL of
    the unfused ``predict_csr`` scores; the first ITERS_REFIT trees of a
    card fit on the first REVIEW_REFIT_ROWS rows equal a CPU fit's on the
    same route. Returns (the launches, the texts)."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    t0 = time.perf_counter()
    texts, y = reviews_like(REVIEW_ROWS + REVIEW_HOLDOUT, SEED + 23)
    gen_s = time.perf_counter() - t0
    n = REVIEW_ROWS
    train = DataFrame.from_dict({"text": texts[:n], "label": y[:n]})
    hold = DataFrame.from_dict({"text": texts[n:]})
    slow = native_loader.uses[("murmur3_batch", "numpy")]
    t0 = time.perf_counter()
    featurizer = TextFeaturizer(inputCol="text", outputCol="features",
                                useStopWordsRemover=True).fit(train)
    feat_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = featurizer.transform(train).select("features", "label")
    hold_rows = featurizer.transform(hold).select("features")
    feat_tr_s = time.perf_counter() - t0
    if native_loader.uses[("murmur3_batch", "numpy")] != slow:
        fail("text_main: TextFeaturizer hashed tokens on the numpy path (the "
             "native murmur3_batch did not load)")
    rows = feats.column("features")
    nnz = int(sum(len(r["indices"]) for r in rows))
    shk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LightGBMClassifier(numLeaves=31, numIterations=TEXT_ITERS,
                               labelCol="label").fit(feats)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k4 = shk.launches
    check_route(model.booster, "scan", "text_main")
    t0 = time.perf_counter()
    unfused = _raw(model.transform(hold_rows))
    unfused_s = time.perf_counter() - t0
    label = "LightGBMClassificationModel"
    fused = PipelineModel([model]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    gk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = _raw(fused.transform(hold_rows))
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    k3 = gk.launches
    st = fused.fusion_stats()
    diff = float(np.abs(raw - unfused).max())
    holdout_auc = auc(raw[:, 1], y[n:])
    cut = DataFrame.from_dict({"features": rows[:REVIEW_REFIT_ROWS],
                               "label": y[:REVIEW_REFIT_ROWS]})
    _, _, ref = refit_compare(
        torch, lambda: LightGBMClassifier(numLeaves=31, labelCol="label",
                                          numIterations=ITERS_REFIT),
        cut, ITERS_REFIT, "text_main", route="scan")
    log({"phase": "text_main", "card": smi, "rows": n,
         "holdout_rows": len(texts) - n, "generate_seconds": gen_s,
         "featurizer_fit_seconds": feat_fit_s,
         "featurizer_transform_seconds": feat_tr_s,
         "featurizer_rows_per_s": len(texts) / feat_tr_s,
         "num_features": featurizer.get("numFeatures"), "nnz": nnz,
         "fit_seconds": fit_s, "route": model.booster.route,
         "unfused_transform_seconds": unfused_s,
         "fused_transform_seconds": fused_s, "holdout_auc": holdout_auc,
         "k4_launches": k4, "k3_launches": k3,
         "max_abs_diff_fused_vs_unfused": diff,
         "fallbacks": st["fallbacks"], "compile_cache": st["compile_cache"],
         "ring": st["per_segment"].get(label, {}),
         "refit_rows": REVIEW_REFIT_ROWS,
         "trees_held": ITERS_REFIT, **ref,
         "cuts": "REVIEW_ROWS 50,000 of generated reviews (5x the notebook's "
                 "10,000); none of the widths"})
    if k4 < 1 or k3 < 1:
        fail(f"text_main: K4 launched {k4} times in the fit, K3 {k3} in the "
             f"fused transform")
    if st["fallbacks"]:
        fail(f"text_main: the fused CSR transform fell back: {st['fallbacks']}")
    if diff > SERVE_PROBA_TOL:
        fail(f"text_main: fused CSR scores differ from the unfused "
             f"predict_csr ones by {diff}")
    bad = [d for d in ref["first_diff_per_tree"] if d is not None]
    if bad:
        fail(f"text_main: the card's trees part from the CPU's: {bad[0]}")
    return {"sparse_hist": k4, "csr_gather": k3}, texts


def adult_like(n: int, seed: int) -> dict:
    """Seeded rows shaped like UCI Adult (census income): its 6 numeric
    columns and 8 string columns at the published cardinalities, None where
    Adult has "?" (workclass, occupation, native-country, at its rates),
    Zipf-skewed levels, and the string label ``income`` (">50K" for the top
    24% of a logistic score over the columns)."""
    rng = np.random.default_rng(seed)
    cols = {"age": rng.integers(17, 91, n).astype(np.float64),
            "fnlwgt": np.round(rng.lognormal(12.0, 0.5, n)),
            "education_num": rng.integers(1, 17, n).astype(np.float64),
            "capital_gain": np.where(rng.random(n) < 0.08, np.round(
                rng.lognormal(8.5, 1.0, n)), 0.0),
            "capital_loss": np.where(rng.random(n) < 0.05, np.round(
                rng.lognormal(7.4, 0.3, n)), 0.0),
            "hours_per_week": np.clip(np.round(rng.normal(40, 12, n)), 1, 99)}
    z = (0.04 * (cols["age"] - 38) + 0.3 * (cols["education_num"] - 10)
         + 0.03 * (cols["hours_per_week"] - 40) + 4e-4 * cols["capital_gain"])
    for name, k, missing in ADULT_STRINGS:
        known = k - (1 if missing else 0)
        w = rng.zipf(1.6, known).astype(np.float64)
        idx = rng.choice(known, n, p=w / w.sum())
        z = z + rng.normal(0.0, 0.6, known)[idx]
        vals = np.array([f"{name}_{i}" for i in range(known)], object)[idx]
        if missing:
            vals[rng.random(n) < missing] = None
        cols[name] = vals
    z = z + rng.logistic(0.0, 1.0, n)
    cols["income"] = np.where(z > np.quantile(z, 0.76), ">50K",
                              "<=50K").astype(object)
    return cols


def _adult_fit(torch, train, hold, iters: int):
    """CleanMissingData -> TrainClassifier(LightGBMClassifier) fit on
    ``train`` and scored on ``hold``; returns (model, scored holdout with
    the label indexed, fit seconds)."""
    from mmlspark_tpu_torch.featurize import CleanMissingData, ValueIndexer
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.train import TrainClassifier

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = CleanMissingData(inputCols=list(ADULT_NUMERIC)).fit(train)
    model = TrainClassifier(labelCol="income").set_model(LightGBMClassifier(
        numIterations=iters, numLeaves=31)).fit(clean.transform(train))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    scored = model.transform(clean.transform(hold))
    label = ValueIndexer(inputCol="income", outputCol="income").fit(train)
    return model, label.transform(scored), fit_s


def _adult_stats(scored) -> dict:
    from mmlspark_tpu_torch.train import (ComputeModelStatistics,
                                          ComputePerInstanceStatistics)

    row = ComputeModelStatistics(labelCol="income").transform(scored).rows()[0]
    loss = ComputePerInstanceStatistics(labelCol="income").transform(
        scored).column("log_loss")
    return {"confusion_matrix": np.asarray(row["confusion_matrix"]),
            **{k: float(row[k]) for k in ("accuracy", "precision", "recall",
                                          "AUC")},
            "log_loss": np.asarray(loss, np.float64)}


def adult_main(torch, smi) -> dict:
    """``CleanMissingData`` -> ``TrainClassifier(LightGBMClassifier(
    numIterations=ADULT_ITERS, numLeaves=31))`` on ADULT_ROWS seeded
    Adult-shaped rows (``adult_like``; the string label reindexed, the 14
    columns auto-featurized: 6 numeric, 99 one-hot slots) on the card's
    device route (the native engine off: a fit this small would take it),
    then ``ComputeModelStatistics`` and ``ComputePerInstanceStatistics``
    on the ADULT_HOLDOUT holdout. Gates: K1 launched in the fit (and K2
    logged); the holdout scores within 1e-5 of the host f64 traversal of
    the card's model; a refit of ITERS_REFIT iterations on the card and on
    the CPU (the scan pinned on both): the same trees, holdout scores
    within 1e-5 and the statistics of both outputs equal (the confusion
    matrix, accuracy, precision and recall exactly, AUC within
    ADULT_AUC_TOL, every per-row log loss within 1e-5: its derivative in
    the score is at most 1). Returns the launches."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.runtime import use_device

    data = adult_like(ADULT_ROWS + ADULT_HOLDOUT, SEED + 24)
    train = DataFrame.from_dict({k: v[:ADULT_ROWS] for k, v in data.items()})
    hold = DataFrame.from_dict({k: v[ADULT_ROWS:] for k, v in data.items()})
    with Env(**NATIVE_OFF):
        zero_launches()
        model, scored, fit_s = _adult_fit(torch, train, hold, ADULT_ITERS)
        got = read_launches()
    booster = model.get("model").booster
    X = np.stack(list(scored.column("features")))
    raw = np.stack(list(scored.column("scores")))[:, 1]
    host_diff = float(np.abs(raw - host_raw32(booster, X)).max())
    stats = _adult_stats(scored)
    refit = {}
    for dev, env in ((DEVICE, NATIVE_OFF), ("cpu", {**NATIVE_OFF, **CPU_SCAN})):
        with use_device(dev), Env(**env):
            m, s, secs = _adult_fit(torch, train, hold, ITERS_REFIT)
        refit[dev] = (m.get("model").booster, s, secs)
    (bc, sc, cuda_s), (bp, sp, cpu_s) = refit[DEVICE], refit["cpu"]
    diffs = [first_diff(bc.trees[i][0], bp.trees[i][0])
             for i in range(ITERS_REFIT)]
    score_diff = float(np.abs(np.stack(list(sc.column("scores")))
                              - np.stack(list(sp.column("scores")))).max())
    st_c, st_p = _adult_stats(sc), _adult_stats(sp)
    log({"phase": "adult_main", "card": smi, "rows": ADULT_ROWS,
         "holdout_rows": ADULT_HOLDOUT, "features": X.shape[1],
         "fit_seconds": fit_s, "route": booster.route, "launches": got,
         "max_abs_diff_vs_host_f64": host_diff,
         **{k: (v.tolist() if k == "confusion_matrix" else v)
            for k, v in stats.items() if k != "log_loss"},
         "mean_log_loss": float(stats["log_loss"].mean()),
         "refit_iterations": ITERS_REFIT, "refit_cuda_seconds": cuda_s,
         "refit_cpu_seconds": cpu_s, "refit_routes": [bc.route, bp.route],
         "refit_first_diff_per_tree": diffs,
         "refit_max_abs_score_diff": score_diff,
         "refit_stats_cuda": {k: v for k, v in st_c.items()
                              if k not in ("confusion_matrix", "log_loss")},
         "refit_auc_diff": abs(st_c["AUC"] - st_p["AUC"]),
         "refit_max_log_loss_diff": float(np.abs(
             st_c["log_loss"] - st_p["log_loss"]).max()),
         "cuts": "none (the Adult train and test splits' sizes)"})
    check_route(booster, "scan", "adult_main")
    if got["hist"] + got["hist_count"] < 1:
        fail(f"adult_main: K1 never launched in the fit: {got}")
    if host_diff > 1e-5:
        fail(f"adult_main: card scores differ from the host f64 traversal "
             f"by {host_diff}")
    for b in (bc, bp):
        check_route(b, "scan", "adult_main refit")
    bad = [d for d in diffs if d is not None]
    if bad:
        fail(f"adult_main: the card's trees part from the CPU's: {bad[0]}")
    if score_diff > 1e-5:
        fail(f"adult_main: the card's refit scores differ from the CPU's by "
             f"{score_diff}")
    if not (np.array_equal(st_c["confusion_matrix"], st_p["confusion_matrix"])
            and all(st_c[k] == st_p[k] for k in ("accuracy", "precision",
                                                 "recall"))
            and abs(st_c["AUC"] - st_p["AUC"]) <= ADULT_AUC_TOL
            and np.abs(st_c["log_loss"] - st_p["log_loss"]).max() <= 1e-5):
        fail(f"adult_main: the statistics of the card's refit differ from "
             f"the CPU's: {st_c} vs {st_p}")
    return got


def word2vec_main(torch, smi, texts) -> None:
    """``Word2Vec(**W2V_PARAMS)`` trained on the card over the first
    W2V_REVIEWS reviews of text_main, twice. Gates: its initial matrix (the
    threefry normal draw) equals the CPU's bit for bit; the two runs give
    the same vectors and losses bit for bit; a fit on the first
    W2V_CPU_REVIEWS reviews on the card and on the CPU within
    W2V_VECTOR_TOL of max |v|."""
    from mmlspark_tpu_torch.core import threefry
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.runtime import use_device

    df = DataFrame.from_dict({"text": texts[:W2V_REVIEWS]})
    runs = []
    for _ in range(2):
        est = Word2Vec(inputCol="text", outputCol="vec", **W2V_PARAMS)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(df)
        runs.append((model, est.last_losses, time.perf_counter() - t0))
    (m1, l1, s1), (m2, l2, s2) = runs
    vocab, vecs = m1.get("vocab"), m1.get("vectors")
    v, d = vecs.shape
    key = threefry.split(threefry.prng_key(0, DEVICE), 2)[0]
    init = threefry.normal(key, v * d).cpu().numpy()
    init_cpu = threefry.normal(key.cpu(), v * d).numpy()
    repeat = (np.array_equal(vecs.view(np.int32),
                             m2.get("vectors").view(np.int32))
              and np.array_equal(l1.view(np.int32), l2.view(np.int32)))
    small = DataFrame.from_dict({"text": texts[:W2V_CPU_REVIEWS]})
    got = {}
    for dev in (DEVICE, "cpu"):
        with use_device(dev):
            t0 = time.perf_counter()
            got[dev] = (Word2Vec(inputCol="text", outputCol="vec",
                                 **W2V_PARAMS).fit(small).get("vectors"),
                        time.perf_counter() - t0)
    (vc, small_s), (vp, cpu_s) = got[DEVICE], got["cpu"]
    rel = float(np.abs(vc - vp).max() / np.abs(vp).max())
    steps = len(l1)
    log({"phase": "word2vec_main", "card": smi, "reviews": W2V_REVIEWS,
         "vocab": v, "dim": d, "steps": steps,
         "pairs_trained": steps * W2V_PARAMS["batchSize"],
         "seconds": [s1, s2], "steps_per_s": steps / s1,
         "loss_first": float(l1[0]), "loss_last": float(l1[-1]),
         "init_bitwise_cpu": bool(np.array_equal(init.view(np.int32),
                                                 init_cpu.view(np.int32))),
         "bitwise_repeat": repeat, "cpu_reviews": W2V_CPU_REVIEWS,
         "cpu_prefix_card_seconds": small_s, "cpu_prefix_cpu_seconds": cpu_s,
         "max_rel_diff_vs_cpu": rel,
         "synonyms": m1.find_synonyms(vocab[100], 3),
         "cuts": "W2V_REVIEWS 5,000 of text_main's reviews (the issue's); "
                 "the CPU comparison on its first 500"})
    if not np.array_equal(init.view(np.int32), init_cpu.view(np.int32)):
        fail("word2vec_main: the card's initial matrix is not the CPU's")
    if not repeat:
        fail("word2vec_main: two runs on the card gave different bits")
    if rel > W2V_VECTOR_TOL:
        fail(f"word2vec_main: card vectors differ from the CPU's by {rel} of "
             f"max |v|")


# the AutoML, recommendation and LIME layers (ROADMAP A 10.3): automl_main
# (TuneHyperparameters over LightGBMClassifier on adult_main's rows, K1 and
# K2, at parallelism 1 and 2), sar_main (SAR at MovieLens-10M shape) and
# lime_main (TabularLIME over automl_main's model, ImageLIME over
# image_main's ResNet-50 featurizer, their lassos batched on the card)
AUTOML_ITERS = 25
AUTOML_LEAVES = (15, 31)
AUTOML_FOLDS = 3
ML_USERS = 69_878             # GroupLens MovieLens-10M (ml-10M100K)
ML_ITEMS = 10_677
ML_RATINGS = 10_000_054
ML_MIN_RATINGS = 20           # every user rated at least 20 movies
ML_MAX_RATINGS = 7_359        # the busiest user's ratings
ML_TIME_RANGE = (789_652_009, 1_231_131_736)   # 1995-01-09 .. 2009-01-05
ML_ZIPF_OFFSET = 60           # item popularity ~ 1 / (rank + 60): the most
                              # rated ~0.2% of the ratings (MovieLens-10M's
                              # most rated movie: 34,864 of 10,000,054)
ML_INDEX_PREFIX = 1_000_000   # rows RecommendationIndexer is timed on
SAR_CHECK_COLUMNS = 256       # C's columns against exact int64 counts
SAR_CHECK_USERS = 1_024       # A @ S rows against a host f64 product
SAR_SCORE_RTOL = 1e-5
SAR_TOP_K = 10
LIME_ROWS = 64                # holdout rows TabularLIME explains
LIME_SAMPLES = 1_000          # the reference's nSamples default
LIME_IMAGES = 4
LIME_IMAGE_SAMPLES = 100
LIME_LASSO_TOL = 1e-4         # of max(1, max |w|): card against CPU lasso
LIME_PROBE_TOL = 1e-6         # probe scores against the host f64 traversal


class FitLaunches:
    """While active, each ``LightGBMClassifier.fit``'s K1/K2 launches (the
    counters read before and after it: meaningful when fits run one at a
    time), its frame and its model."""

    def __enter__(self):
        from mmlspark_tpu_torch.gbdt import LightGBMClassifier

        self.cls, self.orig = LightGBMClassifier, LightGBMClassifier.fit
        self.fits = []
        orig = self.orig

        def counted(est, df):
            before = read_launches()
            model = orig(est, df)
            after = read_launches()
            self.fits.append(({k: after[k] - before[k] for k in after}, df,
                              model))
            return model

        self.cls.fit = counted
        return self

    def __exit__(self, *exc):
        self.cls.fit = self.orig


def _adult_frames():
    """adult_main's rows (``adult_like``, the same seed) as ``features`` /
    ``label`` frames: the numeric columns cleaned, every column assembled
    (6 numeric, 99 one-hot slots), the label indexed (>50K = 1)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize import (AssembleFeatures,
                                              CleanMissingData, ValueIndexer)

    data = adult_like(ADULT_ROWS + ADULT_HOLDOUT, SEED + 24)
    train = DataFrame.from_dict({k: v[:ADULT_ROWS] for k, v in data.items()})
    hold = DataFrame.from_dict({k: v[ADULT_ROWS:] for k, v in data.items()})
    clean = CleanMissingData(inputCols=list(ADULT_NUMERIC)).fit(train)
    label = ValueIndexer(inputCol="income", outputCol="label").fit(train)
    asm = AssembleFeatures(inputCols=[c for c in data if c != "income"],
                           outputCol="features").fit(clean.transform(train))

    def prep(df):
        return asm.transform(label.transform(clean.transform(df))).select(
            "features", "label")

    return prep(train), prep(hold)


def _tune(par: int):
    from mmlspark_tpu_torch.automl import (DiscreteHyperParam, GridSpace,
                                           HyperparamBuilder,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier

    est = LightGBMClassifier(numIterations=AUTOML_ITERS)
    space = GridSpace(HyperparamBuilder().add_hyperparam(
        est, "numLeaves", DiscreteHyperParam(list(AUTOML_LEAVES))).build())
    return TuneHyperparameters(models=[est], paramSpace=space,
                               numFolds=AUTOML_FOLDS, evaluationMetric="AUC",
                               parallelism=par)


def _proba(df) -> np.ndarray:
    return np.stack(list(df.column("probability")))


def automl_main(torch, smi) -> tuple:
    """``TuneHyperparameters(models=[LightGBMClassifier(numIterations=25)],
    paramSpace=GridSpace(numLeaves in {15, 31}), numFolds=3,
    evaluationMetric="AUC")`` on adult_main's 32,561 Adult-shaped rows
    (``_adult_frames``), the native engine off (the card's scan route), at
    parallelism 1 and 2 (7 fits each: 3 folds x 2 settings and the
    winner's refit), then ``FindBestModel`` over the two settings'
    full-data models (the tuned winner's and a fit of the other setting)
    on the 16,281-row holdout. Gates: parallelism 2 bit
    for bit parallelism 1 (``allMetrics``, ``bestParams``, the best model's
    LightGBM text and its holdout probabilities); every fit on the scan;
    K1's and K2's launches under parallelism 2 the sum of each fit's own
    (counted fit by fit under parallelism 1); the first fold's first
    ITERS_REFIT trees those of a CPU refit on the same rows (the forced
    scan, on a thread beside the full-data fit); the best model's holdout
    scores within 1e-5 of the host f64 traversal; ``FindBestModel`` picking
    the better holdout AUC. Returns (the
    launches, the best model, the holdout frame)."""
    from mmlspark_tpu_torch.automl import FindBestModel, MetricEvaluator
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    tr, ho = _adult_frames()
    frames_s = time.perf_counter() - t0
    runs, fit_s = {}, {}
    with Env(**NATIVE_OFF):
        for par in (1, 2):
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Watch(LightGBMClassifier, "fit") as fit_w:
                if par == 1:
                    with FitLaunches() as fl:
                        model = _tune(par).fit(tr)
                else:
                    model = _tune(par).fit(tr)
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            fit_s[par] = fit_w.seconds
            runs[par] = (model, read_launches(), secs, model.transform(ho))
    fold_launches, fold_df, fold_model = fl.fits[0]
    winner = runs[1][0].get("bestParams")["numLeaves"]

    def cpu_refit():
        with use_device("cpu"):
            return LightGBMClassifier(numIterations=ITERS_REFIT,
                                      numLeaves=AUTOML_LEAVES[0]).fit(fold_df)

    # the first fold's CPU refit (the forced scan) on a thread of its own,
    # beside the other setting's full-data fit on the card (where the scan
    # is the default route) and FindBestModel over both settings' models
    t0 = time.perf_counter()
    with Env(**NATIVE_OFF, **CPU_SCAN), ThreadPoolExecutor(1) as pool:
        refit = pool.submit(cpu_refit)
        full = {v: runs[1][0].get("bestModel") if v == winner
                else LightGBMClassifier(numIterations=AUTOML_ITERS,
                                        numLeaves=v).fit(tr)
                for v in AUTOML_LEAVES}
        best = FindBestModel(models=[full[v] for v in AUTOML_LEAVES],
                             evaluationMetric="AUC").fit(ho)
        best_s = time.perf_counter() - t0
        cpu = refit.result()
    refit_s = time.perf_counter() - t0
    diffs = [first_diff(fold_model.booster.trees[i][0], cpu.booster.trees[i][0])
             for i in range(ITERS_REFIT)]
    (m1, l1, s1, h1), (m2, l2, s2, h2) = runs[1], runs[2]
    p1, p2 = _proba(h1), _proba(h2)
    per_fit = [f[0] for f in fl.fits]
    summed = {k: sum(f[k] for f in per_fit) for k in l1}
    bm = m1.get("bestModel")
    X_ho = np.stack(list(ho.column("features")))
    host_diff = float(np.abs(np.stack(list(h1.column("rawPrediction")))[:, 1]
                             - host_raw32(bm.booster, X_ho)).max())
    aucs = [MetricEvaluator("AUC").evaluate(full[v].transform(ho))
            for v in AUTOML_LEAVES]
    log({"phase": "automl_main", "card": smi, "rows": tr.count(),
         "holdout_rows": ho.count(),
         "features": len(tr.column("features")[0]),
         "fits_per_run": len(per_fit), "seconds_parallelism_1": s1,
         "seconds_parallelism_2": s2, "fit_seconds_parallelism_1": fit_s[1],
         "fit_seconds_parallelism_2": fit_s[2], "frames_seconds": frames_s,
         "full_fit_and_find_best_seconds": best_s,
         "with_cpu_refit_beside_seconds": refit_s, "all_metrics": m1.get("allMetrics"),
         "best_params": m1.get("bestParams"),
         "best_metric": m1.get("bestMetric"),
         "routes": sorted({f[2].booster.route for f in fl.fits}),
         "launches_parallelism_1": l1, "launches_parallelism_2": l2,
         "launches_summed_per_fit": summed,
         "allMetrics_equal": m1.get("allMetrics") == m2.get("allMetrics"),
         "best_text_equal": bm.get_model_string()
         == m2.get("bestModel").get_model_string(),
         "holdout_proba_bitwise": bool(np.array_equal(p1, p2)),
         "max_abs_diff_vs_host_f64": host_diff,
         "fold_refit_first_diff_per_tree": diffs,
         "holdout_auc_by_leaves": dict(zip(AUTOML_LEAVES, aucs)),
         "find_best_metric": best.get("bestMetric"),
         "cuts": f"CPU refit {ITERS_REFIT} of {AUTOML_ITERS} iterations (time)"})
    if m1.get("allMetrics") != m2.get("allMetrics") \
            or m1.get("bestParams") != m2.get("bestParams"):
        fail(f"automl_main: parallelism 2 tuned {m2.get('allMetrics')} "
             f"{m2.get('bestParams')}, parallelism 1 {m1.get('allMetrics')} "
             f"{m1.get('bestParams')}")
    if bm.get_model_string() != m2.get("bestModel").get_model_string() \
            or not np.array_equal(p1, p2):
        fail("automl_main: the best models of parallelism 1 and 2 differ")
    if len(per_fit) != AUTOML_FOLDS * len(AUTOML_LEAVES) + 1:
        fail(f"automl_main: {len(per_fit)} fits under parallelism 1")
    for f in fl.fits:
        check_route(f[2].booster, "scan", "automl_main")
    for v in AUTOML_LEAVES:
        check_route(full[v].booster, "scan", "automl_main")
    if l2 != summed or l1 != summed:
        fail(f"automl_main: K1/K2 launches {l2} (parallelism 2) and {l1} "
             f"(1) against the fits' own {summed}")
    check_launches({"hist": summed["hist"] + summed["hist_count"],
                    "select": summed["select"]}, "automl_main")
    bad = [d for d in diffs if d is not None]
    if bad:
        fail(f"automl_main: the fold's trees part from the CPU's: {bad[0]}")
    if host_diff > 1e-5:
        fail(f"automl_main: holdout scores {host_diff} from the host f64 "
             f"traversal")
    if best.get("bestMetric") != max(aucs) \
            or best.get_or_throw("bestModel") is not full[
                AUTOML_LEAVES[int(np.argmax(aucs))]]:
        fail(f"automl_main: FindBestModel kept {best.get('bestMetric')} of "
             f"{aucs}")
    return {k: l1[k] + l2[k] for k in l1}, bm, ho


def movielens_like(seed: int) -> dict:
    """Seeded ratings shaped like GroupLens MovieLens-10M: ML_USERS users
    each with at least ML_MIN_RATINGS ratings (a lognormal tail up to
    ML_MAX_RATINGS), ML_RATINGS ratings in all over ML_ITEMS items of
    Zipf-Mandelbrot popularity (``ML_ZIPF_OFFSET``), no (user, item) pair
    twice (a repeated pair is redrawn, from the popularity at first, then
    uniformly, then from the user's unrated items), half stars 0.5-5 at the
    dataset's rough shares, timestamps uniform over ML_TIME_RANGE; indexed
    users and items, rows by user."""
    rng = np.random.default_rng(seed)
    extra = rng.lognormal(3.6, 1.2, ML_USERS)
    extra = extra / extra.sum() * (ML_RATINGS - ML_MIN_RATINGS * ML_USERS)
    counts = np.minimum(ML_MIN_RATINGS + np.floor(extra).astype(np.int64),
                        ML_MAX_RATINGS)
    short = ML_RATINGS - int(counts.sum())
    room = np.nonzero(counts < min(1_000, ML_MAX_RATINGS // 2))[0]
    np.add.at(counts, rng.choice(room, short), 1)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    users = np.repeat(np.arange(ML_USERS, dtype=np.int64), counts)
    perm = rng.permutation(ML_ITEMS)            # popularity rank -> item id
    q = 1.0 + ML_ZIPF_OFFSET
    span = np.log((ML_ITEMS + q) / q)

    def popular(n):
        # rank r in [1, ML_ITEMS + 1) of density ~ 1 / (r + offset)
        r = q * np.exp(rng.random(n) * span) - ML_ZIPF_OFFSET
        return perm[np.minimum(r.astype(np.int64) - 1, ML_ITEMS - 1)]

    items = popular(len(users))
    active = np.arange(len(users))
    for rnd in range(9):                        # redraw repeated pairs
        # (pair, position) packed in one int64 and sorted: a pair's later
        # rows follow its first (pair < 2^30, position < 2^24)
        packed = np.sort(((users[active] * ML_ITEMS + items[active]) << 24)
                         | np.arange(len(active)))
        ks = packed >> 24
        dup = active[(packed[1:] & 0xFFFFFF)[ks[1:] == ks[:-1]]]
        if not len(dup):
            break
        bad = users[dup]
        bad = bad[np.concatenate([[True], bad[1:] != bad[:-1]])]
        if rnd == 8:
            # the last repeats: drawn from each user's unrated items
            for u in bad:
                rows = dup[users[dup] == u]
                free = np.setdiff1d(np.arange(ML_ITEMS),
                                    items[ptr[u]:ptr[u + 1]])
                items[rows] = rng.choice(free, len(rows), replace=False)
            break
        items[dup] = popular(len(dup)) if rnd < 4 \
            else rng.integers(0, ML_ITEMS, len(dup))
        active = np.concatenate([np.arange(ptr[u], ptr[u + 1]) for u in bad])
    stars = rng.choice(np.arange(1, 11), len(users), p=np.array(
        [1.0, 3.8, 1.2, 7.9, 3.7, 23.5, 8.8, 28.8, 7.7, 13.6]) / 100.0)
    t = rng.integers(*ML_TIME_RANGE, len(users)).astype(np.float64)
    return {"user": users, "item": items.astype(np.int64),
            "rating": stars * 0.5, "time": t}


def _tlc_on_card(torch) -> dict:
    """The 6 similarity and 3 userpred TLC fixtures
    (``tests/test_benchmarks.py``'s protocol and tolerances) through SAR
    on the card; returns the largest deviation of each kind."""
    import csv
    import gzip
    import os
    from datetime import datetime, timezone

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.recommendation import RecommendationIndexer, SAR

    res = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "resources")

    def ts(s):
        return datetime.strptime(s, "%Y/%m/%dT%H:%M:%S").replace(
            tzinfo=timezone.utc).timestamp()

    with gzip.open(os.path.join(res, "demoUsage.csv.gz"), "rt") as f:
        rows = [r for r in csv.DictReader(f)
                if r["userId"] and r["productId"] and r["timestamp"]]
    df = DataFrame.from_dict({"userId": [r["userId"] for r in rows],
                              "productId": [r["productId"] for r in rows],
                              "ts": [ts(r["timestamp"]) for r in rows]})
    ix = RecommendationIndexer(userInputCol="userId", userOutputCol="user",
                               itemInputCol="productId",
                               itemOutputCol="item").fit(df)
    tdf = ix.transform(df)
    item_index = {k: int(v) for k, v in ix.get("itemMap").items()}
    inv_item = {v: k for k, v in item_index.items()}
    uid = int(ix.get("userMap")["0003000098E85347"])
    out = {"similarity_cells": 0, "similarity_max_abs_diff": 0.0,
           "userpred_max_abs_diff": 0.0}
    for thr, sim, fixture in (
            (1, "cooccurrence", "sim_count1.csv.gz"),
            (1, "lift", "sim_lift1.csv.gz"), (1, "jaccard", "sim_jac1.csv.gz"),
            (3, "cooccurrence", "sim_count3.csv.gz"),
            (3, "lift", "sim_lift3.csv.gz"), (3, "jaccard", "sim_jac3.csv.gz")):
        model = SAR(userCol="user", itemCol="item", ratingCol="rating",
                    timeCol="ts", supportThreshold=thr,
                    similarityFunction=sim,
                    startTime=ts("2015/06/09T19:39:37")).fit(tdf)
        if not model.get("itemSimilarity").is_cuda:
            fail("sar_main: the TLC fit did not run on the card")
        S = model.get("itemSimilarity").cpu().numpy()
        with gzip.open(os.path.join(res, fixture), "rt") as f:
            fx = list(csv.reader(f))
        header = [item_index[j] for j in fx[0][1:]]
        for line in fx[1:]:
            want = np.array([float(v) for v in line[1:]])
            got = S[item_index[line[0]], header]
            if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
                fail(f"sar_main: TLC {fixture} row {line[0]} differs")
            out["similarity_cells"] += len(want)
            out["similarity_max_abs_diff"] = max(
                out["similarity_max_abs_diff"],
                float(np.abs(got - want).max()))
        if thr != 3:
            continue
        recs = model.recommend_for_all_users(num_items=40)
        got_items = [inv_item[i] for i in recs.column("recommendations")[uid][:10]]
        got_scores = np.asarray(recs.column("ratings")[uid][:10])
        pred = fixture.replace("sim_", "userpred_").replace(
            "count3", "count3_userid_only").replace(
            "lift3", "lift3_userid_only").replace("jac3", "jac3_userid_only")
        with gzip.open(os.path.join(res, pred), "rt") as f:
            ans = list(csv.DictReader(f))[0]
        want_items = [ans[f"rec{i}"] for i in range(1, 11)]
        want_scores = np.array([float(ans[f"score{i}"]) for i in range(1, 11)])
        ok = np.allclose(got_scores, want_scores, atol=1e-3) \
            and set(got_items) == set(want_items)
        for k in range(10):
            if all(abs(want_scores[k] - want_scores[j]) > 1e-6
                   for j in range(10) if j != k):
                ok = ok and got_items[k] == want_items[k]
        if not ok:
            fail(f"sar_main: TLC {pred}: {got_items} {got_scores} against "
                 f"{want_items} {want_scores}")
        out["userpred_max_abs_diff"] = max(out["userpred_max_abs_diff"], float(
            np.abs(got_scores - want_scores).max()))
    return out


def _sar_similarity_host(C: np.ndarray, diag: np.ndarray, row0: int,
                         kind: str, thresh: float) -> np.ndarray:
    """Rows row0.. of the reference's similarity, from those rows of C and
    C's whole diagonal, in numpy f32 (``mmlspark_tpu/recommendation/sar.py``'s
    lines, copied; each cell is elementwise, so a block of rows is the
    whole matrix's bits)."""
    d_r = diag[row0:row0 + len(C)]
    if kind == "cooccurrence":
        S = C.copy()
    elif kind == "jaccard":
        denom = d_r[:, None] + diag[None, :] - C
        S = np.where(denom > 0, C / np.maximum(denom, 1e-12), 0.0)
    else:
        denom = d_r[:, None] * diag[None, :]
        S = np.where(denom > 0, C / np.maximum(denom, 1e-12), 0.0)
    S = np.where(C >= thresh, S, 0.0).astype(np.float32)
    r = np.arange(len(C))
    S[r, row0 + r] = np.where(d_r >= thresh, S[r, row0 + r], 0.0)
    return S


def _sar_s_cells_off(C: np.ndarray, S: np.ndarray, kind: str,
                     thresh: float) -> int:
    """Cells of S that are not bitwise the host f32 recompute from C
    (``_sar_similarity_host``), in row blocks on a thread each (numpy's
    loops let go of the GIL)."""
    diag = np.diag(C).copy()
    block = 512

    def off(lo):
        want = _sar_similarity_host(C[lo:lo + block], diag, lo, kind, thresh)
        return int((want.view(np.int32)
                    != S[lo:lo + block].view(np.int32)).sum())

    with ThreadPoolExecutor(8) as pool:
        return sum(pool.map(off, range(0, len(C), block)))


def sar_main(torch, smi) -> None:
    """SAR at MovieLens-10M shape (``movielens_like``: 69,878 users, 10,677
    items, 10,000,054 ratings): ``RecommendationIndexer`` fit and transform
    on a 1M-row prefix (timed), then ``RankingTrainValidationSplit(
    trainRatio=0.75)`` over ``SAR(similarityFunction="jaccard",
    supportThreshold=4, timeDecayCoeff=30, timeCol="time")``: the split, the
    fit on the card (affinity [U, I], C = BᵀB, S), ``recommend_for_all_users(
    10)`` and NDCG@10 on the held-out quarter. Logs fit, recommend and split
    seconds (``Watch``), each GEMM's ms (CUDA events, the fit's own
    tensors), NDCG@10 and peak memory. Gates: C equal to exact int64
    co-occurrence counts on SAR_CHECK_COLUMNS sampled item columns (from a
    host CSR of the training events); S bitwise a numpy f32 recompute from
    C; A @ S within SAR_SCORE_RTOL of a host f64 product for
    SAR_CHECK_USERS sampled users, and their top 10 the tie rule's (score
    descending, item ascending); the TLC fixtures on the card
    (``_tlc_on_card``)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.recommendation import (RankingEvaluator,
                                                   RankingTrainValidationSplit,
                                                   RecommendationIndexer, SAR)
    from mmlspark_tpu_torch.recommendation import ranking as rk
    from mmlspark_tpu_torch.recommendation import sar as sar_mod

    t0 = time.perf_counter()
    cols = movielens_like(SEED + 25)
    gen_s = time.perf_counter() - t0
    df = DataFrame.from_dict(cols)
    prefix = DataFrame.from_dict({k: v[:ML_INDEX_PREFIX]
                                  for k, v in cols.items()})
    t0 = time.perf_counter()
    ix = RecommendationIndexer(userInputCol="user", userOutputCol="user_ix",
                               itemInputCol="item",
                               itemOutputCol="item_ix").fit(prefix)
    ix.transform(prefix).column("item_ix")
    index_s = time.perf_counter() - t0
    tvs = RankingTrainValidationSplit(
        estimator=SAR(similarityFunction="jaccard", supportThreshold=4,
                      timeDecayCoeff=30, timeCol="time"),
        evaluator=RankingEvaluator(k=SAR_TOP_K, metricName="ndcgAt"),
        trainRatio=0.75, userCol="user", itemCol="item", ratingCol="rating")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Watch(rk.RankingTrainValidationSplit, "split") as split_w, \
            Watch(SAR, "fit") as fit_w, \
            Watch(sar_mod.SARModel, "recommend_for_all_users") as rec_w:
        result = tvs.fit(df)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = fit_w.results[0]
    train = split_w.results[0][0]
    recs = rec_w.results[0]
    A = model.get("userAffinity")
    S = model.get("itemSimilarity")
    U, I = A.shape
    B = (A > 0).to(torch.float32)
    C = sar_mod.cooccurrence(B)                 # the fit ran it: warm
    cooc_ms = time_ms(torch, lambda: sar_mod.cooccurrence(B), 2, 0)
    del B

    # gate: C's sampled columns against exact int64 counts over the events
    # whose f32 affinity is above 0 (the decay underflows f32 for events
    # ~150 half-lives before the last), as the reference computes it
    rng = np.random.default_rng(SEED + 26)
    t0 = time.perf_counter()
    tr = train.collect()
    tt = np.asarray(tr["time"], np.float64)
    decay = np.power(2.0, -(tt.max() - tt) / (30 * 86400.0))
    kept = (np.asarray(tr["rating"], np.float64) * decay).astype(
        np.float32) > 0
    pairs = np.unique(np.asarray(tr["user"], np.int64)[kept] * I
                      + np.asarray(tr["item"], np.int64)[kept])
    tu, ti = pairs // I, pairs % I            # one entry a (user, item)
    u_ptr = np.searchsorted(tu, np.arange(U + 1))
    by_item = np.sort(ti * U + tu)            # (item, user) pairs, by item
    i_ptr = np.searchsorted(by_item, np.arange(I + 1) * U)
    cols_ = np.sort(rng.choice(I, SAR_CHECK_COLUMNS, replace=False))
    C_cols = C[:, torch.as_tensor(cols_, device=C.device)].cpu().numpy()
    bad_c = 0
    for k, j in enumerate(cols_):
        # every item of every user who has item j, counted
        us = by_item[i_ptr[j]:i_ptr[j + 1]] - j * U
        lo, lens = u_ptr[us], u_ptr[us + 1] - u_ptr[us]
        at = np.repeat(lo - (np.cumsum(lens) - lens), lens) \
            + np.arange(int(lens.sum()))
        exact = np.bincount(ti[at], minlength=I).astype(np.int64)
        bad_c += int((C_cols[:, k].astype(np.int64) != exact).sum())
    c_s = time.perf_counter() - t0

    # gate: S bitwise a host f32 recompute from C
    t0 = time.perf_counter()
    S_card = S.cpu().numpy()
    bad_s = _sar_s_cells_off(C.cpu().numpy(), S_card, "jaccard", 4.0)
    del C
    s_s = time.perf_counter() - t0

    # gate: the scores recommend ranked (A @ S, the same product) for
    # sampled users against a host f64 product; their top 10 by the tie
    # rule (relative error where the exact score is a normal f32)
    t0 = time.perf_counter()
    with sar_mod._full_f32():
        score_ms = time_ms(torch, lambda: torch.matmul(A, S), 2, 0)
    users = np.sort(rng.choice(U, SAR_CHECK_USERS, replace=False))
    sel = torch.as_tensor(users, device=A.device)
    full = model._scores(remove_seen=False)
    rows = full[sel].cpu().numpy()
    del full
    A_rows = A[sel].cpu().numpy()
    # the exact scores: A's sampled rows (sparse, f64) times S in f64
    r_nz, c_nz = np.nonzero(A_rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # "CSR support is in beta"
        a_csr = torch.sparse_csr_tensor(
            torch.as_tensor(np.searchsorted(r_nz, np.arange(len(users) + 1))),
            torch.as_tensor(c_nz), torch.as_tensor(A_rows[r_nz, c_nz],
                                                   dtype=torch.float64),
            (len(users), I))
    exact = (a_csr @ torch.from_numpy(S_card).double()).numpy()
    err = np.abs(rows - exact)
    tiny = float(np.finfo(np.float32).tiny)
    normal = np.abs(exact) >= tiny
    worst = float((err[normal] / np.abs(exact[normal])).max(initial=0.0))
    if (err[~normal] > tiny).any():
        worst = np.inf
    # the tie rule: a stable sort of -score keeps ties in item order
    masked = np.where(A_rows > 0, -np.inf, rows)
    order = torch.sort(torch.from_numpy(-masked), dim=1,
                       stable=True).indices[:, :SAR_TOP_K].numpy()
    got_all = recs.column("recommendations")
    bad_top = 0
    for r, u in enumerate(users):
        want = order[r][np.isfinite(masked[r, order[r]])]
        bad_top += int(not np.array_equal(got_all[u], want))
    a_s = time.perf_counter() - t0
    del A, S, S_card
    tlc = _tlc_on_card(torch)
    log({"phase": "sar_main", "card": smi, "users": U, "items": I,
         "ratings": len(cols["user"]), "train_ratings": len(kept),
         "train_ratings_above_0_in_f32": len(tu),
         "datagen_seconds": gen_s, "indexer_seconds_1m_rows": index_s,
         "split_seconds": split_w.seconds[0], "fit_seconds": fit_w.seconds[0],
         "recommend_seconds": rec_w.seconds[0],
         "pipeline_seconds": total_s,
         "cooccurrence_gemm_ms": cooc_ms, "score_gemm_ms": score_ms,
         "cooccurrence_tflops": 2.0 * U * I * I / cooc_ms / 1e9,
         "score_tflops": 2.0 * U * I * I / score_ms / 1e9,
         f"ndcg_at_{SAR_TOP_K}": result.get("validationMetric"),
         "peak_device_gb": peak_gb, "c_columns_checked": SAR_CHECK_COLUMNS,
         "c_cells_off": bad_c, "s_cells_off_bitwise": bad_s,
         "score_users_checked": SAR_CHECK_USERS,
         "score_max_rel_err": worst, "top10_off_tie_rule": bad_top,
         "check_seconds": {"c": c_s, "s": s_s, "scores": a_s}, "tlc": tlc,
         "cuts": "none (MovieLens-10M's users, items and ratings)"})
    if bad_c:
        fail(f"sar_main: {bad_c} cells of C's sampled columns differ from "
             f"the exact counts")
    if bad_s:
        fail(f"sar_main: {bad_s} cells of S differ from the host f32 "
             f"recompute")
    if not worst <= SAR_SCORE_RTOL:
        fail(f"sar_main: A @ S {worst} (relative) from the host f64 product")
    if bad_top:
        fail(f"sar_main: {bad_top} users' top {SAR_TOP_K} break the tie rule")
    if not 0.0 < result.get("validationMetric") <= 1.0:
        fail(f"sar_main: NDCG@{SAR_TOP_K} {result.get('validationMetric')}")
    torch.cuda.empty_cache()


def _lasso_times(torch, args) -> dict:
    """The batched lasso's device ms on a LIME call's own inputs: eager
    (the 200 iterations launched one by one) and as a CUDA-graph replay
    (a shape's third call on), and whether the replay is the eager call
    bit for bit."""
    from mmlspark_tpu_torch.ops import lasso

    X, y, reg = args
    lasso.release_graphs()
    w0, b0 = lasso.fit_lasso_batch(X, y, reg, device=DEVICE)
    eager_ms = time_ms(torch, lambda: lasso.release_graphs()
                       or lasso.fit_lasso_batch(X, y, reg, device=DEVICE), 3, 0)
    lasso.fit_lasso_batch(X, y, reg, device=DEVICE)          # captures
    graph_ms = time_ms(torch, lambda: lasso.fit_lasso_batch(
        X, y, reg, device=DEVICE), 10, 1)
    w1, b1 = lasso.fit_lasso_batch(X, y, reg, device=DEVICE)
    lasso.release_graphs()
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "graph_bitwise_eager": bool(torch.equal(w0, w1)
                                        and torch.equal(b0, b1))}


def _lasso_gate(torch, args, result, what: str) -> float:
    """The card's explanations against the port's CPU lasso on the same
    draws and scores, relative to max(1, max |w|)."""
    from mmlspark_tpu_torch.ops import lasso

    X, y, reg = args
    w_card = result[0].cpu()
    w_cpu, _ = lasso.fit_lasso_batch(X, y, reg, device="cpu")
    err = float(((w_card - w_cpu).abs().max(dim=1).values
                 / w_cpu.abs().max(dim=1).values.clamp(min=1.0)).max())
    if not w_card.shape == w_cpu.shape or not err <= LIME_LASSO_TOL:
        fail(f"lime_main {what}: the card's lasso {err} (of max(1, max|w|)) "
             f"from the CPU's")
    return err


def lime_main(torch, smi, best_model, holdout) -> None:
    """``TabularLIME`` over automl_main's best LightGBM model on LIME_ROWS
    holdout rows (nSamples 1,000: 64,000 probes, one batched lasso [64,
    1000, 105]) and ``ImageLIME`` over image_main's ResNet-50
    ``ImageFeaturizer`` (its last feature) on LIME_IMAGES of its seeded
    256x256 images (nSamples 100, cellSize 16, modifier 130; slic's
    assignments on the card, bitwise the host's). Logs seconds and the
    lasso's eager and CUDA-graph ms per batch (``_lasso_times``). Gates:
    the probe scores within LIME_PROBE_TOL of the host f64 traversal;
    every explanation within LIME_LASSO_TOL of max(1, max |w|) of the
    port's CPU lasso on the same draws and scores; the labels of the
    card's slic bitwise the CPU's."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.image import ImageFeaturizer
    from mmlspark_tpu_torch.lime import ImageLIME, TabularLIME, slic
    from mmlspark_tpu_torch.lime import lime as lime_mod
    from mmlspark_tpu_torch.models import from_torch_resnet
    from mmlspark_tpu_torch.ops import lasso

    rng = np.random.default_rng(0)              # image_main's images
    imgs = [rng.integers(0, 256, (IMG_SRC, IMG_SRC, 3), dtype=np.uint8)
            for _ in range(LIME_IMAGES)]
    # the first image's slic on the CPU, the labels' reference, computed on
    # a thread of its own while the phase runs
    cpu_pool = ThreadPoolExecutor(1)
    cpu_slic = cpu_pool.submit(slic, imgs[0], 16.0, 130.0, device="cpu")

    # tabular
    rows = holdout.limit(LIME_ROWS)
    t0 = time.perf_counter()
    with Watch(lime_mod, "_score_probes") as probes_w, \
            Watch(lasso, "fit_lasso_batch") as lasso_w:
        lime = TabularLIME(inputCol="features", outputCol="weights",
                           predictionCol="probability",
                           nSamples=LIME_SAMPLES).set("model", best_model)
        out = lime.fit(holdout).transform(rows)
        weights = np.stack(list(out.column("weights")))
    tab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ys = probes_w.results[0]
    X_probe = np.stack(list(probes_w.calls[0][0][2]))
    n_probe = len(ys)
    tab_args = lasso_w.calls[0][0][:3]
    raw = host_raw32(best_model.booster, X_probe)
    host_p = 1.0 / (1.0 + np.exp(-raw))
    probe_err = float(np.abs(ys - host_p).max())
    tab_err = _lasso_gate(torch, tab_args, lasso_w.results[0], "tabular")
    tab_times = _lasso_times(torch, tab_args)
    tab_check_s = time.perf_counter() - t0

    # image
    t0 = time.perf_counter()
    model = from_torch_resnet(torchvision_resnet_state(torch, 50, 1000, SEED))
    structs = np.empty(LIME_IMAGES, dtype=object)
    structs[:] = [ImageSchema.make(a) for a in imgs]
    feat = ImageFeaturizer(inputCol="image", outputCol="features",
                           scaleFactor=1 / 255,
                           batchSize=IMG_BATCH).set_model(model)
    torch.cuda.synchronize()
    resnet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with Watch(lasso, "fit_lasso_batch") as img_w:
        iout = ImageLIME(inputCol="image", outputCol="weights",
                         predictionCol="features",
                         nSamples=LIME_IMAGE_SAMPLES, cellSize=16.0,
                         modifier=130.0).set("model", feat).transform(
            DataFrame([{"image": structs}]))
        iw = list(iout.column("weights"))
    img_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_args = img_w.calls[0][0][:3]
    img_err = _lasso_gate(torch, img_args, img_w.results[0], "image")
    img_times = _lasso_times(torch, img_args)
    spx = iout.column("superpixels")
    slic_bad = int(not np.array_equal(cpu_slic.result(), spx[0]["labels"]))
    cpu_pool.shutdown()
    img_check_s = time.perf_counter() - t0
    log({"phase": "lime_main", "card": smi, "tabular_rows": LIME_ROWS,
         "tabular_samples": LIME_SAMPLES, "probe_rows": n_probe,
         "lasso_shape_tabular": list(tab_args[0].shape),
         "tabular_seconds": tab_s, "probe_max_abs_diff_vs_host_f64":
         probe_err, "tabular_lasso_rel_err_vs_cpu": tab_err,
         "tabular_lasso_ms": tab_times, "image_rows": LIME_IMAGES,
         "image_samples": LIME_IMAGE_SAMPLES,
         "lasso_shape_image": list(img_args[0].shape),
         "superpixels": [int(s["numClusters"]) for s in spx],
         "image_seconds": img_s, "image_lasso_rel_err_vs_cpu": img_err,
         "image_lasso_ms": img_times, "slic_labels_off_cpu": slic_bad,
         "check_seconds": {"tabular": tab_check_s, "image": img_check_s},
         "resnet_setup_seconds": resnet_s,
         "lime_lasso_route": "eager (each LIME call is its shape's first)"})
    if weights.shape != (LIME_ROWS, tab_args[0].shape[2]) \
            or not np.isfinite(weights).all():
        fail(f"lime_main: tabular weights {weights.shape}")
    if not probe_err <= LIME_PROBE_TOL:
        fail(f"lime_main: probe scores {probe_err} from the host f64 "
             f"traversal")
    if len(iw) != LIME_IMAGES or not all(np.isfinite(w).all() for w in iw):
        fail("lime_main: image importances missing or not finite")
    if slic_bad:
        fail("lime_main: the card's slic labels differ from the CPU's")
    if not (tab_times["graph_bitwise_eager"]
            and img_times["graph_bitwise_eager"]):
        fail("lime_main: a lasso graph replay differs from its eager call")
    torch.cuda.empty_cache()


MESH_MAX_CARDS = 4
MESH_LAUNCH_TIMEOUT = 300     # seconds a launch of ranks may take, then killed
MESH_ITERS_DENSE = 20
MESH_PER_SPLIT_TREES = 3
MESH_ITERS_SPARSE = 2
MESH_VW_PASSES = 2
MESH_F64_REL = 1e-9           # K1/K4 f64 entries against plain, of sum |v|
MESH_RANKER_ITERS = 2         # ranker_main's 20, cut for the script's time
MESH_CKPT_ROWS = 524_288      # the dense cell's first rows
MESH_CKPT_ITERS = 6           # 10 until PR 23: cut for the script's time
MESH_CKPT_EVERY = 4
MESH_CKPT_STOP = 4            # preempted as iteration 4 (0-based) starts


def mesh_launches(torch) -> list:
    """(label, ranks, device, backend) of each run of a mesh phase: NCCL
    with one rank a card on a machine of several; on one card NCCL with
    one rank (NCCL's initialisation and collectives on the card), then two
    ranks sharing ``cuda:0`` over gloo, asked for by name (more than one
    shard's kernels and cross-shard sums)."""
    n = torch.cuda.device_count()
    if n >= 2:
        k = min(n, MESH_MAX_CARDS)
        return [(f"nccl_{k}_cards", k, "cuda", "nccl")]
    return [("nccl_1_rank", 1, "cuda", "nccl"),
            ("gloo_2_ranks_cuda0", 2, "cuda:0", "gloo")]


_MESH_WORK = {}


def mesh_workdir() -> str:
    """A temporary directory for the mesh phases' inputs (``.npy`` files the
    ranks memory-map) and the ranks' rendezvous, removed by ``mesh_cleanup``
    (at exit too)."""
    import atexit
    import tempfile

    if "dir" not in _MESH_WORK:
        _MESH_WORK["dir"] = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        atexit.register(mesh_cleanup)
    return _MESH_WORK["dir"]


def mesh_cleanup() -> None:
    import shutil

    if "dir" in _MESH_WORK:
        shutil.rmtree(_MESH_WORK.pop("dir"), ignore_errors=True)


def mesh_save(name: str, **arrays) -> dict:
    """Write ``arrays`` as ``<name>_<key>.npy`` in the work directory;
    returns {key: path}."""
    import os

    out = {}
    for k, a in arrays.items():
        path = os.path.join(mesh_workdir(), f"{name}_{k}.npy")
        np.save(path, np.asarray(a))
        out[k] = path
    return out


def mesh_load(paths: dict) -> dict:
    return {k: np.load(p, mmap_mode="r") for k, p in paths.items()}


def mesh_spawn(torch, target: str, kwargs: dict, what: str, plan=None,
               timeout: float = MESH_LAUNCH_TIMEOUT):
    """Start every run of ``plan`` (default ``mesh_launches``) at once (on one card the NCCL
    rank and the two gloo ranks share it, and this process's single-card
    fits run beside them); returns a function that waits for them and
    gives each run's (label, each rank's result). A rank that fails, exits
    nonzero or passes ``timeout`` fails the phase (the launch
    kills every rank still running)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from mmlspark_tpu_torch.parallel import launch

    def one(label, world, device, backend):
        t0 = time.perf_counter()
        ranks = launch.spawn(
            target, world, os.path.join(mesh_workdir(), label),
            kwargs=dict(kwargs, label=label), device=device, backend=backend,
            timeout=timeout,
            path=[os.path.dirname(os.path.abspath(__file__))])
        return {"phase": what, "run": label, "ranks": world, "device": device,
                "backend": backend,
                "launch_seconds": time.perf_counter() - t0}, ranks

    plan = plan or mesh_launches(torch)
    pool = ThreadPoolExecutor(len(plan))
    futures = [(run[0], pool.submit(one, *run)) for run in plan]

    def wait() -> list:
        runs = []
        try:
            for label, fut in futures:
                try:
                    info, ranks = fut.result()
                except launch.LaunchError as e:
                    fail(f"{what} ({label}): {e}")
                log(info)
                runs.append((label, ranks))
        finally:
            pool.shutdown(wait=True)
        return runs

    return wait


def f64_entry_check(torch, k64, p64, k32, scale64) -> dict:
    """A kernel's f64 entry against its plain version: counts exact, the
    sums within ``MESH_F64_REL`` of each cell's sum |v|, and the f32 entry
    the f64 one rounded once, bit for bit."""
    err = (k64 - p64).abs()
    ok = bool((err <= MESH_F64_REL * scale64 + 1e-300).all())
    return {"max_abs_err": float(err.max().item()) if err.numel() else 0.0,
            "within_rel": ok, "f32_is_f64_rounded": bool(torch.equal(
                k64.float(), k32))}


def mesh_rank_report(torch, mesh, fit_s: float) -> dict:
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.vw import scan_kernel as vs

    return {"rank": mesh.rank, "device": str(mesh.device),
            "fit_seconds": fit_s, "collectives": pm.stats.calls,
            "collective_bytes": pm.stats.bytes,
            "collective_wall_ms": pm.stats.ms,
            "launches": {"hist": hk.launches, "hist_count": hk.count_launches,
                         "select": sk.launches, "sparse_hist": shk.launches,
                         "vw_scan": vs.launches}}


def mesh_zero_counts() -> None:
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.vw import scan_kernel as vs

    zero_launches()
    shk.launches = vs.launches = 0
    pm.stats.reset()


def mesh_warm(torch, mesh) -> None:
    """One collective before any timed work: the communicator's set-up."""
    from mmlspark_tpu_torch.parallel import mesh as pm

    pm.all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)
    torch.cuda.synchronize(mesh.device)


@contextlib.contextmanager
def fused_body_sync_error(torch, mesh):
    """On NCCL, the sharded fused bodies (``tree._fused_tables``,
    ``sparse._fused_sparse_tables``: the eager tree and the captured one)
    and every replay of their CUDA graphs (``core.graphs.Captured.replay``)
    under ``set_sync_debug_mode("error")``: a host read inside a tree
    raises. The one read a tree after the body, and the ranks' agreement
    after a capture, stay outside. Yields what the replays did: their
    count and the kernel launches made through them, by counter. Gloo
    stages its collectives through host memory: its sharded trees stay
    eager (no replays), and it is not held to this."""
    from mmlspark_tpu_torch.core import graphs as cg
    from mmlspark_tpu_torch.gbdt import sparse, tree

    seen = {"replays": 0, "through": {}}
    nccl = mesh.backend == "nccl"
    orig_replay = cg.Captured.replay

    def replay(self):
        if nccl:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig_replay(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen["replays"] += 1
        for (mod, name), n in self.launches.items():
            key = f"{mod.rsplit('.', 1)[-1]}.{name}"
            seen["through"][key] = seen["through"].get(key, 0) + n
        return out

    def guarded(fn):
        def body(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return body

    bodies = [(tree, "_fused_tables"), (sparse, "_fused_sparse_tables")]
    orig = [(m, n, getattr(m, n)) for m, n in bodies]
    cg.Captured.replay = replay
    if nccl:
        for m, n, fn in orig:
            setattr(m, n, guarded(fn))
    try:
        yield seen
    finally:
        cg.Captured.replay = orig_replay
        for m, n, fn in orig:
            setattr(m, n, fn)


def mesh_dense_params(iters: int):
    """The dense cell's params under a mesh (and its single-card
    references)."""
    from mmlspark_tpu_torch.gbdt import booster as bst

    return bst.TrainParams(objective="binary", num_leaves=31, max_bin=255,
                           num_iterations=iters, min_data_in_leaf=20)


def mesh_dense_rank(mesh, inputs: dict, label: str, iters: int,
                    trees: int) -> dict:
    """One rank of mesh_dense: the fused fit (``iters`` iterations) and the
    per-split fit (``trees`` trees) of the dense cell over the mesh, each
    with its counts from 0; the fused fit's first-split inputs stashed for
    the parent (``mesh_stash``)."""
    import torch

    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import histogram as H

    d = mesh_load(inputs)
    X, y = np.asarray(d["X"], dtype=np.float64), np.asarray(d["y"])
    mesh_warm(torch, mesh)
    out = {"models": {}, "reports": {}}
    for route, n_it, env in (("fused", iters, {}),
                             ("host", trees,
                              {"MMLSPARK_TPU_NO_FUSED_TREE": "1"})):
        params = mesh_dense_params(n_it)
        mesh_zero_counts()
        with Env(**env), PathInputs((H, "compute_histogram"),
                                    (hk, "histogram_count")) as first, \
                fused_body_sync_error(torch, mesh) as seen:
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            b = bst.train(params, X, y, mesh=mesh)
            torch.cuda.synchronize(mesh.device)
            fit_s = time.perf_counter() - t0
        out["reports"][route] = {**mesh_rank_report(torch, mesh, fit_s),
                                 "route": b.route, "trees": n_it,
                                 "replays": seen["replays"],
                                 "through_replays": seen["through"]}
        out["models"][route] = b.to_string()
        if route == "fused":
            out["first_split"] = mesh_stash(torch, first.args, inputs,
                                            "dense", label, mesh.rank)
    return out


def mesh_stash(torch, args: dict, inputs: dict, phase: str, label: str,
               rank: int) -> str:
    """Host copies of a rank's first-split inputs (``PathInputs.args``)
    beside the phase's ``inputs`` (the parent's work directory), for the
    parent to hold and time the f64 entries on once every rank has finished
    (a rank's own timing would share the card with the other runs and the
    parent's fits); returns the file."""
    import os

    path = os.path.join(os.path.dirname(next(iter(inputs.values()))),
                        f"first_{phase}_{label}_{rank}.pt")
    torch.save({k: tuple(x.cpu() if hasattr(x, "cpu") else x for x in a)
                for k, a in args.items()}, path)
    return path


def mesh_unstash(torch, path: str) -> dict:
    import os

    args = torch.load(path)
    os.remove(path)
    return {k: tuple(x.to(DEVICE) if hasattr(x, "to") else x for x in a)
            for k, a in args.items()}


def dense_f64_entries(torch, args: dict) -> dict:
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    res = {}
    if "compute_histogram" in args:
        bins, g, h, mask, b = args["compute_histogram"]
        f, n = bins.shape
        k64 = hk.histogram_cuda(bins, g, h, mask, b, f64=True)
        p64 = hk.histogram_plain(bins, g, h, mask, b, f64=True)
        scale = hk.histogram_plain(bins, g.abs(), h.abs(), mask, b,
                                   f64=True)
        rows = int(mask.sum())
        res["root"] = {
            **f64_entry_check(torch, k64, p64,
                              hk.histogram_cuda(bins, g, h, mask, b), scale),
            "rows": n, "selected": rows,
            "ms": time_ms(torch, lambda: hk.histogram_cuda(
                bins, g, h, mask, b, f64=True)),
            "f32_ms": time_ms(torch, lambda: hk.histogram_cuda(
                bins, g, h, mask, b)),
            "plain_ms": time_ms(torch, lambda: hk.histogram_plain(
                bins, g, h, mask, b, f64=True), 3, 1),
            "bound_ms": bound_ms(rows * (f * 4 + 8) + n + f * b * 24, 0)[0]}
    if "histogram_count" in args:
        cb, cg, ch, cnt, b2, caps = args["histogram_count"]
        f = int(cb.shape[0])
        valid = torch.arange(cb.shape[1], device=cb.device) < cnt.reshape(())
        k64 = hk.histogram_count_cuda(cb, cg, ch, cnt, b2, caps, f64=True)
        p64 = hk.histogram_count_plain(cb, cg, ch, cnt, b2, f64=True)
        scale = hk.histogram_plain(cb, cg.abs(), ch.abs(), valid, b2,
                                   f64=True)
        count = int(cnt.reshape(()).item())
        res["device_count"] = {
            **f64_entry_check(torch, k64, p64, hk.histogram_count_cuda(
                cb, cg, ch, cnt, b2, caps), scale),
            "rows": int(cb.shape[1]), "selected": count,
            "ms": time_ms(torch, lambda: hk.histogram_count_cuda(
                cb, cg, ch, cnt, b2, caps, f64=True)),
            "bound_ms": bound_ms(count * (f * 4 + 8) + 4
                                 + f * b2 * 24, 0)[0]}
    return res


def mesh_sparse_rank(mesh, inputs: dict, label: str, iters: int) -> dict:
    """One rank of mesh_sparse: the sparse cell's fit (``iters``
    iterations) over the mesh, its counts from 0; its first flat
    histogram's inputs stashed for the parent (``mesh_stash``)."""
    import torch

    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import sparse

    d = mesh_load(inputs)
    ds = sparse.SparseDataset(
        indptr=d["indptr"], indices=d["indices"], values=d["values"],
        num_features=int(d["num_features"]), feat_offset=d["feat_offset"],
        thresholds=d["thresholds"], zero_local=d["zero_local"],
        bin_of_nnz=d["bin_of_nnz"], row_of_nnz=d["row_of_nnz"])
    mesh_warm(torch, mesh)
    params = bst.TrainParams(objective="binary", num_leaves=31,
                             num_iterations=iters, learning_rate=0.1,
                             min_data_in_leaf=20)
    mesh_zero_counts()
    with PathInputs((sparse, "sparse_histogram")) as first, \
            fused_body_sync_error(torch, mesh) as seen:
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        b = sparse.train_sparse(params, ds, np.asarray(d["y"]), mesh=mesh)
        torch.cuda.synchronize(mesh.device)
        fit_s = time.perf_counter() - t0
    bounds = sparse.shard_bounds(ds, mesh.size)
    report = {**mesh_rank_report(torch, mesh, fit_s), "route": b.route,
              "rows": int(bounds[mesh.rank + 1] - bounds[mesh.rank]),
              "trees": iters, "replays": seen["replays"],
              "through_replays": seen["through"]}
    return {"model": b.to_string(), "report": report,
            "first_split": mesh_stash(torch, first.args, inputs, "sparse",
                                      label, mesh.rank)}


def sparse_f64_entry(torch, args: dict) -> dict:
    """K4's f64 entry on a rank's first flat histogram's inputs against its
    plain version, timed on the card alone."""
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    data, bin_end = args["sparse_histogram"]
    nnz = int(bin_end[-1].item())
    tb = int(bin_end.shape[0])
    k64 = shk.sparse_histogram_cuda(data, bin_end, f64=True)
    p64 = shk.sparse_histogram_plain(data, bin_end, f64=True)
    scale = shk.sparse_histogram_plain(data.abs(), bin_end, f64=True)
    return {**f64_entry_check(torch, k64, p64,
                              shk.sparse_histogram_cuda(data, bin_end),
                              scale),
            "entries": nnz, "bins": tb,
            "ms": time_ms(torch, lambda: shk.sparse_histogram_cuda(
                data, bin_end, f64=True)),
            "f32_ms": time_ms(torch, lambda: shk.sparse_histogram_cuda(
                data, bin_end)),
            "plain_ms": time_ms(torch, lambda: shk.sparse_histogram_plain(
                data, bin_end, f64=True), 3, 1),
            "bound_ms": bound_ms(12 * nnz + 4 * tb + 24 * tb, 0)[0]}


def mesh_vw_rank(mesh, inputs: dict, label: str, passes: int) -> dict:
    """One rank of mesh_vw: the adaptive and the FTRL fit of vw_main's
    dataset over the mesh (``passes`` per-shard ``vw_scan`` passes, the
    state averaged between passes), each with its counts from 0."""
    import torch

    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset
    from mmlspark_tpu_torch.vw import train_linear

    d = mesh_load(inputs)
    ds = SparseDataset(*(np.asarray(d[k]) for k in ("indices", "values",
                                                    "labels", "weights")))
    mesh_warm(torch, mesh)
    out = {}
    for name, kw in (("adaptive", {}), ("ftrl", {"ftrl": True})):
        cfg = LearnerConfig(num_bits=VW_BITS, loss_function="logistic",
                            num_passes=passes, **kw)
        mesh_zero_counts()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        w, stats = train_linear(cfg, ds, mesh=mesh)
        fit_s = time.perf_counter() - t0
        out[name] = {"weights": w, "loss": [s.average_loss for s in stats],
                     "report": mesh_rank_report(torch, mesh, fit_s)}
    return out


def model_diff(a: str, b: str) -> list:
    """Where two Booster JSON strings differ: (iteration, class, field,
    cells that differ)."""
    ja, jb = json.loads(a), json.loads(b)
    out = [("top", None, k, 1) for k in ja if k != "trees"
           and ja[k] != jb.get(k)]
    if len(ja["trees"]) != len(jb["trees"]):
        return out + [("trees", None, "count", 1)]
    for i, (ga, gb) in enumerate(zip(ja["trees"], jb["trees"])):
        for c, (ta, tb) in enumerate(zip(ga, gb)):
            for fld in ta:
                va, vb = ta[fld], tb.get(fld)
                if va != vb:
                    n = (sum(x != y for x, y in zip(va, vb))
                         if isinstance(va, list) and isinstance(vb, list)
                         and len(va) == len(vb) else 1)
                    out.append((i, c, fld, n))
    return out


def mesh_models_gate(runs, single: dict, key, what: str) -> None:
    """Every rank's model byte for byte the same, and the single-card fit's
    on the same route; a difference prints where and how many cells."""
    for label, ranks in runs:
        models = [key(r) for r in ranks]
        if any(m != models[0] for m in models[1:]):
            fail(f"{what} ({label}): the ranks' models differ")
        for route, want in single.items():
            got = models[0] if not isinstance(models[0], dict) \
                else models[0][route]
            diff = model_diff(got, want)
            log({"phase": what, "run": label, "route": route,
                 "model_equals_single_card": not diff,
                 "differences": diff[:20]})
            if diff:
                fail(f"{what} ({label}, {route}): the mesh model differs "
                     f"from the single-card fit in {len(diff)} places "
                     f"(first {diff[:5]})")


def mesh_f64_gate(entries: dict, what: str, parts=()) -> None:
    for part in parts:
        if part not in entries:
            fail(f"{what}: no f64 entry ({part}) was held")
    for part, e in entries.items():
        if not (e["within_rel"] and e["f32_is_f64_rounded"]):
            fail(f"{what}: the f64 entry ({part}) against its plain version "
                 f"{e['max_abs_err']} (rel {MESH_F64_REL}) or its f32 entry "
                 f"not its f64 sums rounded: {e}")


def replay_gate(rep: dict, nccl: bool, counter: str, what: str) -> None:
    """A rank's sharded fused trees (ROADMAP A9i): on NCCL every tree after
    the eager first ran as a replay of the per-tree CUDA graph (the call
    that captures replays too), with ``counter``'s kernel launching
    through the replays; on gloo none did (its trees stay eager)."""
    want = rep["trees"] - 1 if nccl else 0
    got = rep["through_replays"].get(counter, 0)
    if rep["replays"] != want or (nccl and got < 1) or (not nccl and got):
        fail(f"{what}: {rep['replays']} replays of {rep['trees']} trees "
             f"(want {want}), {got} {counter} launches through them")


def ranker_mesh_params():
    from mmlspark_tpu_torch.gbdt import booster as bst

    return bst.TrainParams(objective="lambdarank", num_leaves=31,
                           max_bin=255, num_iterations=MESH_RANKER_ITERS,
                           early_stopping_round=5)


def ranker_split(d: dict) -> dict:
    """ranker_main's rows as its stage splits them: the training rows, and
    the validation queries' rows as the holdout."""
    rel, qid = np.asarray(d["rel"]), np.asarray(d["qid"])
    val = np.asarray(d["is_val"])
    return {"X": np.asarray(d["X"][~val], dtype=np.float64), "y": rel[~val],
            "groups": qid[~val],
            "valid": (np.asarray(d["X"][val], dtype=np.float64), rel[val]),
            "valid_groups": qid[val]}


def straddling_queries(groups, shards: int) -> int:
    """Queries that cross an edge of ``shards`` equal blocks of the rows
    padded as ``train`` pads them (512 x shards)."""
    from mmlspark_tpu_torch.gbdt import booster as bst

    n = len(groups)
    pad = (-n) % (bst.ROW_MULTIPLE * shards)
    q = np.concatenate([groups, np.full(pad, -1)])
    edges = [len(q) * i // shards for i in range(1, shards)]
    return sum(1 for e in edges if q[e - 1] == q[e])


def ranker_fit(torch, mesh, d: dict):
    """The ranker cell's sharded (or, without ``mesh``, single-card) fit:
    (booster, fit seconds, LambdaRank ms an iteration)."""
    from mmlspark_tpu_torch.gbdt import booster as bst

    with Timed(torch, bst, "grad_hess") as gh:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = bst.train(ranker_mesh_params(), d["X"], d["y"],
                      groups=d["groups"], valid=d["valid"],
                      valid_groups=d["valid_groups"], mesh=mesh)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    return b, fit_s, gh.per_call_ms()


def mesh_ranker_rank(mesh, inputs: dict, label: str) -> dict:
    """One rank of mesh_ranker: the ranker cell's LambdaRank fit
    (``MESH_RANKER_ITERS`` iterations, the 10% holdout scored each one)
    over the mesh, its counts from 0; the queries straddling a block
    edge, whose scores the ranks gather every iteration."""
    import torch

    d = ranker_split(mesh_load(inputs))
    mesh_warm(torch, mesh)
    mesh_zero_counts()
    with fused_body_sync_error(torch, mesh) as seen:
        b, fit_s, gh_ms = ranker_fit(torch, mesh, d)
    return {"model": b.to_string(), "report": {
        **mesh_rank_report(torch, mesh, fit_s), "route": b.route,
        "trees": len(b.trees), "replays": seen["replays"],
        "through_replays": seen["through"],
        "lambdarank_ms_per_iteration": gh_ms,
        "straddling_queries": straddling_queries(d["groups"], mesh.size)}}


def ckpt_params():
    from mmlspark_tpu_torch.gbdt import booster as bst

    return bst.TrainParams(objective="binary", num_leaves=31, max_bin=255,
                           num_iterations=MESH_CKPT_ITERS,
                           min_data_in_leaf=20, bagging_fraction=0.8,
                           bagging_freq=1, seed=7)


def mesh_checkpoint_rank(mesh, inputs: dict, label: str) -> dict:
    """One rank of mesh_checkpoint: the dense cell's first
    ``MESH_CKPT_ROWS`` rows, checkpointed every ``MESH_CKPT_EVERY``
    iterations, preempted as iteration ``MESH_CKPT_STOP`` starts (an
    injected fault at ``TRAIN_STEP`` on every rank) and resumed on the same
    ranks from the file the mesh's first rank wrote."""
    import os

    import torch

    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt.checkpoint import (CheckpointConfig,
                                                    load_checkpoint)

    d = mesh_load(inputs)
    X = np.asarray(d["X"][:MESH_CKPT_ROWS], dtype=np.float64)
    y = np.asarray(d["y"][:MESH_CKPT_ROWS])
    ck = CheckpointConfig(os.path.join(os.path.dirname(inputs["X"]),
                                       f"ckpt_{label}.json"),
                          every_k=MESH_CKPT_EVERY)
    mesh_warm(torch, mesh)

    def preempt(point, **ctx):
        if point == faults.TRAIN_STEP and ctx.get("iteration") == \
                MESH_CKPT_STOP:
            raise faults.InjectedFault("preempted")

    prev = faults.install(preempt)
    t0 = time.perf_counter()
    try:
        bst.train(ckpt_params(), X, y, mesh=mesh, checkpoint=ck)
        stopped = None
    except faults.InjectedFault:
        stopped = int(load_checkpoint(ck.path)["iteration"])
    finally:
        faults.install(prev)
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    b = bst.train(ckpt_params(), X, y, mesh=mesh, checkpoint=ck)
    torch.cuda.synchronize(mesh.device)
    return {"model": b.to_string(), "route": b.route, "stopped_at": stopped,
            "rank": mesh.rank, "preempted_seconds": first_s,
            "resume_seconds": time.perf_counter() - t0}


def mesh_rank(mesh, inputs: dict, label: str) -> dict:
    """One rank of every GBDT and VW mesh phase, in one process (one
    start-up a rank): mesh_dense's, mesh_sparse's, mesh_vw's,
    mesh_ranker's and mesh_checkpoint's fits in turn, each with its counts
    from 0, the card's cached blocks freed between them (the other runs'
    ranks share it)."""
    import torch

    out = {"mesh_dense": mesh_dense_rank(mesh, inputs["dense"], label,
                                         MESH_ITERS_DENSE,
                                         MESH_PER_SPLIT_TREES)}
    torch.cuda.empty_cache()
    out["mesh_sparse"] = mesh_sparse_rank(mesh, inputs["sparse"], label,
                                          MESH_ITERS_SPARSE)
    torch.cuda.empty_cache()
    out["mesh_vw"] = mesh_vw_rank(mesh, inputs["vw"], label, MESH_VW_PASSES)
    torch.cuda.empty_cache()
    out["mesh_ranker"] = mesh_ranker_rank(mesh, inputs["ranker"], label)
    torch.cuda.empty_cache()
    out["mesh_checkpoint"] = mesh_checkpoint_rank(mesh, inputs["dense"],
                                                  label)
    return out


def mesh_phases(torch, inputs: dict, smi, after_ranks=None) -> dict:
    """mesh_dense, mesh_sparse and mesh_vw: every run of ``mesh_launches``
    started once for the three (``mesh_rank``); meanwhile this process
    makes each phase's single-card reference; then each phase's gates on
    its ranks' results, and the work timed alone on the card (the f64
    entries, ``mesh_compaction_ab``), once ``after_ranks()`` (which waits
    for other ranks sharing the card) has returned. Returns each phase's
    launches, f64 entries and timings."""
    pending = mesh_spawn(torch, "chip_smoke:mesh_rank", {"inputs": inputs},
                         "mesh")
    t0 = time.perf_counter()
    dense_single, X, y = mesh_dense_single(torch, inputs["dense"])
    sparse_single = mesh_sparse_single(torch, inputs["sparse"])
    vw_want = mesh_vw_single(torch, inputs["vw"])
    ranker_single = mesh_ranker_single(torch, inputs["ranker"])
    ckpt_single = mesh_checkpoint_single(torch, X, y)
    log({"phase": "mesh", "single_card_seconds": time.perf_counter() - t0})
    runs = pending()
    if after_ranks is not None:
        after_ranks()

    def view(name):
        return [(label, [r[name] for r in ranks]) for label, ranks in runs]

    out = {}
    for name, gates, args in (
            ("mesh_dense", mesh_dense_gates, (dense_single, X, y)),
            ("mesh_sparse", mesh_sparse_gates, (sparse_single,)),
            ("mesh_vw", mesh_vw_gates, (vw_want,)),
            ("mesh_ranker", mesh_ranker_gates, (ranker_single,)),
            ("mesh_checkpoint", mesh_checkpoint_gates, (ckpt_single,))):
        t0 = time.perf_counter()
        out[name] = gates(torch, view(name), *args, smi)
        log({"phase": name, "gates_seconds": time.perf_counter() - t0})
    # the references of the fits on the DNN mesh's data 2 x tensor 2
    out["mesh_dense"]["single_fused"] = dense_single["fused"]
    out["mesh_vw"]["want"] = vw_want
    return out


def mesh_ranker_single(torch, inputs: dict) -> dict:
    """mesh_ranker's reference: the single-card fit of the same rows and
    params (the fused route: the holdout keeps it off the scan)."""
    d = ranker_split(mesh_load(inputs))
    b, fit_s, gh_ms = ranker_fit(torch, None, d)
    check_route(b, "fused", "mesh_ranker single-card")
    log({"phase": "mesh_ranker", "single_card_route": b.route,
         "fit_seconds": fit_s, "iterations": len(b.trees),
         "lambdarank_ms_per_iteration": gh_ms})
    return {"fused": b.to_string()}


def mesh_ranker_gates(torch, runs, single: dict, smi) -> dict:
    """mesh_ranker: the ranker cell (MSLR-WEB30K-shaped, 136 features,
    relevance 0-4, its query lengths over 2,097,152 rows, the 10% holdout)
    through ``train(mesh=, groups=)`` for ``MESH_RANKER_ITERS`` iterations
    in every run of ``mesh_launches``. Gates: every rank's model byte for
    byte and the single-card fit's, K1 launched on each rank, the trees
    replayed on NCCL (``replay_gate``), and at least one query straddling
    a block edge on a run of two ranks or more (its scores gathered every
    iteration). Returns each run's launches, summed over its ranks."""
    mesh_models_gate(runs, single, lambda r: r["model"], "mesh_ranker")
    paths = {}
    for label, ranks in runs:
        for r in ranks:
            rep = r["report"]
            log({"phase": "mesh_ranker", "card": smi, "run": label, **rep})
            if rep["route"] != "fused" or rep["launches"]["hist"] < 1:
                fail(f"mesh_ranker ({label}): route {rep['route']}, K1 "
                     f"launches {rep['launches']['hist']}")
            replay_gate(rep, label.startswith("nccl"), "hist_kernel.launches",
                        f"mesh_ranker ({label}, rank {rep['rank']})")
            p = paths.setdefault(f"mesh_ranker.{label}",
                                 {"hist": 0, "hist_count": 0, "select": 0})
            for k in p:
                p[k] += rep["launches"][k]
        if len(ranks) > 1 and ranks[0]["report"]["straddling_queries"] < 1:
            fail(f"mesh_ranker ({label}): no query straddles a block edge")
    return {"paths": paths}


def mesh_checkpoint_single(torch, X, y) -> dict:
    """mesh_checkpoint's reference: the uninterrupted single-card fit of
    the same rows and params on the fused route (a checkpointed fit's)."""
    from mmlspark_tpu_torch.gbdt import booster as bst

    with Env(**FUSED_ONLY, **NATIVE_OFF):
        t0 = time.perf_counter()
        b = bst.train(ckpt_params(), X[:MESH_CKPT_ROWS], y[:MESH_CKPT_ROWS])
        torch.cuda.synchronize()
    check_route(b, "fused", "mesh_checkpoint single-card")
    log({"phase": "mesh_checkpoint", "single_card_route": b.route,
         "fit_seconds": time.perf_counter() - t0})
    return {"fused": b.to_string()}


def mesh_checkpoint_gates(torch, runs, single: dict, smi) -> dict:
    """mesh_checkpoint: a checkpointed sharded fit of the dense cell's
    first ``MESH_CKPT_ROWS`` rows (bagging, every ``MESH_CKPT_EVERY``
    iterations) preempted and resumed on the same ranks. Gates: the fit
    stopped after the checkpoint of iteration ``MESH_CKPT_STOP``, and
    every rank's resumed model is byte for byte the uninterrupted
    single-card fit."""
    mesh_models_gate(runs, single, lambda r: r["model"], "mesh_checkpoint")
    for label, ranks in runs:
        for r in ranks:
            log({"phase": "mesh_checkpoint", "card": smi, "run": label,
                 **{k: v for k, v in r.items() if k != "model"}})
            if r["stopped_at"] != MESH_CKPT_STOP or r["route"] != "fused":
                fail(f"mesh_checkpoint ({label}): stopped at "
                     f"{r['stopped_at']}, route {r['route']}")
    return {"paths": {}}


def mesh_dense_single(torch, inputs: dict):
    """mesh_dense's references: the single-card fits of the dense cell on
    the fused route (``MESH_ITERS_DENSE`` iterations) and the per-split
    route (``MESH_PER_SPLIT_TREES`` trees); returns them as model strings
    and the cell's X and y."""
    from mmlspark_tpu_torch.gbdt import booster as bst

    d = mesh_load(inputs)
    X, y = np.asarray(d["X"], dtype=np.float64), np.asarray(d["y"])
    single = {}
    for route, iters, env in (("fused", MESH_ITERS_DENSE, FUSED_ONLY),
                              ("host", MESH_PER_SPLIT_TREES, PER_SPLIT)):
        params = mesh_dense_params(iters)
        with Env(**env):
            t0 = time.perf_counter()
            b = bst.train(params, X, y)
            torch.cuda.synchronize()
        check_route(b, route, f"mesh_dense single-card {route}")
        single[route] = b.to_string()
        log({"phase": "mesh_dense", "single_card_route": route,
             "fit_seconds": time.perf_counter() - t0, "iterations": iters})
    return single, X, y


def mesh_dense_gates(torch, runs, single: dict, X, y, smi) -> dict:
    """mesh_dense: the dense cell (2,097,152 x 28 HIGGS-shaped rows, 31
    leaves, 255 bins) through ``train(mesh=)`` in every run of
    ``mesh_launches``: the fused route for ``MESH_ITERS_DENSE`` iterations
    (the sharded body under ``set_sync_debug_mode("error")`` on NCCL) and
    the per-split route for ``MESH_PER_SPLIT_TREES`` trees. Gates: every
    rank's model byte for byte, the single-card fits on the same routes
    byte for byte, K1 launched on each rank (the fused body's mask entry
    alone: it compacts nothing under a mesh; the per-split route's K2 and
    mask entry), K1's f64 entries against their plain versions on each
    rank's first-split inputs (here, alone on the card); then
    ``mesh_compaction_ab``. Returns each run's launches
    (summed over its ranks), the f64 entries' rows and the compaction
    timings."""
    mesh_models_gate(runs, single, lambda r: r["models"], "mesh_dense")
    paths, f64 = {}, {}
    for label, ranks in runs:
        for r in ranks:
            r["f64"] = dense_f64_entries(torch, mesh_unstash(
                torch, r["first_split"]))
            log({"phase": "mesh_dense", "card": smi, "run": label,
                 **{route: rep for route, rep in r["reports"].items()},
                 "f64_entries": r["f64"]})
            mesh_f64_gate(r["f64"], f"mesh_dense ({label}, rank "
                                    f"{r['reports']['fused']['rank']})",
                          ("root",))
            for route, rep in r["reports"].items():
                if rep["route"] != route:
                    fail(f"mesh_dense ({label}): the {route} fit took the "
                         f"{rep['route']!r} route")
                got = {k: rep["launches"][k]
                       for k in ("hist", "hist_count", "select")}
                # the fused body compacts nothing under a mesh (K1's mask
                # entry alone); the per-split route keeps each shard's
                # tiers (K2, then K1's mask entry)
                want = ({"hist": got["hist"]} if route == "fused"
                        else {"hist": got["hist"], "select": got["select"]})
                check_launches(want, f"mesh_dense ({label}, {route})")
                if route == "fused" and got["hist_count"] + got["select"]:
                    fail(f"mesh_dense ({label}): the sharded fused body "
                         f"compacted rows: {got}")
                if route == "fused":
                    replay_gate(rep, label.startswith("nccl"),
                                "hist_kernel.launches",
                                f"mesh_dense ({label}, rank {rep['rank']})")
                p = paths.setdefault(f"mesh_dense.{route}.{label}",
                                     dict.fromkeys(got, 0))
                for k, v in got.items():
                    p[k] += v
        f64[label] = ranks[0]["f64"]
    compaction = mesh_compaction_ab(torch, X, y, single["fused"], smi)
    f64["nccl_1_rank_alone_compacted"] = compaction["f64"]
    return {"paths": paths, "f64": f64, "compaction": compaction}
def mesh_compaction_ab(torch, X, y, single_fused: str, smi) -> dict:
    """The sharded fused fit of the dense cell (``MESH_ITERS_DENSE``
    iterations) on a one-rank NCCL group in this process, alone on the
    card: as the port grows it under a mesh (no compaction, the
    reference's rule under ``psum``: every histogram the shard's full
    width under its mask, K1's mask entry) and with each histogram's rows
    compacted first (``compute_histogram`` wrapped: K2 into a shard-wide
    buffer, then K1's device-count entry over the tiers up to the count).
    Gates: both models byte for byte the single-card fused fit's, K2
    launched only with the wrapper, K1's f64 device-count entry against its
    plain version on the compacted fit's first call. Returns each mode's
    fit seconds and that entry's check."""
    import os

    import torch.distributed as dist

    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import histogram as H
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.gbdt import tree
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    full_width = H.compute_histogram

    def compacted(bins, g, h, mask, num_bins, f64=False):
        n = int(bins.shape[1])
        cnt = mask.sum(dtype=torch.int32).reshape(1)
        b_c, g_c, h_c = sk.select_rows(bins, g, h, mask, n)
        return hk.histogram_count(b_c, g_c, h_c, cnt, num_bins,
                                  tree.device_tier_caps(n), f64=f64)

    params = bst.TrainParams(objective="binary", num_leaves=31, max_bin=255,
                             num_iterations=MESH_ITERS_DENSE,
                             min_data_in_leaf=20)
    secs = {"full_width": [], "compacted": []}
    first = PathInputs((hk, "histogram_count"))
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(mesh_workdir(), 'ab')}",
        world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshSpec(data=1), device=DEVICE)
        mesh_warm(torch, mesh)
        for mode in ("full_width", "compacted"):
            H.compute_histogram = full_width if mode == "full_width" \
                else compacted
            mesh_zero_counts()
            torch.cuda.synchronize()
            with first if mode == "compacted" else contextlib.nullcontext():
                t0 = time.perf_counter()
                b = bst.train(params, X, y, mesh=mesh)
                torch.cuda.synchronize()
                secs[mode].append(time.perf_counter() - t0)
            if b.to_string() != single_fused:
                fail(f"mesh_dense: the sharded fused fit ({mode}) differs "
                     f"from the single-card fit")
            if (sk.launches > 0) != (mode == "compacted"):
                fail(f"mesh_dense: {mode}, K2 launched {sk.launches} times")
    finally:
        H.compute_histogram = full_width
        dist.destroy_process_group()
    out = {f"fit_seconds_{k}": v for k, v in secs.items()}
    # K1's f64 device-count entry, on no fit's path under a mesh: held
    # against its plain version on the compacted fit's first call
    out["f64"] = dense_f64_entries(torch, first.args)
    log({"phase": "mesh_dense", "card": smi, "run": "nccl_1_rank_alone",
         "iterations": MESH_ITERS_DENSE, **out})
    mesh_f64_gate(out["f64"], "mesh_dense (compacted, one NCCL rank)",
                  ("device_count",))
    return out


def mesh_sparse_single(torch, inputs: dict) -> dict:
    """mesh_sparse's reference: the single-card fused fit of the sparse
    cell (``MESH_ITERS_SPARSE`` iterations), as a model string."""
    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.gbdt import sparse

    d = mesh_load(inputs)
    ds = sparse.SparseDataset(
        indptr=d["indptr"], indices=d["indices"], values=d["values"],
        num_features=int(d["num_features"]), feat_offset=d["feat_offset"],
        thresholds=d["thresholds"], zero_local=d["zero_local"],
        bin_of_nnz=d["bin_of_nnz"], row_of_nnz=d["row_of_nnz"])
    params = bst.TrainParams(objective="binary", num_leaves=31,
                             num_iterations=MESH_ITERS_SPARSE,
                             learning_rate=0.1, min_data_in_leaf=20)
    with Env(**FUSED_ONLY):
        t0 = time.perf_counter()
        b = sparse.train_sparse(params, ds, np.asarray(d["y"]))
        torch.cuda.synchronize()
    check_route(b, "fused", "mesh_sparse single-card")
    log({"phase": "mesh_sparse", "single_card_route": "fused",
         "fit_seconds": time.perf_counter() - t0})
    return {"fused": b.to_string()}


def mesh_sparse_gates(torch, runs, single: dict, smi) -> dict:
    """mesh_sparse: the sparse cell (1,000,000 x 2^18, ~50 entries a row,
    31 leaves) through ``train_sparse(mesh=)`` for ``MESH_ITERS_SPARSE``
    iterations in every run of ``mesh_launches``, each rank on its
    nnz-balanced block of its own shape. Gates: every rank's model byte for
    byte and the single-card fused fit's, K4 launched on each rank, K4's
    f64 entry against its plain version on each rank's first flat
    histogram (here, alone on the card)."""
    mesh_models_gate(runs, single, lambda r: r["model"], "mesh_sparse")
    paths, f64 = {}, {}
    for label, ranks in runs:
        for r in ranks:
            rep = r["report"]
            r["f64"] = sparse_f64_entry(torch, mesh_unstash(
                torch, r["first_split"]))
            log({"phase": "mesh_sparse", "card": smi, "run": label, **rep,
                 "f64_entry": r["f64"]})
            mesh_f64_gate({"flat": r["f64"]},
                          f"mesh_sparse ({label}, rank {rep['rank']})")
            if rep["route"] != "fused" or rep["launches"]["sparse_hist"] < 1:
                fail(f"mesh_sparse ({label}): route {rep['route']}, K4 "
                     f"launches {rep['launches']['sparse_hist']}")
            replay_gate(rep, label.startswith("nccl"),
                        "sparse_hist_kernel.launches",
                        f"mesh_sparse ({label}, rank {rep['rank']})")
            p = paths.setdefault(f"mesh_sparse.{label}", {"sparse_hist": 0})
            p["sparse_hist"] += rep["launches"]["sparse_hist"]
        f64[label] = ranks[0]["f64"]
    return {"paths": paths, "f64": f64}


def vw_blocks_averaged(torch, ds, cfg, shards: int) -> np.ndarray:
    """The mesh fit in one process: each pass, every block (``shard_block``
    of a mesh of ``shards``) scanned by ``vw_scan`` from the same state, the
    states averaged."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh
    from mmlspark_tpu_torch.vw import learner as vl
    from mmlspark_tpu_torch.vw import scan_kernel as vs

    blocks = [vl.shard_block(ds, Mesh(shape={"data": shards}, rank=r)).to(
        DEVICE) for r in range(shards)]
    state = vl.init_state(cfg, DEVICE)
    for _ in range(cfg.num_passes):
        parts = []
        for blk in blocks:
            st = [t.clone() for t in state]
            vs.scan_pass_cuda(st, *blk, cfg)
            parts.append(st)
        state = [sum(p[i] for p in parts) / shards
                 for i in range(len(state))]
    return vl.weights_of(cfg, state).cpu().numpy()


def mesh_vw_single(torch, inputs: dict) -> dict:
    """mesh_vw's references: for each shard count of ``mesh_launches`` and
    each fit, one process's ``vw_scan`` fit averaging its per-block passes
    (``vw_blocks_averaged``)."""
    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset

    d = mesh_load(inputs)
    ds = SparseDataset(*(np.asarray(d[k]) for k in ("indices", "values",
                                                    "labels", "weights")))
    want = {}
    # two blocks too: the fits on the DNN mesh's data 2 x tensor 2
    for world in sorted({w for _, w, _, _ in mesh_launches(torch)} | {2}):
        for name, kw in (("adaptive", {}), ("ftrl", {"ftrl": True})):
            cfg = LearnerConfig(num_bits=VW_BITS, loss_function="logistic",
                                num_passes=MESH_VW_PASSES, **kw)
            want[world, name] = vw_blocks_averaged(torch, ds, cfg, world)
    return want


def mesh_vw_gates(torch, runs, want: dict, smi) -> dict:
    """mesh_vw: vw_main's 200,000 Criteo-shaped rows (2^18 bits, logistic)
    through ``train_linear(mesh=)``, the adaptive and the FTRL fit (2
    passes), in every run of ``mesh_launches``. Gates: every rank's weights
    bit for bit, within ``VW_RTOL``/``VW_ATOL`` of one process's ``vw_scan``
    fit averaging its per-block passes the same way, vw_scan launched on
    each rank (one launch a pass)."""
    paths = {}
    for label, ranks in runs:
        shards = len(ranks)
        for name in ("adaptive", "ftrl"):
            want_w = want[shards, name]
            w0 = ranks[0][name]["weights"]
            same = all(np.array_equal(r[name]["weights"].view(np.uint32),
                                      w0.view(np.uint32)) for r in ranks)
            close = bool(np.allclose(w0, want_w, rtol=VW_RTOL,
                                     atol=VW_ATOL))
            for r in ranks:
                log({"phase": "mesh_vw", "card": smi, "run": label,
                     "fit": name, **r[name]["report"],
                     "loss": r[name]["loss"]})
                if r[name]["report"]["launches"]["vw_scan"] != MESH_VW_PASSES:
                    fail(f"mesh_vw ({label}, {name}): vw_scan launched "
                         f"{r[name]['report']['launches']['vw_scan']} times "
                         f"(want {MESH_VW_PASSES})")
                p = paths.setdefault(f"mesh_vw.{label}", {"vw_scan": 0})
                p["vw_scan"] += r[name]["report"]["launches"]["vw_scan"]
            log({"phase": "mesh_vw", "run": label, "fit": name,
                 "ranks_bitwise": same, "close_to_block_average": close,
                 "max_abs_vs_block_average": float(np.abs(w0 - want_w).max())})
            if not same or not close:
                fail(f"mesh_vw ({label}, {name}): ranks bit for bit {same}, "
                     f"within rtol {VW_RTOL} / atol {VW_ATOL} of the "
                     f"per-block average {close}")
    return {"paths": paths}


# ---------------------------------------------------------------------------
# the DNN over a mesh: data, FSDP and tensor-sharded training, ring
# attention, the expert-sharded MoE, the GPipe pipeline, DNNModel(useMesh)
# ---------------------------------------------------------------------------

DNN_MESH_WORLD = 4            # ranks of the DNN mesh phases on a card or four
DNN_MESH_TIMEOUT = 600        # seconds the ranks may take, then killed
MESH_TRAIN_STEPS = 3
MESH_TRAIN_ROWS = TRAIN_ROWS  # 8 rows a step (tools/bench_seq.py's train cell)
MESH_RESNET_ROWS = 16
MESH_RESNET_STEPS = 2
MESH_RING_ROWS = 2
MESH_PIPE_MICRO = 8
MESH_MOE_ROWS = 2
# the reference's mesh tolerances (tests/test_models.py:515) for f32 steps
MESH_LOSS_ATOL = 1e-4
MESH_ACC_ATOL = 1e-6
MESH_PARAM_ATOL = 5e-4
MESH_PARAM_RTOL = 1e-3
# bf16 steps: train_transformer's per-leaf relative L2 (TRAIN_GRAD_REL_L2),
# here of each leaf's change over the steps, and of the loss
MESH_BF16_REL = TRAIN_GRAD_REL_L2
# ResNet-50's f32 step is ill-conditioned: on one card the same batch with
# its rows permuted (f32 sums in another order, as a split batch sums them)
# moves step 1's params past the reference's tolerances (mesh_refs logs
# that distance as ``order_floor``). mesh_resnet starts each step from the
# single card's state and holds the mesh to the reference's tolerances
# or, failing them, to this many times the single card's own distance
# under the permutation from the same state.
MESH_ORDER_RATIO = 2.0
MESH_MOE_ATOL = 1e-5          # tests/test_parallel_pp_ep.py:152
MESH_PIPE_ATOL = 1e-4         # tests/test_parallel_pp_ep.py:88
# the fusion planner over the mesh (parallel/shardplan.py, pipeplan.py):
# the encoder as one fused DNNModel segment over 64 rows (16 a data rank),
# the dense cell's forest segment over N_SCORE rows, and the encoder ->
# Dense head chain in micro-batches of 16 for the pipe
MESH_FUSED_ROWS = 64
MESH_FUSED_PIPE_BATCH = 16
MESH_FUSED_HEAD = 2           # the head's outputs a token
SHARD_ATOL = 1e-5             # __graft_entry__.py:166: sharded vs unsharded


def dnn_mesh_launches(torch) -> list:
    """(label, ranks, device, backend) of each run: NCCL with one rank a
    card on a machine of four or more; on one card NCCL with one rank
    (every axis 1: NCCL's collectives run on the mesh and train paths) and
    four gloo ranks sharing ``cuda:0``, asked for by name."""
    if torch.cuda.device_count() >= DNN_MESH_WORLD:
        return [(f"nccl_{DNN_MESH_WORLD}_cards", DNN_MESH_WORLD, "cuda",
                 "nccl")]
    return [("nccl_1_rank", 1, "cuda", "nccl"),
            (f"gloo_{DNN_MESH_WORLD}_ranks_cuda0", DNN_MESH_WORLD, "cuda:0",
             "gloo")]


def dnn_mesh_specs(world: int) -> dict:
    """Each phase's mesh over ``world`` ranks: the reference's
    dryrun_multichip layout without its data axis (fsdp 2 x tensor 2) for
    the steps, then one axis of 4 for each of the others; a one-rank run
    takes the steps only, every axis 1."""
    if world == 1:
        return {"mesh_train": {"data": 1}, "mesh_resnet": {"data": 1},
                "mesh_fused": {"data": 1}}
    return {"mesh_train": {"fsdp": 2, "tensor": 2},
            "mesh_resnet": {"fsdp": 2, "tensor": 2},
            "mesh_ring": {"seq": world}, "mesh_moe": {"expert": world},
            "mesh_pipe": {"pipe": world}, "mesh_dnn_model": {"data": world},
            "mesh_fused": {"data": world},
            "mesh_fused_pipe": {"data": world // 2, "pipe": 2},
            "mesh_gbdt_axes": {"data": world // 2, "tensor": 2}}


def _dnn_path(name: str) -> str:
    import os

    return os.path.join(mesh_workdir(), f"dnn_{name}")


def _flat_cpu(tree) -> dict:
    from mmlspark_tpu_torch.models import training

    return {k: v.detach().cpu() for k, v in training._flatten(tree).items()}


def _train_model(torch):
    from mmlspark_tpu_torch.models import transformer_encoder

    return transformer_encoder(seq_len=SEQ_LEN, dim=SEQ_DIM, depth=SEQ_DEPTH,
                               num_heads=SEQ_HEADS, vocab_size=SEQ_VOCAB,
                               num_classes=TRAIN_CLASSES, seed=0)


def _train_batches():
    return train_batches(MESH_TRAIN_STEPS, SEED + 40, MESH_TRAIN_ROWS,
                         SEQ_LEN, SEQ_VOCAB, SEQ_VOCAB // TRAIN_CLASSES)


def _resnet_batches():
    rng = np.random.default_rng(SEED + 41)
    return [{"x": rng.normal(size=(MESH_RESNET_ROWS, IMG_SIZE, IMG_SIZE, 3))
             .astype(np.float32),
             "y": rng.integers(0, 1000, MESH_RESNET_ROWS).astype(np.int32)}
            for _ in range(MESH_RESNET_STEPS)]


def _ring_x():
    return np.random.default_rng(SEED + 42).normal(
        size=(MESH_RING_ROWS, SEQ_LEN, SEQ_DIM)).astype(np.float32)


def _ring_model(causal: bool, ring: int = 0):
    from mmlspark_tpu_torch.models import transformer_encoder

    return transformer_encoder(seq_len=SEQ_LEN, dim=SEQ_DIM, depth=SEQ_DEPTH,
                               num_heads=SEQ_HEADS, causal=causal, seed=0,
                               ring_axis="seq" if ring else None,
                               ring_axis_size=ring or None)


def _pipe_blocks(torch):
    from mmlspark_tpu_torch.models import transformer_block

    blocks = []
    for s in range(DNN_MESH_WORLD):
        b = transformer_block(SEQ_DIM, SEQ_HEADS)
        b.init(torch.Generator().manual_seed(SEED + s), (SEQ_LEN, SEQ_DIM))
        blocks.append(b)
    return blocks


def _restart(torch, st, name, prec, i, mesh=None):
    """``st`` with the single card's params and trace after its step ``i``
    (this rank's blocks of them on a mesh)."""
    from mmlspark_tpu_torch.models import training
    from mmlspark_tpu_torch.parallel.mesh import shard_tree

    dev = training._device_of(st.params)
    saved = [training._nest({k: v.to(dev) for k, v in torch.load(
        _dnn_path(f"{name}_{prec}_{i}{part}.pt"), map_location="cpu",
        weights_only=True).items()}) for part in ("", "_trace")]
    if mesh is not None:
        saved = [shard_tree(t, st.shardings, mesh) for t in saved]
    return dataclasses.replace(st, params=saved[0],
                               opt_state={"trace": saved[1]})


def _steps_single(torch, model_module, in_shape, batches, prec, name,
                  restart=None):
    """Single-card steps from ``init_train_state(seed=0)``; saves the params
    and the trace after every step (``_dnn_path``) and returns (losses,
    accuracies, seconds a step). ``restart``: each step after the first
    starts from that run's state after the step before."""
    from mmlspark_tpu_torch.models import matmul_precision, training

    opt = training.make_optimizer(learning_rate=TRAIN_LR, momentum=0.9)
    with matmul_precision(prec):
        st = training.init_train_state(model_module, in_shape, opt, seed=0,
                                       device=DEVICE)
        torch.save(_flat_cpu(st.params), _dnn_path(f"{name}_{prec}_0.pt"))
        step = training.make_train_step(model_module, opt)
        losses, accs, secs = [], [], []
        for i, b in enumerate(batches):
            if restart and i:
                st = _restart(torch, st, restart, prec, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, b)
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
            secs.append(time.perf_counter() - t0)
            torch.save(_flat_cpu(st.params),
                       _dnn_path(f"{name}_{prec}_{i + 1}.pt"))
            torch.save(_flat_cpu(st.opt_state["trace"]),
                       _dnn_path(f"{name}_{prec}_{i + 1}_trace.pt"))
    del st
    torch.cuda.empty_cache()
    return {"loss": losses, "accuracy": accs, "step_seconds": secs}


def _f64_err(torch, got, exact) -> float:
    return float((got.double() - exact).abs().max().item())


def encoder_f64(torch, params, x, causal: bool):
    """The encoder (``_ring_model``'s layers: pre-norm blocks of attention
    and a tanh-GELU MLP, then ``ln_f``) written out in f64 from its
    params: the independent dense computation the ring is held to."""
    p = {k: v.double() for k, v in params.items()}
    b, t, d = x.shape
    dh = d // SEQ_HEADS

    def ln(h, pre):
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        return (h - mu) / torch.sqrt(var + 1e-5) * p[pre + ".scale"] \
            + p[pre + ".bias"]

    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1) \
        if causal else None
    h = x
    for i in range(SEQ_DEPTH):
        a, f = f"block{i}.attn.body.", f"block{i}.mlp.body."
        y = ln(h, a + "ln")
        q, k, v = ((y @ p[a + f"attn.w{c}"]).reshape(b, t, SEQ_HEADS, dh)
                   for c in "qkv")
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / dh ** 0.5
        if mask is not None:
            s = s.masked_fill(mask, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        h = h + o.reshape(b, t, d) @ p[a + "attn.wo"]
        y = ln(h, f + "ln") @ p[f + "fc1.kernel"] + p[f + "fc1.bias"]
        y = 0.5 * y * (1 + torch.tanh((2 / np.pi) ** 0.5
                                      * (y + 0.044715 * y ** 3)))
        h = h + y @ p[f + "fc2.kernel"] + p[f + "fc2.bias"]
    return ln(h, "ln_f")


def dnn_mesh_refs(torch, smi) -> dict:
    """The single-card references of the DNN mesh phases, made before the
    ranks start and kept in the work directory: each step's params of the
    encoder (f32 and bf16) and of ResNet-50 (f32), the ring's f64 dense
    forward and input gradient with the f32 dense forward's errors against
    them, the MoE layer's f32 forward on its tapped input, the pipeline's
    sequential forward and the fused segments' unsharded outputs
    (``fused_refs``)."""
    from mmlspark_tpu_torch.models import matmul_precision
    from mmlspark_tpu_torch.models.resnet import resnet

    t0 = time.perf_counter()
    refs = {"fused": fused_refs(torch, smi), "train": {}}
    model = _train_model(torch)
    for prec in ("float32", "bfloat16"):
        refs["train"][prec] = _steps_single(torch, model.module, (SEQ_LEN,),
                                            _train_batches(), prec, "train")
    del model
    rn = resnet(50, 1000, IMG_SIZE, seed=0)
    refs["resnet"] = _steps_single(torch, rn.module, rn.input_shape,
                                   _resnet_batches(), "float32", "resnet",
                                   restart="resnet")
    perm = np.random.default_rng(SEED + 45).permutation(MESH_RESNET_ROWS)
    permuted = _steps_single(torch, rn.module, rn.input_shape,
                             [{k: v[perm] for k, v in b.items()}
                              for b in _resnet_batches()], "float32",
                             "resnet_perm", restart="resnet")
    refs["resnet"]["order_floor"] = []
    for i in range(MESH_RESNET_STEPS):
        a, b = (torch.load(_dnn_path(f"{n}_float32_{i + 1}.pt"),
                           weights_only=True) for n in ("resnet", "resnet_perm"))
        refs["resnet"]["order_floor"].append({
            "max_abs_err": max(float((a[k] - b[k]).abs().max()) for k in a),
            "loss": abs(permuted["loss"][i] - refs["resnet"]["loss"][i])})
    del rn
    refs["ring"] = {}
    x = torch.from_numpy(_ring_x()).to(DEVICE)
    for causal in (False, True):
        m = _ring_model(causal)
        params = m.device_params(x.device)
        out = {}
        with torch.enable_grad():
            xi = x.double().requires_grad_(True)
            y = encoder_f64(torch, params, xi, causal)
            (g,) = torch.autograd.grad((y * y).sum(), xi)
            out["float64"] = (y.detach(), g.detach())
            del y, g
            xi = x.clone().requires_grad_(True)
            with matmul_precision("float32"):
                y = torch.func.functional_call(m.module, params, (xi,))
                (g,) = torch.autograd.grad((y * y).sum(), xi)
            out["float32"] = (y.detach(), g.detach())
        y64, g64 = out["float64"]
        torch.save({"y": y64.cpu(), "g": g64.cpu()},
                   _dnn_path(f"ring_{causal}.pt"))
        refs["ring"][causal] = {
            "dense_f32_err": _f64_err(torch, out["float32"][0], y64),
            "dense_f32_grad_err": _f64_err(torch, out["float32"][1], g64)}
        del out, y64, g64, m, params
    del x
    model = moe_model(torch)
    ids = torch.from_numpy(np.random.default_rng(SEED + 43).integers(
        0, SEQ_VOCAB, (MESH_MOE_ROWS, SEQ_LEN))).to(DEVICE)
    with matmul_precision("float32"):
        params = model.device_params(ids.device)
        x = model.apply_taps(ids, ["block0/mlp/body/ln"],
                             params=params)["block0/mlp/body/ln"]
        moe = model.module.get_submodule("block0.mlp.body.moe")
        with torch.no_grad():
            y = torch.func.functional_call(moe, {
                k.split("block0.mlp.body.moe.")[1]: v for k, v in params.items()
                if k.startswith("block0.mlp.body.moe.")}, (x,))
    torch.save({"x": x.cpu(), "y": y.cpu(), "params": _flat_cpu(
        dict(moe.named_parameters()))}, _dnn_path("moe.pt"))
    del model, ids, params, x, y
    blocks = _pipe_blocks(torch)
    xs = torch.from_numpy(np.random.default_rng(SEED + 44).normal(
        size=(MESH_PIPE_MICRO, 1, SEQ_LEN, SEQ_DIM)).astype(np.float32))
    with matmul_precision("float32"), torch.no_grad():
        h = xs.to(DEVICE)
        for b in blocks:
            b.to(DEVICE)
            h = torch.stack([b(h[i]) for i in range(h.shape[0])])
    torch.save({"xs": xs, "y": h.cpu()}, _dnn_path("pipe.pt"))
    del blocks, h
    torch.cuda.empty_cache()
    refs["seconds"] = time.perf_counter() - t0
    log({"phase": "mesh_refs", "card": smi, "seconds": refs["seconds"],
         "train": refs["train"], "resnet": refs["resnet"],
         "ring": {str(k): v for k, v in refs["ring"].items()}})
    return refs


# -- one rank


def _blocks_check(torch, local, shardings, ref_path, mesh, atol, rtol):
    """This rank's blocks of each leaf against the same blocks of the saved
    single-card leaves: the worst |d| and whether each is within atol +
    rtol |want|."""
    from mmlspark_tpu_torch.models import training

    want = torch.load(ref_path, map_location="cpu", weights_only=True)
    specs = training._flatten(shardings)
    worst, leaf, ok = 0.0, None, True
    for name, t in training._flatten(local).items():
        w = specs[name].local(want[name], mesh)
        d = (t.detach().cpu() - w).abs()
        if d.numel() and float(d.max()) >= worst:
            worst, leaf = float(d.max()), name
        ok = ok and bool((d <= atol + rtol * w.abs()).all())
    return {"max_abs_err": worst, "worst_leaf": leaf, "within": ok}


def _update_rel(torch, local, shardings, ref_path, init_path, mesh) -> dict:
    """Per leaf, the relative L2 distance of this rank's change of the
    params since step 0 from the single-card run's, on the rank's blocks;
    the worst leaf."""
    from mmlspark_tpu_torch.models import training

    want = torch.load(ref_path, map_location="cpu", weights_only=True)
    init = torch.load(init_path, map_location="cpu", weights_only=True)
    specs = training._flatten(shardings)
    worst, leaf = 0.0, None
    for name, t in training._flatten(local).items():
        w0 = specs[name].local(init[name], mesh).double()
        dw = specs[name].local(want[name], mesh).double() - w0
        dg = t.detach().cpu().double() - w0
        if float(dw.norm()) == 0.0:
            continue
        rel = float((dg - dw).norm() / dw.norm())
        if rel >= worst:
            worst, leaf = rel, name
    return {"max_rel_l2": worst, "worst_leaf": leaf}


class _AttnRecorder:
    """Counts and records K5/K6/K7 on this rank: each call's q shape, and
    the first call's inputs (stashed for gate (c))."""

    def __init__(self):
        from mmlspark_tpu_torch.models import flash_kernel as fk

        self.fk = fk
        self.fwd_shapes, self.bwd_shapes = set(), set()
        self.first = {}
        self._orig = (fk.flash_attention_cuda, fk.flash_attention_bwd_cuda)

    def __enter__(self):
        fk = self.fk
        fwd, bwd = self._orig

        def k5(q, k, v, causal=False, lse=False):
            self.fwd_shapes.add(tuple(q.shape))
            if "fwd" not in self.first:
                self.first["fwd"] = [x.detach().clone() for x in (q, k, v)]
            return fwd(q, k, v, causal, lse)

        def k67(q, k, v, o, lse, do, causal=False):
            self.bwd_shapes.add(tuple(q.shape))
            if "bwd" not in self.first:
                self.first["bwd"] = [x.detach().clone()
                                     for x in (q, k, v, o, lse, do)]
            return bwd(q, k, v, o, lse, do, causal)

        fk.flash_attention_cuda, fk.flash_attention_bwd_cuda = k5, k67
        return self

    def __exit__(self, *exc):
        self.fk.flash_attention_cuda, self.fk.flash_attention_bwd_cuda = \
            self._orig
        return False


def _mesh_steps(torch, mesh, module, in_shape, batches, prec, name,
                compare, restart=False):
    """This rank's sharded steps from ``init_train_state(seed=0, mesh=)``;
    after each, its blocks against the single-card step's (``compare``:
    "blocks" within atol/rtol, "update" the relative L2 of the change).
    Returns the metrics, seconds a step, comparisons, the final state."""
    from mmlspark_tpu_torch.models import matmul_precision, training
    from mmlspark_tpu_torch.parallel import mesh as pm

    opt = training.make_optimizer(learning_rate=TRAIN_LR, momentum=0.9)
    out = {"loss": [], "accuracy": [], "step_seconds": [], "params": []}
    with matmul_precision(prec):
        st = training.init_train_state(module, in_shape, opt, seed=0,
                                       mesh=mesh)
        step = training.compile_train_step(module, opt, mesh=mesh)
        pm.stats.reset()
        for i, b in enumerate(batches):
            if restart and i:
                st = _restart(torch, st, name, prec, i, mesh)
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            st, m = step(st, b)
            if i == 0:
                out["first_step"] = [t.clone() for t in
                                     _flat_cpu(st.params).values()]
            out["loss"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["step_seconds"].append(time.perf_counter() - t0)
            ref = _dnn_path(f"{name}_{prec}_{i + 1}.pt")
            if compare == "blocks":
                out["params"].append(_blocks_check(
                    torch, st.params, st.shardings, ref, mesh,
                    MESH_PARAM_ATOL, MESH_PARAM_RTOL))
            else:
                out["params"].append(_update_rel(
                    torch, st.params, st.shardings, ref,
                    _dnn_path(f"{name}_{prec}_0.pt"), mesh))
    out["collectives"] = {"calls": pm.stats.calls, "bytes": pm.stats.bytes,
                          "host_ms": pm.stats.ms}
    return out, st


def _rank_train(torch, mesh) -> dict:
    """mesh_train on this rank: (a) f32 steps, blocks against the single
    card's; (b) bf16 steps through K5-K7 on the rank's heads, counted, the
    change of every leaf against the single card's; (d) the bf16 steps
    again, the same bits."""
    model = _train_model(torch)
    out = {}
    zero_attn_launches()
    out["f32"], _ = _mesh_steps(torch, mesh, model.module, (SEQ_LEN,),
                                _train_batches(), "float32", "train", "blocks")
    out["f32"]["launches"] = read_attn_launches()
    zero_attn_launches()
    with _AttnRecorder() as rec:
        out["bf16"], st = _mesh_steps(torch, mesh, model.module, (SEQ_LEN,),
                                      _train_batches(), "bfloat16", "train",
                                      "update")
    out["bf16"]["launches"] = read_attn_launches()
    out["bf16"]["k5_q_shapes"] = sorted(rec.fwd_shapes)
    out["bf16"]["k67_q_shapes"] = sorted(rec.bwd_shapes)
    if mesh.rank == 0:
        torch.save({k: [x.cpu() for x in v] for k, v in rec.first.items()},
                   _dnn_path(f"attn_stash_{mesh.axis_size('world')}.pt"))
    first = out["bf16"].pop("first_step")
    out["f32"].pop("first_step")
    del st
    # (d) the first step again
    again, st = _mesh_steps(torch, mesh, model.module, (SEQ_LEN,),
                            _train_batches()[:1], "bfloat16", "train",
                            "update")
    out["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        first, _flat_cpu(st.params).values()))
    out["repeat_loss"] = again["loss"]
    del st, first, again
    torch.cuda.empty_cache()
    return out


def _rank_resnet(torch, mesh) -> dict:
    from mmlspark_tpu_torch.models.resnet import resnet

    rn = resnet(50, 1000, IMG_SIZE, seed=0)
    out, st = _mesh_steps(torch, mesh, rn.module, rn.input_shape,
                          _resnet_batches(), "float32", "resnet", "blocks",
                          restart=True)
    out.pop("first_step")
    del st, rn
    torch.cuda.empty_cache()
    return out


def _rank_ring(torch, mesh) -> dict:
    """The encoder forward and the input gradient of sum(y * y) with
    ``ring_axis="seq"`` on this rank's block of the sequence, f32; errors
    of the rank's blocks against the single card's f64 dense ones."""
    from mmlspark_tpu_torch.models import activation_sharding, matmul_precision
    from mmlspark_tpu_torch.parallel import mesh as pm

    n, me = mesh.axis_size("seq"), mesh.coord("seq")
    t = SEQ_LEN // n
    x = torch.from_numpy(_ring_x()[:, me * t:(me + 1) * t]).to(mesh.device)
    out = {"causal": {}}
    for causal in (False, True):
        m = _ring_model(causal, ring=n)
        params = m.device_params(mesh.device)
        want = torch.load(_dnn_path(f"ring_{causal}.pt"), map_location="cpu",
                          weights_only=True)
        xi = x.clone().requires_grad_(True)
        pm.stats.reset()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        with matmul_precision("float32"), activation_sharding(mesh), \
                torch.enable_grad():
            y = torch.func.functional_call(m.module, params, (xi,))
            (g,) = torch.autograd.grad((y * y).sum(), xi)
        torch.cuda.synchronize(mesh.device)
        secs = time.perf_counter() - t0
        blk = slice(me * t, (me + 1) * t)
        out["causal"][causal] = {
            "seconds": secs, "collectives": pm.stats.calls,
            "collective_bytes": pm.stats.bytes,
            "ring_err": _f64_err(torch, y.detach().cpu(), want["y"][:, blk]),
            "ring_grad_err": _f64_err(torch, g.cpu(), want["g"][:, blk]),
            "finite": bool(torch.isfinite(y).all() and torch.isfinite(g).all())}
        del m, params, y, g, xi, want
    torch.cuda.empty_cache()
    return out


def _rank_moe(torch, mesh) -> dict:
    from mmlspark_tpu_torch.models import activation_sharding, matmul_precision
    from mmlspark_tpu_torch.models.moe import MoE, expert_shardings
    from mmlspark_tpu_torch.parallel.mesh import shard_tree

    ref = torch.load(_dnn_path("moe.pt"), map_location="cpu", weights_only=True)
    moe = MoE(MOE_EXPERTS, hidden=4 * SEQ_DIM, capacity_factor=MOE_CAPACITY)
    moe.init(torch.Generator(), (SEQ_LEN, SEQ_DIM))
    params = {k: v.to(mesh.device) for k, v in ref["params"].items()}
    local = shard_tree(params, expert_shardings(mesh, params), mesh)
    x = ref["x"].to(mesh.device)
    with matmul_precision("float32"), activation_sharding(mesh), \
            torch.no_grad():
        y = torch.func.functional_call(moe, local, (x,))
    return {"w1_block": tuple(local["w1"].shape),
            "max_abs_err": float((y.cpu() - ref["y"]).abs().max())}


def _rank_pipe(torch, mesh) -> dict:
    from mmlspark_tpu_torch.models import matmul_precision
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply, stack_stage_params)

    ref = torch.load(_dnn_path("pipe.pt"), map_location="cpu", weights_only=True)
    blocks = _pipe_blocks(torch)
    block = blocks[0].to(mesh.device)
    stacked = stack_stage_params([
        {k: v.detach().to(mesh.device) for k, v in b.named_parameters()}
        for b in blocks])

    def stage_fn(p, x):
        return torch.func.functional_call(block, p, (x,))

    pm.stats.reset()
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    with matmul_precision("float32"), torch.no_grad():
        y = pipeline_apply(stage_fn, stacked, ref["xs"].to(mesh.device), mesh)
    torch.cuda.synchronize(mesh.device)
    return {"seconds": time.perf_counter() - t0,
            "collectives": pm.stats.calls,
            "max_abs_err": float((y.cpu() - ref["y"]).abs().max())}


def _rank_dnn_model(torch, mesh) -> dict:
    """transformer_main's stage under a ``MeshContext`` of data=world: its
    256 rows, batches of 64 split 16 a rank and gathered; against the
    single card's output, by transformer_main's gate."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, transformer_encoder
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.parallel.mesh import MeshContext

    model = transformer_encoder(seq_len=SEQ_LEN, dim=SEQ_DIM, depth=SEQ_DEPTH,
                                num_heads=SEQ_HEADS, vocab_size=SEQ_VOCAB,
                                seed=0)
    ids = np.random.default_rng(0).integers(0, SEQ_VOCAB, (SEQ_ROWS, SEQ_LEN))
    df = DataFrame.from_dict({"tokens": ids}, num_partitions=2)
    stage = DNNModel(inputCol="tokens", outputCol="emb", batchSize=SEQ_BATCH)
    stage.set_model(model)
    MeshContext.set(mesh)
    try:
        zero_attn_launches()
        pm.stats.reset()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        out = _emb(stage.transform(df))
        secs = time.perf_counter() - t0
        launches = read_attn_launches()
        unfused = stage.device_fn(df.schema) is None
    finally:
        MeshContext.reset()
    want = np.load(_dnn_path("main_out.npy"), mmap_mode="r")
    cos = row_cosines(out, want)
    diff = np.abs(out - want)
    return {"seconds": secs, "launches": launches, "unfused": unfused,
            "collectives": pm.stats.calls, "collective_bytes": pm.stats.bytes,
            "shape": out.shape, "cos_gap": float(1.0 - cos.min()),
            "max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean())}


def _fused_encoder(batch: int, head: bool = False):
    """transformer_main's encoder as a ``DNNModel`` over ``MESH_FUSED_ROWS``
    seeded rows of token ids in one partition, fused (with a Dense head
    over its output, ``head``: the chain the pipe cuts); returns (fused
    model, frame)."""
    import torch

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.models import (Dense, DNNModel, FunctionModel,
                                           Sequential, transformer_encoder)

    model = transformer_encoder(seq_len=SEQ_LEN, dim=SEQ_DIM, depth=SEQ_DEPTH,
                                num_heads=SEQ_HEADS, vocab_size=SEQ_VOCAB,
                                seed=0)
    stages = [DNNModel(inputCol="tokens", outputCol="emb", batchSize=batch)
              .set_model(model)]
    if head:
        mod = Sequential([("head", Dense(MESH_FUSED_HEAD))], name="head")
        mod.init(torch.Generator().manual_seed(SEED + 47), (SEQ_LEN, SEQ_DIM))
        stages.append(DNNModel(inputCol="emb", outputCol="logits",
                               batchSize=batch).set_model(
            FunctionModel(mod, (SEQ_LEN, SEQ_DIM), name="head")))
    ids = np.random.default_rng(SEED + 46).integers(
        0, SEQ_VOCAB, (MESH_FUSED_ROWS, SEQ_LEN))
    df = DataFrame.from_dict({"tokens": ids}, num_partitions=1)
    return PipelineModel(stages).fuse(), df


def _fused_gbdt():
    """The dense cell's classifier (saved by ``main``) fused over the
    N_SCORE rows it was scored on, in one partition."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel, PipelineStage

    model = PipelineStage.load(_dnn_path("gbdt_model"))
    df = DataFrame.from_dict({"features": np.load(_dnn_path("gbdt_X.npy"))},
                             num_partitions=1)
    return PipelineModel([model]).fuse(), df


_GBDT_COLS = ("rawPrediction", "probability")


def _gbdt_out(df) -> dict:
    return {c: np.stack(list(df.column(c))) for c in _GBDT_COLS}


def _timed(torch, fn, device=None):
    """(``fn()``, its wall seconds), the card synchronised around it."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def fused_save_gbdt(model, X) -> None:
    """Keep the dense cell's classifier and its scoring rows for the fused
    mesh phases (``_fused_gbdt``)."""
    model.save(_dnn_path("gbdt_model"))
    np.save(_dnn_path("gbdt_X.npy"), np.ascontiguousarray(X, np.float32))


def fused_refs(torch, smi) -> dict:
    """The fused mesh phases' single-card references, unsharded on this
    card: the encoder segment's output over its 64 rows and the forest
    segment's over N_SCORE rows, each timed after a warm call."""
    out = {}
    fused, df = _fused_encoder(MESH_FUSED_ROWS)
    fused.transform(df)
    emb, out["encoder_seconds"] = _timed(torch, lambda: _emb(
        fused.transform(df)))
    np.save(_dnn_path("fused_enc.npy"), emb)
    del fused, emb
    fused, df = _fused_gbdt()
    fused.transform(df)
    got, out["gbdt_seconds"] = _timed(torch, lambda: _gbdt_out(
        fused.transform(df)))
    for c, v in got.items():
        np.save(_dnn_path(f"fused_gbdt_{c}.npy"), v)
    log({"phase": "mesh_fused_refs", "card": smi, **out})
    return out


def _diff(got: np.ndarray, want: np.ndarray) -> dict:
    return {"max_abs_diff": float(np.abs(got.astype(np.float64)
                                         - want).max()),
            "bitwise": bool(np.array_equal(got, want))}


def _fused_report(torch, fused, mesh_stats) -> dict:
    from mmlspark_tpu_torch.parallel import mesh as pm

    st = fused.fusion_stats()
    return {"fallbacks": st["fallbacks"], "sharding": st.get("sharding"),
            "pipeline": st.get("pipeline"), "collectives": pm.stats.calls,
            "collective_bytes": pm.stats.bytes,
            "collective_host_ms": pm.stats.ms, **mesh_stats}


def _rank_fused(torch, mesh) -> dict:
    """mesh_fused on this rank: the encoder segment data-sharded (K5 on the
    rank's rows), the forest segment data-sharded over the same mesh and
    feature-sharded over data x tensor 2, each against the single card's
    unsharded output. A one-rank mesh has one shard: the unsharded path."""
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, barrier, make_mesh

    world = mesh.axis_size("world")
    out = {}
    fused, df = _fused_encoder(MESH_FUSED_ROWS)
    fused.set_mesh(mesh)
    fused.set_tuning(sharding={"DNNModel": "data"})
    fused.transform(df)
    zero_attn_launches()
    pm.stats.reset()
    with _AttnRecorder() as rec:
        emb, secs = _timed(torch, lambda: _emb(fused.transform(df)),
                           mesh.device)
    out["encoder"] = {
        "seconds": secs, "launches": read_attn_launches()["flash_attn"],
        "k5_q_shapes": sorted(rec.fwd_shapes),
        **_diff(emb, np.load(_dnn_path("fused_enc.npy"))),
        **_fused_report(torch, fused, {})}
    if mesh.rank == 0 and "fwd" in rec.first:
        torch.save([x.cpu() for x in rec.first["fwd"]],
                   _dnn_path(f"fused_attn_stash_{world}.pt"))
    del fused, emb, rec
    torch.cuda.empty_cache()
    fused, df = _fused_gbdt()
    want = {c: np.load(_dnn_path(f"fused_gbdt_{c}.npy")) for c in _GBDT_COLS}
    specs = [("data", mesh)]
    if world > 1:
        specs.append(("feature", make_mesh(
            MeshSpec(data=world // 2, tensor=2), device=mesh.device,
            backend=mesh.backend)))
    for spec, m in specs:
        barrier(m)
        fused.set_mesh(m)
        fused.set_tuning(sharding={"LightGBMClassificationModel": spec})
        fused.transform(df)
        pm.stats.reset()
        got, secs = _timed(torch, lambda: _gbdt_out(fused.transform(df)),
                           mesh.device)
        diffs = {c: _diff(got[c], want[c]) for c in _GBDT_COLS}
        out[f"gbdt_{spec}"] = {
            "seconds": secs, "max_abs_diff": max(
                d["max_abs_diff"] for d in diffs.values()),
            "bitwise": all(d["bitwise"] for d in diffs.values()),
            **_fused_report(torch, fused, {})}
    return out


def _rank_fused_pipe(torch, mesh) -> dict:
    """mesh_fused_pipe on this rank: the encoder -> Dense head chain in
    micro-batches of 16, serial on this rank and then pipelined over data
    x pipe 2 (stage 0 the encoder, K5 on its ranks; stage 1 the head),
    bitwise the serial chain."""
    from mmlspark_tpu_torch.parallel import mesh as pm

    fused, df = _fused_encoder(MESH_FUSED_PIPE_BATCH, head=True)
    fused.transform(df)

    def both(frame):
        return {"emb": _emb(frame),
                "logits": np.stack(list(frame.column("logits")))}

    want, serial_s = _timed(torch, lambda: both(fused.transform(df)),
                            mesh.device)
    fused.set_mesh(mesh)
    fused.set_tuning(pipe_depth=2)
    fused.transform(df)
    zero_attn_launches()
    pm.stats.reset()
    with _AttnRecorder() as rec:
        got, secs = _timed(torch, lambda: both(fused.transform(df)),
                           mesh.device)
    return {"seconds": secs, "serial_seconds": serial_s,
            "launches": read_attn_launches()["flash_attn"],
            "k5_q_shapes": sorted(rec.fwd_shapes),
            "bitwise": all(np.array_equal(got[k], want[k]) for k in want),
            "max_abs_diff": max(_diff(got[k], want[k])["max_abs_diff"]
                                for k in want),
            **_fused_report(torch, fused, {})}


def _rank_gbdt_axes(torch, mesh) -> dict:
    """mesh_gbdt_axes on one rank of data 2 x tensor 2 (ROADMAP A9k): the
    dense cell's fused fit as mesh_dense runs it and mesh_vw's two fits,
    each rank on the block of its data coordinate, summed over its data
    group; the tensor replicas of a block compute the same. Reads the
    inputs mesh_phases saved in the work directory (skipped without
    them)."""
    import os

    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset
    from mmlspark_tpu_torch.vw import train_linear

    work = _MESH_WORK["dir"]
    names = {"dense": ("X", "y"),
             "vw": ("indices", "values", "labels", "weights")}
    paths = {f"{a}_{k}": os.path.join(work, f"{a}_{k}.npy")
             for a, keys in names.items() for k in keys}
    if not all(os.path.exists(v) for v in paths.values()):
        return {"skipped": True}
    d = mesh_load(paths)
    X = np.asarray(d["dense_X"], dtype=np.float64)
    y = np.asarray(d["dense_y"])
    coords = {a: mesh.coord(a) for a in ("data", "tensor")}
    mesh_zero_counts()
    with fused_body_sync_error(torch, mesh) as seen:
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        b = bst.train(mesh_dense_params(MESH_ITERS_DENSE), X, y, mesh=mesh)
        torch.cuda.synchronize(mesh.device)
        fit_s = time.perf_counter() - t0
    del X, y
    out = {"coords": coords, "model": b.to_string(), "vw": {},
           "report": {**mesh_rank_report(torch, mesh, fit_s),
                      "route": b.route, "trees": MESH_ITERS_DENSE,
                      "replays": seen["replays"],
                      "through_replays": seen["through"]}}
    ds = SparseDataset(*(np.asarray(d[f"vw_{k}"]) for k in names["vw"]))
    for name, kw in (("adaptive", {}), ("ftrl", {"ftrl": True})):
        cfg = LearnerConfig(num_bits=VW_BITS, loss_function="logistic",
                            num_passes=MESH_VW_PASSES, **kw)
        mesh_zero_counts()
        t0 = time.perf_counter()
        w, _ = train_linear(cfg, ds, mesh=mesh)
        out["vw"][name] = {"weights": w, "report": mesh_rank_report(
            torch, mesh, time.perf_counter() - t0)}
    return out


_DNN_RANK_PHASES = {"mesh_train": _rank_train, "mesh_resnet": _rank_resnet,
                    "mesh_ring": _rank_ring, "mesh_moe": _rank_moe,
                    "mesh_pipe": _rank_pipe, "mesh_dnn_model": _rank_dnn_model,
                    "mesh_fused": _rank_fused,
                    "mesh_fused_pipe": _rank_fused_pipe,
                    "mesh_gbdt_axes": _rank_gbdt_axes}


def dnn_mesh_rank(mesh, label: str, work: str) -> dict:
    """One rank of every DNN mesh phase (one start-up a rank): each phase's
    mesh made from the same world in turn (``dnn_mesh_specs``), its work
    and its comparisons with the single-card references."""
    import torch

    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, barrier, make_mesh

    _MESH_WORK["dir"] = work
    world = mesh.axis_size("world")
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    for phase, spec in dnn_mesh_specs(world).items():
        m = make_mesh(MeshSpec(**spec), device=mesh.device,
                      backend=mesh.backend)
        barrier(m)                  # the communicators' set-up, untimed
        torch.cuda.synchronize(m.device)
        t0 = time.perf_counter()
        out[phase] = _DNN_RANK_PHASES[phase](torch, m)
        out[phase]["phase_seconds"] = time.perf_counter() - t0
        out[phase]["mesh_shape"] = {k: v for k, v in m.shape.items() if v > 1}
        torch.cuda.empty_cache()
    return out


# -- the gates


def _mesh_train_gates(torch, runs, refs, smi) -> dict:
    want32, want16 = refs["train"]["float32"], refs["train"]["bfloat16"]
    launches = {}
    for label, ranks in runs:
        world = len(ranks)
        heads = SEQ_HEADS // (2 if world > 1 else 1)
        rows = MESH_TRAIN_ROWS // (2 if world > 1 else 1)
        for r in ranks:
            got = r["mesh_train"]
            log({"phase": "mesh_train", "card": smi, "run": label,
                 "rank": r["rank"], "mesh_shape": got["mesh_shape"],
                 "f32_step_seconds": got["f32"]["step_seconds"],
                 "bf16_step_seconds": got["bf16"]["step_seconds"],
                 "single_card_f32_step_seconds": want32["step_seconds"],
                 "single_card_bf16_step_seconds": want16["step_seconds"],
                 "f32_collectives": got["f32"]["collectives"],
                 "bf16_collectives": got["bf16"]["collectives"],
                 "launches": got["bf16"]["launches"],
                 "k5_q_shapes": got["bf16"]["k5_q_shapes"],
                 "k67_q_shapes": got["bf16"]["k67_q_shapes"],
                 "f32_params": got["f32"]["params"],
                 "bf16_params": got["bf16"]["params"],
                 "loss": got["f32"]["loss"], "bf16_loss": got["bf16"]["loss"],
                 "repeat_bitwise": got["repeat_bitwise"]})
            what = f"mesh_train ({label}, rank {r['rank']})"
            for i in range(MESH_TRAIN_STEPS):
                if abs(got["f32"]["loss"][i] - want32["loss"][i]) > MESH_LOSS_ATOL \
                        or abs(got["f32"]["accuracy"][i] - want32["accuracy"][i]) \
                        > MESH_ACC_ATOL:
                    fail(f"{what} (a): f32 step {i + 1} loss/accuracy "
                         f"{got['f32']['loss'][i]}/{got['f32']['accuracy'][i]} "
                         f"against the single card's {want32['loss'][i]}/"
                         f"{want32['accuracy'][i]}")
                if not got["f32"]["params"][i]["within"]:
                    fail(f"{what} (a): f32 params after step {i + 1} "
                         f"{got['f32']['params'][i]} outside atol "
                         f"{MESH_PARAM_ATOL} / rtol {MESH_PARAM_RTOL}")
                rel = got["bf16"]["params"][i]["max_rel_l2"]
                if rel > MESH_BF16_REL or abs(got["bf16"]["loss"][i]
                                              - want16["loss"][i]) > \
                        MESH_BF16_REL * abs(want16["loss"][i]):
                    fail(f"{what} (b): bf16 step {i + 1}: loss "
                         f"{got['bf16']['loss'][i]} against "
                         f"{want16['loss'][i]}, params' change {rel} (bound "
                         f"{MESH_BF16_REL})")
            if any(got["f32"]["launches"].values()):
                fail(f"{what} (a): f32 steps launched {got['f32']['launches']}")
            want = SEQ_DEPTH * MESH_TRAIN_STEPS
            if any(v != want for v in got["bf16"]["launches"].values()):
                fail(f"{what} (b): K5/K6/K7 launched {got['bf16']['launches']}, "
                     f"expected {want} each")
            shape = [rows, SEQ_LEN, heads, SEQ_DIM // SEQ_HEADS]
            if [list(s) for s in got["bf16"]["k5_q_shapes"]] != [shape] or \
                    [list(s) for s in got["bf16"]["k67_q_shapes"]] != [shape]:
                fail(f"{what} (b): K5/K6/K7 ran on {got['bf16']['k5_q_shapes']}"
                     f" / {got['bf16']['k67_q_shapes']}, expected the rank's "
                     f"{shape}")
            if not got["repeat_bitwise"] or \
                    got["repeat_loss"] != got["bf16"]["loss"][:1]:
                fail(f"{what} (d): a repeated step gave other bits")
        launches[label] = ranks[0]["mesh_train"]["bf16"]["launches"]
    return launches


def _mesh_resnet_gates(runs, refs, smi) -> None:
    want = refs["resnet"]
    for label, ranks in runs:
        for r in ranks:
            got = r["mesh_resnet"]
            log({"phase": "mesh_resnet", "card": smi, "run": label,
                 "rank": r["rank"], "mesh_shape": got["mesh_shape"],
                 "step_seconds": got["step_seconds"],
                 "single_card_step_seconds": want["step_seconds"],
                 "collectives": got["collectives"], "params": got["params"],
                 "loss": got["loss"], "single_card_loss": want["loss"],
                 "single_card_row_order_floor": want["order_floor"]})
            for i in range(MESH_RESNET_STEPS):
                floor = want["order_floor"][i]
                dloss = abs(got["loss"][i] - want["loss"][i])
                if dloss <= MESH_LOSS_ATOL and got["params"][i]["within"]:
                    continue
                if dloss > max(MESH_LOSS_ATOL, MESH_ORDER_RATIO * floor["loss"]) \
                        or got["params"][i]["max_abs_err"] > \
                        MESH_ORDER_RATIO * floor["max_abs_err"]:
                    fail(f"mesh_resnet ({label}, rank {r['rank']}): step "
                         f"{i + 1} loss {got['loss'][i]} against "
                         f"{want['loss'][i]}, params {got['params'][i]}: "
                         f"outside the reference's tolerances and "
                         f"{MESH_ORDER_RATIO} x the single card's distance "
                         f"under a row permutation {floor}")


def _mesh_other_gates(runs, refs, smi) -> dict:
    launches = {}
    for label, ranks in runs:
        if "mesh_ring" not in ranks[0]:
            continue
        for r in ranks:
            what = f"({label}, rank {r['rank']})"
            for causal, got in r["mesh_ring"]["causal"].items():
                dense = refs["ring"][causal]
                log({"phase": "mesh_ring", "card": smi, "run": label,
                     "rank": r["rank"], "causal": causal, **got,
                     "dense_f32_err": dense["dense_f32_err"],
                     "dense_f32_grad_err": dense["dense_f32_grad_err"]})
                # two f32 computations of one function: the ring's streaming
                # softmax is held to the dense one's error as K5 is to its
                # plain version's (F64_RATIO_MAX)
                if not got["finite"] or got["ring_err"] > F64_RATIO_MAX * \
                        dense["dense_f32_err"] or got["ring_grad_err"] > \
                        F64_RATIO_MAX * dense["dense_f32_grad_err"]:
                    fail(f"mesh_ring {what} causal={causal}: ring errors "
                         f"{got['ring_err']} / {got['ring_grad_err']} against "
                         f"f64 dense, above {F64_RATIO_MAX} x the single "
                         f"card's f32 dense {dense['dense_f32_err']} / "
                         f"{dense['dense_f32_grad_err']}")
            moe, pipe, dnn = (r[k] for k in ("mesh_moe", "mesh_pipe",
                                             "mesh_dnn_model"))
            log({"phase": "mesh_moe", "card": smi, "run": label,
                 "rank": r["rank"], **moe})
            log({"phase": "mesh_pipe", "card": smi, "run": label,
                 "rank": r["rank"], **pipe})
            log({"phase": "mesh_dnn_model", "card": smi, "run": label,
                 "rank": r["rank"], **dnn})
            if moe["max_abs_err"] > MESH_MOE_ATOL or \
                    moe["w1_block"][0] != MOE_EXPERTS // len(ranks):
                fail(f"mesh_moe {what}: {moe}")
            if pipe["max_abs_err"] > MESH_PIPE_ATOL:
                fail(f"mesh_pipe {what}: {pipe}")
            if dnn["cos_gap"] > COS_GAP_MAX or dnn["max_abs_diff"] > \
                    OUT_MAX_DIFF or dnn["mean_abs_diff"] > OUT_MEAN_DIFF or \
                    not dnn["unfused"] or \
                    tuple(dnn["shape"]) != (SEQ_ROWS, SEQ_LEN, SEQ_DIM):
                fail(f"mesh_dnn_model {what}: {dnn} (bounds {COS_GAP_MAX}, "
                     f"{OUT_MAX_DIFF}, {OUT_MEAN_DIFF})")
            want = SEQ_DEPTH * SEQ_ROWS // SEQ_BATCH
            if dnn["launches"]["flash_attn"] != want:
                fail(f"mesh_dnn_model {what}: K5 launched "
                     f"{dnn['launches']['flash_attn']} times, expected {want}")
        launches[label] = ranks[0]["mesh_dnn_model"]["launches"]["flash_attn"]
    return launches


def mesh_attn_kernels(torch, smi) -> dict:
    """Gate (c): K5, K6 and K7 on the inputs a rank of the widest run
    stashed (its first layer's first step), alone on the card: against
    their plain versions, as the attention phases hold them, and timed
    beside the plain versions and the library call."""
    import glob

    import torch.nn.functional as F

    from mmlspark_tpu_torch.models import flash_kernel as fk

    path = max(glob.glob(_dnn_path("attn_stash_*.pt")),
               key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    stash = torch.load(path, map_location="cpu", weights_only=True)
    q, k, v = (x.to(DEVICE) for x in stash["fwd"])
    b, t, h, d = q.shape
    o = fk.flash_attention_cuda(q, k, v, False)
    p = fk.flash_attention_plain(q, k, v, False)
    exact = attention_f64(torch, q, k, v, False)
    scale = attention_f64(torch, q, k, v.abs(), False)
    row5 = {"shape": [b, t, h, d],
            "max_abs_err": (o.float() - p.float()).abs().max().item(),
            "max_ulps_vs_plain": bf16_ulps(torch, o, p, scale),
            "k5_err_vs_f64": (o.double() - exact).abs().max().item(),
            "plain_err_vs_f64": (p.double() - exact).abs().max().item()}
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row5["ms"] = time_ms(torch, lambda: fk.flash_attention_cuda(q, k, v, False))
    row5["plain_ms"] = time_ms(torch, lambda: fk.flash_attention_plain(
        q, k, v, False), 5, 1)
    row5["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt))
    row5["bound_ms"], row5["bound_by"] = bound_ms(
        4 * b * t * h * d * 2, 4 * b * h * t * t * d, BF16_OPS_PER_S)
    del o, p, exact, scale
    q, k, v, o, lse, do = (x.to(DEVICE) for x in stash["bwd"])
    got = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, False)
    plain = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, False)
    exact = attention_vjp_f64(torch, q, k, v, do, False)
    rows = {}
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bufs = [torch.empty_like(x) for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 10)
    plain_ms = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
        q, k, v, o, lse, do, False), 3, 1)
    for which, names in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
        idx = [("dq", "dk", "dv").index(n) for n in names]
        row = {"shape": [b, t, h, d], "max_abs_err": max(
            (got[i].float() - plain[i].float()).abs().max().item() for i in idx),
            "kernel_err_vs_f64": max((got[i].double() - exact[i]).abs().max()
                                     .item() for i in idx),
            "plain_err_vs_f64": max((plain[i].double() - exact[i]).abs().max()
                                    .item() for i in idx)}
        row["ms"] = time_ms(torch, lambda: fk.launch_bwd(
            which, q, k, v, do, lse, di, *bufs, False), 10)
        flops, nbytes = fk.bwd_cost(b, t, t, h, d, False, which)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    BF16_OPS_PER_S)
        row["plain_ms"], row["library_ms"] = plain_ms, library_ms
        rows[f"flash_attn_bwd_{which}"] = row
    out = {"flash_attn": row5, **rows}
    log({"phase": "mesh_attn_kernels", "card": smi, "stash": path, **out})
    if row5["max_ulps_vs_plain"] > ULPS_MAX or row5["k5_err_vs_f64"] > \
            F64_RATIO_MAX * row5["plain_err_vs_f64"]:
        fail(f"mesh_train (c): K5 on a rank's inputs {row5}")
    for name, row in rows.items():
        if row["kernel_err_vs_f64"] > F64_RATIO_MAX * row["plain_err_vs_f64"]:
            fail(f"mesh_train (c): {name} on a rank's inputs {row}")
    return out


def _mesh_fused_gates(runs, refs, smi) -> dict:
    """mesh_fused and mesh_fused_pipe's gates on every rank: sharded
    outputs within SHARD_ATOL of the single card's unsharded ones (bitwise
    for a one-rank mesh: one shard is the unsharded path), the pipelined
    chain bitwise the serial one, no fallback, no partition run serially,
    K5 launched on every data rank's rows (and on every encoder-stage
    rank). Returns K5's launches on the new paths."""
    ref = refs["fused"]
    paths = {}
    head_dim = SEQ_DIM // SEQ_HEADS
    for label, ranks in runs:
        world = len(ranks)
        rows = MESH_FUSED_ROWS // world
        for r in ranks:
            what = f"({label}, rank {r['rank']})"
            f = r["mesh_fused"]
            enc = f["encoder"]
            log({"phase": "mesh_fused", "card": smi, "run": label,
                 "rank": r["rank"], "single_card_seconds": {
                     "encoder": ref["encoder_seconds"],
                     "gbdt": ref["gbdt_seconds"]}, **f})
            close = enc["bitwise"] if world == 1 else \
                enc["max_abs_diff"] <= SHARD_ATOL
            if not close or enc["fallbacks"]:
                fail(f"mesh_fused {what}: the encoder segment {enc} against "
                     f"unsharded (SHARD_ATOL {SHARD_ATOL})")
            if enc["launches"] != SEQ_DEPTH or enc["k5_q_shapes"] != \
                    [(rows, SEQ_LEN, SEQ_HEADS, head_dim)]:
                fail(f"mesh_fused {what}: K5 launched {enc['launches']} "
                     f"times at {enc['k5_q_shapes']}, expected {SEQ_DEPTH} at "
                     f"{(rows, SEQ_LEN, SEQ_HEADS, head_dim)}")
            shards = ((enc["sharding"] or {}).get("segments") or {}).get(
                "DNNModel", {}).get("shards", 1)
            if shards != world:
                fail(f"mesh_fused {what}: {shards} shards, not {world}")
            for spec in ("data", "feature") if world > 1 else ("data",):
                g = f[f"gbdt_{spec}"]
                close = g["bitwise"] if world == 1 else \
                    g["max_abs_diff"] <= SHARD_ATOL
                if not close or g["fallbacks"]:
                    fail(f"mesh_fused {what}: the forest segment under "
                         f"{spec}: {g}")
            if "mesh_fused_pipe" not in r:
                continue
            p = r["mesh_fused_pipe"]
            log({"phase": "mesh_fused_pipe", "card": smi, "run": label,
                 "rank": r["rank"], **p})
            pipe = p["pipeline"] or {}
            if not p["bitwise"] or p["fallbacks"] or pipe.get("depth") != 2 \
                    or pipe.get("serial_fallback_partitions") != 0:
                fail(f"mesh_fused_pipe {what}: {p}")
            want = SEQ_DEPTH * MESH_FUSED_ROWS // MESH_FUSED_PIPE_BATCH \
                if pipe["stage"] == 0 else 0
            if p["launches"] != want:
                fail(f"mesh_fused_pipe {what}: K5 launched {p['launches']} "
                     f"times on stage {pipe['stage']}, expected {want}")
        paths[f"mesh_fused.{label}"] = {
            "flash_attn": ranks[0]["mesh_fused"]["encoder"]["launches"]}
        if "mesh_fused_pipe" in ranks[0]:
            paths[f"mesh_fused_pipe.{label}"] = {
                "flash_attn": ranks[0]["mesh_fused_pipe"]["launches"]}
    return paths


def fused_attn_kernel(torch, smi) -> dict:
    """K5 alone on the card on the inputs a data rank of the widest run
    stashed (its first layer, ``[16, 2048, 8, 64]`` on four ranks): against
    its plain version and exact f64 attention, timed beside the plain
    version and the library call."""
    import glob

    import torch.nn.functional as F

    from mmlspark_tpu_torch.models import flash_kernel as fk

    path = max(glob.glob(_dnn_path("fused_attn_stash_*.pt")),
               key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    q, k, v = (x.to(DEVICE) for x in torch.load(path, map_location="cpu",
                                                  weights_only=True))
    b, t, h, d = q.shape
    o = fk.flash_attention_cuda(q, k, v, False)
    p = fk.flash_attention_plain(q, k, v, False)
    exact = attention_f64(torch, q, k, v, False)
    scale = attention_f64(torch, q, k, v.abs(), False)
    row = {"shape": [b, t, h, d],
           "max_abs_err": (o.float() - p.float()).abs().max().item(),
           "max_ulps_vs_plain": bf16_ulps(torch, o, p, scale),
           "k5_err_vs_f64": (o.double() - exact).abs().max().item(),
           "plain_err_vs_f64": (p.double() - exact).abs().max().item()}
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row["ms"] = time_ms(torch, lambda: fk.flash_attention_cuda(q, k, v, False))
    row["plain_ms"] = time_ms(torch, lambda: fk.flash_attention_plain(
        q, k, v, False), 5, 1)
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt))
    row["bound_ms"], row["bound_by"] = bound_ms(
        4 * b * t * h * d * 2, 4 * b * h * t * t * d, BF16_OPS_PER_S)
    log({"phase": "mesh_fused_attn_kernel", "card": smi, "stash": path, **row})
    if row["max_ulps_vs_plain"] > ULPS_MAX or row["k5_err_vs_f64"] > \
            F64_RATIO_MAX * row["plain_err_vs_f64"]:
        fail(f"mesh_fused: K5 on a data rank's inputs {row}")
    del q, k, v, o, p, exact, scale, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def dnn_mesh_start(torch):
    """Start every run of ``dnn_mesh_launches`` at once, each rank running
    every DNN mesh phase (``dnn_mesh_rank``) against the references
    ``dnn_mesh_refs`` left in the work directory; returns the function
    that waits for them."""
    return mesh_spawn(torch, "chip_smoke:dnn_mesh_rank",
                      {"work": mesh_workdir()}, "dnn_mesh",
                      plan=dnn_mesh_launches(torch), timeout=DNN_MESH_TIMEOUT)


def _mesh_gbdt_axes_gates(runs, refs, smi) -> dict:
    """mesh_gbdt_axes (data 2 x tensor 2, ROADMAP A9k): every rank's dense
    model byte for byte the single-card fused fit (``refs["gbdt_axes"]``
    from mesh_phases), K1 launched on each rank and the trees replayed on
    NCCL (``replay_gate``); each VW fit within ``VW_RTOL``/``VW_ATOL`` of
    one process averaging two blocks' passes, and bit for bit between the
    tensor replicas of each data coordinate. Returns each run's launches
    (summed over its ranks)."""
    want = refs.get("gbdt_axes")
    paths = {}
    for label, ranks in runs:
        outs = [r.get("mesh_gbdt_axes") for r in ranks]
        if want is None or not outs[0] or outs[0].get("skipped"):
            continue
        p = paths.setdefault(f"mesh_gbdt_axes.{label}",
                             {"hist": 0, "hist_count": 0, "select": 0,
                              "vw_scan": 0})
        for o in outs:
            rep = o["report"]
            diff = model_diff(o["model"], want["dense"])
            log({"phase": "mesh_gbdt_axes", "card": smi, "run": label,
                 "coords": o["coords"], **rep,
                 "model_equals_single_card": not diff,
                 "differences": diff[:20]})
            if diff or rep["route"] != "fused" or rep["launches"]["hist"] < 1:
                fail(f"mesh_gbdt_axes ({label}, rank {rep['rank']}): model "
                     f"differs in {len(diff)} places ({diff[:5]}), route "
                     f"{rep['route']}, K1 launches {rep['launches']['hist']}")
            replay_gate(rep, label.startswith("nccl"), "hist_kernel.launches",
                        f"mesh_gbdt_axes ({label}, rank {rep['rank']})")
            for k in ("hist", "hist_count", "select"):
                p[k] += rep["launches"][k]
        for name in ("adaptive", "ftrl"):
            by_block = {}
            for o in outs:
                w = o["vw"][name]["weights"]
                by_block.setdefault(o["coords"]["data"], []).append(w)
                p["vw_scan"] += o["vw"][name]["report"]["launches"]["vw_scan"]
            same = all(np.array_equal(w.view(np.uint32), ws[0].view(np.uint32))
                       for ws in by_block.values() for w in ws)
            w0 = outs[0]["vw"][name]["weights"]
            err = float(np.abs(w0 - want["vw"][2, name]).max())
            close = bool(np.allclose(w0, want["vw"][2, name], rtol=VW_RTOL,
                                     atol=VW_ATOL))
            log({"phase": "mesh_gbdt_axes", "run": label, "fit": name,
                 "replicas_bitwise": same, "close_to_two_blocks": close,
                 "max_abs_vs_two_blocks": err})
            if not same or not close:
                fail(f"mesh_gbdt_axes ({label}, {name}): replicas bit for "
                     f"bit {same}, within rtol {VW_RTOL} / atol {VW_ATOL} "
                     f"of two blocks averaged {close} ({err})")
    return paths


def dnn_mesh_gates(torch, runs, refs, smi) -> dict:
    """The DNN mesh phases' gates on the ranks' results, then K5-K7 alone
    on a rank's inputs. Returns the K5-K7 launches of the new paths (and
    K1's and vw_scan's on data 2 x tensor 2) and the kernels' rows on a
    rank's inputs."""
    for label, ranks in runs:
        log({"phase": "dnn_mesh", "run": label, "phase_seconds": {
            k: [r[k]["phase_seconds"] for r in ranks] for k in ranks[0]
            if isinstance(ranks[0][k], dict)}})
    train = _mesh_train_gates(torch, runs, refs, smi)
    _mesh_resnet_gates(runs, refs, smi)
    dnn = _mesh_other_gates(runs, refs, smi)
    fused = _mesh_fused_gates(runs, refs, smi)
    kernels = mesh_attn_kernels(torch, smi)
    paths = dict(fused)
    paths.update(_mesh_gbdt_axes_gates(runs, refs, smi))
    for label, got in train.items():
        paths[f"mesh_train.{label}"] = got
    for label, got in dnn.items():
        paths[f"mesh_dnn_model.{label}"] = {"flash_attn": got}
    return {"paths": paths, "kernels": kernels,
            "fused_kernel": fused_attn_kernel(torch, smi)}


def dnn_mesh_phases(torch, smi) -> dict:
    """The DNN mesh phases alone: the single-card references, the ranks,
    the gates (``main`` runs the ranks beside the GBDT mesh phases')."""
    refs = dnn_mesh_refs(torch, smi)
    runs = dnn_mesh_start(torch)()
    return dnn_mesh_gates(torch, runs, refs, smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mmlspark_tpu_torch  # noqa: F401  (fails outside a checkout)

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on; the forest sums and the f32 products need "
             "full f32")
    t_start = time.perf_counter()
    hdr = header(torch)
    smi = hdr["smi"].splitlines()[0]
    kernels = kernel_phase(torch)
    main_launches, dense_model, X, y = scan_main(torch, smi)
    launches = {"hist": main_launches["hist"] + main_launches["hist_count"],
                "select": main_launches["select"]}
    X_score = X[:N_SCORE].copy()
    paths = {"main": dict(main_launches)}
    paths["fused_tree"] = fused_tree_phase(torch, X, y, smi)
    native_main(torch, X, y, dense_model, smi)
    profile_phase(torch, X, y, smi)
    paths["dense_variants"] = dense_variants(torch, X, y, smi)
    paths["dense_variants.goss_scan"] = paths["dense_variants"].pop("goss_scan")
    # the mesh phases' inputs, memory-mapped by their ranks (f32-exact X)
    mesh_inputs = {"dense": mesh_save("dense", X=X.astype(np.float32), y=y)}
    del X, y
    paths["ranker_main"], mesh_inputs["ranker"] = ranker_main(torch, smi)
    paths["categorical_main"] = categorical_main(torch, dense_model, X_score, smi)
    data = sparse_data()
    # the stage fit first: its host build leaves the dataset the rest reads
    launches["sparse_hist"], sparse_model = sparse_main_path(torch, data)
    kernels["sparse_hist"] = sparse_kernel_phase(torch, data)
    paths["main"]["sparse_hist"] = launches["sparse_hist"]
    full_ms = kernels["sparse_hist"]["ms"]
    paths["sparse_variants"], compacted = sparse_variants(torch, data, smi,
                                                          full_ms)
    paths["sparse_variants.compacted_stream"] = {
        "sparse_hist": paths["sparse_variants"].pop("compacted_stream")}
    paths["sparse_wide"] = {"sparse_hist": sparse_wide(torch, data, smi)}
    rows = data["rows"][:N_SCORE]
    ds = data["ds"]
    mesh_inputs["sparse"] = mesh_save(
        "sparse", y=data["y"], num_features=np.int64(ds.num_features),
        **{k: getattr(ds, k) for k in (
            "indptr", "indices", "values", "feat_offset", "thresholds",
            "zero_local", "bin_of_nnz", "row_of_nnz")})
    del data, ds
    anchor = sparse_anchor(torch)
    got, anchor_compacted = anchor_variants(torch, smi, full_ms)
    paths["sparse_variants"]["sparse_hist"] += got
    # K4's compacted stream: the full-width goss fit's where the reference's
    # rule compacts there, else the anchor's forced one
    kernels["sparse_hist"]["compacted_stream"] = compacted or anchor_compacted
    kernels["csr_gather"] = gather_kernel_phase(torch, sparse_model, rows)
    launches["csr_gather"] = fused_sparse(torch, sparse_model, rows, smi)
    fused_dense(torch, dense_model, X_score, smi)
    fused_save_gbdt(dense_model, X_score)
    fused_anchor(torch, *anchor)
    t_mega = time.perf_counter()
    sparse_runs = mega_sparse(torch, sparse_model, rows, smi)
    paths["mega_sparse"] = {"csr_gather": sparse_runs[max(MEGA_KS)]["launches"]}
    dense_runs = mega_dense(torch, dense_model, X_score, smi)
    tuner_phase(torch, sparse_runs, dense_runs, sparse_model, rows, smi)
    del sparse_runs, dense_runs
    paths["serving_autotune"] = serving_autotune(torch, sparse_model, rows, smi)
    deposit_phase(torch, dense_model, X_score, smi)
    mega_s = time.perf_counter() - t_mega
    t_serve = time.perf_counter()
    paths["serving_sparse"] = {"csr_gather": serving_sparse(
        torch, sparse_model, rows, smi)}
    fused, want = serving_dense(torch, dense_model, X_score, smi)
    serving_front(torch, fused, want, X_score, smi)
    serve_s = time.perf_counter() - t_serve
    del dense_model, sparse_model, rows, anchor, X_score, fused, want
    kernels["flash_attn"] = attn_kernel_phase(torch)
    kernels.update(attn_bwd_kernel_phase(torch))
    launches["flash_attn"], stage, df, out = transformer_main(torch, smi)
    transformer_fused(torch, stage, df, out, smi)
    t_mega = time.perf_counter()
    seq_runs = mega_transformer(torch, stage, df, smi)
    paths["mega_transformer"] = {
        "flash_attn": seq_runs[max(MEGA_SEQ_KS)]["launches"]}
    del seq_runs
    mega_s += time.perf_counter() - t_mega
    log({"phase": "mega", "seconds": mega_s})
    t_serve = time.perf_counter()
    ids = np.asarray(list(df.column("tokens")))
    paths["serving_transformer"] = {"flash_attn": serving_transformer(
        torch, stage, ids, out, smi)}
    serve_s += time.perf_counter() - t_serve
    log({"phase": "serving", "seconds": serve_s})
    # mesh_dnn_model's single-card reference
    np.save(_dnn_path("main_out.npy"), out)
    del stage, df, out, ids
    t_train = time.perf_counter()
    train, causal = train_transformer(torch, smi)
    for name in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        launches[name] = train[name]
    paths["train_transformer"] = {"flash_attn": train["flash_attn"]}
    paths["train_transformer_causal"] = causal
    bilstm_train(torch, smi)
    log({"phase": "training", "seconds": time.perf_counter() - t_train})
    t_wide = time.perf_counter()
    paths.update(train_wide_heads(torch, smi))
    paths.update(serve_wide_heads(torch, smi))
    log({"phase": "wide_heads", "seconds": time.perf_counter() - t_wide})
    for phase in (image_main, resnet_train, moe_main, onnx_main,
                  onnx_multi_input):
        t_phase = time.perf_counter()
        got = phase(torch, smi)
        if got:
            paths.update(got)
        log({"phase": phase.__name__, "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    vw_row, vw_ds = vw_main(torch, smi)
    log({"phase": "vw_main", "seconds": time.perf_counter() - t_phase})
    mesh_inputs["vw"] = mesh_save("vw", indices=vw_ds.indices,
                                  values=vw_ds.values, labels=vw_ds.labels,
                                  weights=vw_ds.weights)
    del vw_ds
    for phase in (text_main, adult_main, word2vec_main):
        t_phase = time.perf_counter()
        if phase is text_main:
            paths["text_main"], texts = text_main(torch, smi)
        elif phase is adult_main:
            paths["adult_main"] = adult_main(torch, smi)
        else:
            word2vec_main(torch, smi, texts)
        log({"phase": phase.__name__, "seconds": time.perf_counter() - t_phase})
    del texts
    t_new = time.perf_counter()
    paths["automl_main"], best_model, holdout = automl_main(torch, smi)
    log({"phase": "automl_main", "seconds": time.perf_counter() - t_new})
    for phase in (sar_main, lime_main):
        t_phase = time.perf_counter()
        if phase is sar_main:
            sar_main(torch, smi)
        else:
            lime_main(torch, smi, best_model, holdout)
        log({"phase": phase.__name__, "seconds": time.perf_counter() - t_phase})
    log({"phase": "automl_sar_lime", "seconds": time.perf_counter() - t_new})
    del best_model, holdout
    try:
        # the DNN mesh's single-card references alone on the card, then its
        # ranks beside the GBDT mesh's (both sets of ranks contended); the
        # work timed alone on the card waits for every rank
        t_phase = time.perf_counter()
        dnn_refs = dnn_mesh_refs(torch, smi)
        dnn_pending = dnn_mesh_start(torch)
        dnn_runs = []
        mesh = mesh_phases(torch, mesh_inputs, smi,
                           after_ranks=lambda: dnn_runs.extend(dnn_pending()))
        for got in mesh.values():
            paths.update(got["paths"])
        dnn_refs["gbdt_axes"] = {"dense": mesh["mesh_dense"]["single_fused"],
                                 "vw": mesh["mesh_vw"]["want"]}
        dnn_mesh = dnn_mesh_gates(torch, dnn_runs, dnn_refs, smi)
        paths.update(dnn_mesh["paths"])
        log({"phase": "mesh", "seconds": time.perf_counter() - t_phase})
    finally:
        mesh_cleanup()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name in ("hist", "select", "csr_gather", "sparse_hist", "flash_attn",
                 "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        row = dict(kernels[name], launches=launches[name])
        new_paths = {p: c[name] + c.get("hist_count", 0) if name == "hist"
                     else c[name] for p, c in paths.items()
                     if p != "main" and name in c}
        if name == "hist":
            # K1's device-count entry (this slice's), apart, main path too
            new_paths.update({f"{p}.device_count_entry": c["hist_count"]
                              for p, c in paths.items() if "hist_count" in c})
        extra = {k: row[k] for k in ("compacted_stream", "status", "tflops",
                                     "bwd_total_ms", "wide") if k in row}
        if name in ("hist", "sparse_hist"):
            # the f64 entry of the sharded fits, on a rank's own inputs
            extra["f64_entry"] = mesh["mesh_dense" if name == "hist"
                                      else "mesh_sparse"]["f64"]
        if name in dnn_mesh["kernels"]:
            # on a tensor rank's heads, the inputs it stashed in mesh_train
            extra["mesh_rank_inputs"] = dnn_mesh["kernels"][name]
        if name == "flash_attn":
            # on a data rank's rows of the sharded fused encoder segment
            extra["fused_rank_inputs"] = dnn_mesh["fused_kernel"]
        rows.append({**{k: row[k] for k in keys},
                     "launches_on_new_paths": new_paths, **extra})
    rows.append({**{k: vw_row[k] for k in keys},
                 "launches_on_new_paths": {p: c["vw_scan"] for p, c in
                                           paths.items() if "vw_scan" in c},
                 **{k: vw_row[k] for k in ("shape", "pass_ms_200k",
                                           "pass_bound_ms_200k",
                                           "native_pass_ms_200k")}})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
