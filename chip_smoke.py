#!/usr/bin/env python3
"""Drive the PyTorch port's ColPali ingest -> retrieve path once on one
NVIDIA H100, at the full ColQwen2.5-3B geometry with random weights, in
the shipped serving config (W8A8 tower with calibrated static activation
scales, bf16 attention) and, before it, in bf16; then its HTTP service
plane with the text path, documents as page images over HTTP, a real
checkpoint, /query answered through the LLM wire formats, and the text
index at 200,000 rows; an API node that embeds, parses and OCRs through
remote endpoints; the connectors and the admin console, with the
progressive and multi-scan JPEGs and the Adam7 and 16-bit PNGs that
connector files bring; the 3B checkpoint served in f32, through K3's
3xTF32 kernel; and last the binary index through K4, the dual store and
the operator scripts' port twins; then the evaluation harnesses and the
two measuring scripts at their small sizes; the page image formats the
reference opens through Pillow (GIF, BMP, TIFF, WebP, CMYK and YCCK
JPEGs); and last the mesh paths on a virtual (data 2, model 2) mesh of
this one card.

    python3 chip_smoke.py

Phases (each raises on failure; none is caught):
  1. the card's name and power limit; build the kernels of
     morphik_core_tpu_torch/csrc/ with nvcc (one process per source);
     count the tensor-core, ldmatrix and cp.async instructions of each
     kernel in the built library (cuobjdump): the bf16 K3 must have all
     three, the f32 K3 at the path's shape TF32 HMMAs and cp.async
     (LDGSTS).
  2. each kernel (K1, K2 MaxSim; K3 window attention; K4 binary MaxSim)
     against its plain PyTorch version on the card, at the main path's
     shapes (the text
     queries' and the self-query's) and at ragged edges. Two times per
     side, order plain, kernel, kernel, plain: CUDA events around 20
     Python calls (host cost included), and the device time of one
     replay of a CUDA graph of 20 calls. Each case prints its bound: the
     larger of the bytes it must move (inputs read once, output written
     once) over 3.35 TB/s and its operations over the peak rate of their
     type. Two calls of K1, of K2 on the long query and of the bf16 K3
     must be bit-identical. The bf16 K3 is also held to a mirror of the
     Pallas kernel's rounding, and timed beside
     F.scaled_dot_product_attention on the same inputs (a yardstick that
     the port never calls); so is the f32 K3 (3xTF32 tensor-core products)
     at the vision blocks' shape, where SDPA names the backend that took
     f32. Each K3 case prints the kernel's resident blocks per SM. K2 also runs at the reranker's shape: the f32
     query of a text query against 12 f32 chunks of byte tokens, the
     longest a 6000-character chunk (6017 tokens, padded to 6144). K4
     runs phase 18's resident scan at 32 and 632 query tokens and a ragged
     dim-16 case, bit for bit, its bound the larger of the valid tokens'
     bytes and their popcounts over the card's popcount rate (SMs x 16 a
     clock, CUDA C++ Programming Guide, x the max SM clock). K5 (JPEG 2000
     tier-1) bit for bit against its plain version (host Python) on the
     code blocks of the top-left 128 x 128 of the 550 x 425 page, lossless
     and 9/7 (tests/fixtures/image_formats_jp2.npz), the plain side's host
     ms beside the kernel's, and K5's device time on every block of the
     200 dpi letter page, lossless and 9/7, each beside its bound (segment
     bytes read and int32 coefficients written over 3.35 TB/s; K5 is
     latency-bound), its blocks, its geometry (a warp a thread block,
     shared bytes a warp, resident warps a SM, registers) and the
     residency, and the crop's longest chain (its block of the most MQ
     decisions, counted by the plain version) timed alone in ns a
     decision; K6 (HTJ2K) likewise on the HT crops and letter page, its
     chain in quads and SigProp / MagRef bits.
  3. ingest. (a) the earlier path: the 3B model in bf16 embeds one batch
     of 8 pages at grid 20 x 28 from seeded uint8 patches and encodes the
     text queries with the bf16 text tower. (b) the main
     path: the same weights quantized to int8 in place, the shipped
     embedder calibrates static scales on the committed pages (2 batches
     of 8 at grid 24 x 20) and embeds the same 8 pages with the fused
     document FDE; its embeddings are held against (a)'s.
  4. store: the 8 pages plus seeded synthetic unit multivectors into the
     index, over several device blocks; the index has a path (a temporary
     directory) and the shipped compaction trigger, and nothing is saved
     before phase 9.
  5. query with the shipped retrieval config (int8 ANN, pooled tier
     factor 32, int8 rerank through the device cache), queries encoded by
     the int8 text tower (held against (a)'s bf16 encodings): text
     queries and one self-query that must come back top-1.
  6. the same with rerank_dtype="bf16", and (a)'s bf16-encoded queries.
  7. launch counts: the counts are reset just before each path and read
     just after it; (a) launched K3, the main path (3b-6) launched all
     three kernels.
  9. persistence at full page width (run here, before phase 8; the
     counts are reset for it): phase 4's index saved (bytes, MB/s), a
     second index opened on its files with cold device state (open ms,
     cold and warm query ms; no `pool_multivector` call: the pooled tier
     comes from pooled.bin) answers phase 5's queries with the same ids
     and score bits, and a rerank_dtype="bf16" index opened on the same
     files gives phase 6's ids. 2048 rows of their own documents are
     appended and saved (4096 rows, the trigger's compact_min_rows); 1100
     of them are deleted one at a time, so the trigger (dead share > 0.25)
     fires inside delete_document at the 1025th, exactly once. The files
     shrink, no `.compact` directory is left, and the compacted index
     answers exactly as a fresh in-memory index of the survivors (row
     order, their stored FDE rows), before and after a save and reopen.
     K1 and K2 must launch. Prints a {"persistence": {...}} line.
  8. the service path: the port's server (`build_services` + `build_app`
     from `morphik_tpu.toml`, paths in a temporary directory, port 0)
     serves phase 3b's 3B int8 model, recalibrated at boot, over a real
     socket on 127.0.0.1 to a stdlib client: 9 PNG pages ingested
     (8 at 560 x 784 px, one at 600 x 830 px that takes the bicubic
     resize; each stored as the reference's q80 JPEG payload and
     embedded from its decoded pixels), the text queries (k=4, 10 timed
     repeats each), page 3's PNG as an image query (its document must
     come back first, with its JPEG payload) and one /query. Every retrieve must equal the in-process store's answer to
     the same query embedding; the counts, reset after boot, must show
     K3 (ingest) and K1 (retrieve) launched by the HTTP path. Then the
     server stops (its shutdown saves the index) and a second one boots
     with `build_services` on the same directories and model: the same
     retrieve ids (scores within SCORE_ATOL), every document `completed`
     with its chunk, /health showing the rows, K1 launched. Before the
     restart, the text half on the same server: three /ingest/text
     documents of 8-16 KB of seeded prose (two also into the ColPali
     store, through the text tower), an upload each of markdown, HTML,
     XML, JSON and a two-page PDF with use_colpali=false, text retrieves
     (use_colpali=false, k=4, hybrid) equal to the in-process text store,
     reranked retrieves (use_reranking) whose order equals an in-process
     ColQwenReranker over the same 12 oversampled chunks (K2 once each),
     a use_colpali=true retrieve of a text document's chunks (K1),
     /batch/chunks and /query with use_colpali=false, and a DELETE that
     leaves both stores; after the restart the text retrieves come back
     the same and /health shows the text rows. Prints a {"service":
     {...}} line (ingest pages/s, retrieve p50/p99 ms, /query ms,
     launches, restart boot s and p50; text ingest s per document, text
     retrieve p50/p99, reranked retrieve p50, K2 launches, peak memory;
     the card's name and power limit).
 11. documents as pages over HTTP (after phase 8), on a new server from
     the shipped toml serving phase 3b's model: the JPEG decoder on the
     committed fixtures of the CPU tests (4:2:0, 4:2:2, 4:4:4, gray,
     restart intervals; Pillow's pixels as hashes), a text page's q70
     payload against the reference's hash, and decode_own against the
     decoder on the encoder's bytes; one process's time per stage of a 150 dpi
     PDF page (render, LANCZOS resize, q70 encode, decode_own, blank
     check, patches); then a 24-page PDF (page 11 renders blank and is
     skipped), a 3-slide PPTX, a DOCX of 4 text pages and two JPEGs made
     by the port's encoder (one takes the resize to 1024 wide), each to
     `completed`: page counts, the PDF's true page indices, K3 = 28 per
     tower forward (forwards counted); 4 text queries x 10 retrieves over
     the PDF and a JPEG image query of a stored PDF page (it comes back
     first), each through K1 and equal to the in-process store. Prints a
     {"documents": {...}} line (raster ms per stage, PDF pages/s, host
     cores, embed batches, retrieve p50/p99, image query ms, peak memory,
     launches).
 12. the corpus routes on phase 11's server, before it stops (the counts
     are reset for it): folders /Reports and /Reports/2026, two PNG pages
     ingested into the second; 40 folder-scoped retrieves (folder_depth
     -1: every result in the folder) beside 40 unscoped ones, each
     through K1, and each folder page's image self-query top-1 in its
     folder; /retrieve/docs equal to the grouping of the same chunks; the
     rename of /Reports to /Archive keeps the answers; update_file of one
     page (K3 = 28 per tower forward, its old row tombstoned, its
     self-query top-1, /documents/{id}/file and /documents/pages give the
     new bytes and q80 payload); /embeddings of two pages and two texts
     bit-identical to the in-process embed_for_ingestion (K3 = 28 per
     image forward); an app token refused (401) after its rotation, the
     new one taken; v2 ingest of phase 11's PDF, a sentence of page 7
     finding page 7; /logs/profile/device twice for 2 s while a thread
     retrieves (the first start in a process initialises CUPTI), each
     Chrome trace naming maxsim_mma_kernel. Prints a {"corpus": {...}}
     line (scoped / unscoped p50 / p99, update_file s, /embeddings ms, v2
     ingest s, each capture's route s, the profiler's start / stop /
     export s from the route's log, trace bytes, launches).
 13. a real checkpoint on the card. Right after phase 3a, before phase
     3b quantizes in place, phase 3a's bf16 weights are written as an HF
     checkpoint (colpali_engine's names, 2 GiB shards, the index json,
     config.json, the committed tokenizer.json fixture; ~7.5 GB), synced
     with the advice to drop it from the page cache. After phase 12: the
     share of its pages still cached is read; the port's tokenizer
     gives the committed `tokenizers` ids of the fixture cases; the
     failure modes (no custom_text_proj rejected, an f32 checkpoint loads
     as bf16); a server from the shipped toml with model.checkpoint_path
     set (no model passed in: loaded, quantized and calibrated at boot)
     holds the same weights and scales as phase 3b's resident model, and
     its embeddings of the 8 pages and the text queries equal that
     model's, given the same tokenizer, bit for bit; one batch of 8 timed;
     9 PNG pages over HTTP (K3 once per windowed block of each forward),
     4 text queries x 10 retrieves and an image self-query (top-1), each
     through K1 and equal to the in-process store; then a model from the
     same checkpoint with attention_precision="int8" embeds the pages and
     the queries with no K3 launch, within a cosine bound of the bf16
     attention. Last, the files are dropped from the page cache again and
     read once in 64 MiB reads: the disk's cold rate beside the load's.
     The checkpoint is deleted. Prints a {"checkpoint": ...} line (write s
     and GB, the share of its pages in the page cache before the load,
     load s and peak host RSS, the cold read s, calibration and boot s,
     pages/s with bf16 and int8 attention, retrieve p50 / p99, launches,
     the card).
 14. /query through an LLM wire format (after phase 13), on a fourth server
     from the shipped toml serving phase 3b's model in morphik.mode =
     "cloud", its completion.model and embedding.model registered keys of
     a local fake provider (morphik_core_tpu_torch/scripts/fake_providers.py:
     OpenAI /chat/completions JSON and SSE and /embeddings, Ollama /api/chat
     JSON and NDJSON, Anthropic /v1/messages JSON and SSE; each request
     recorded; embeddings are the hashing embedder's vectors). (a) 4 of
     phase 8's PNG pages (K3 28 a page); (b) 4 text queries x 5 /query
     (JSON): the provider's request carries, as image_url data URIs, the
     stored q80 JPEG payloads of the chunks /retrieve/chunks returns for
     the same query, in its order, and the answer is the provider's;
     (c) /query with SSE: the deltas join to the provider's text; (d) a
     retrieve with output_format="text": every image chunk is the
     provider's transcription; (e) /ingest/document/query of phase 11's
     24-page PDF with a JSON schema: a structured answer, and
     ingestion_options.ingest stores the document (text path) with the
     answer in its metadata; (f) /ingest/text through the routed embedder,
     a text retrieve finds it top-1; (g) queries_used set to 499 in
     user_limits.db: one /query answers 200, the next 402, /usage/limits
     reports 500; K1 on every ColPali retrieve; (h) a CompletionRequest of
     the retrieved pages through build_completion_model's Ollama and
     Anthropic keys: the raw-base64 `images` and the base64 `source`
     blocks, the streams joined. Prints an {"llm": ...} line (/query p50 /
     p99 and the retrieve's share, data-URI bytes a /query, the SSE first
     delta, the output_format="text" retrieve ms, the on-the-fly query s,
     the routed text ingest s, launches, the phase's s, the card).
 15. remote endpoints (after phase 14): server E, a local-mode server
     from the toml serving phase 3b's model with a keyed /embeddings, and
     server A, an API node (morphik.colpali_mode="api" on [a closed port,
     E], parser.parser_mode="api" on [a closed port, the fake parse
     endpoint], parser.ocr_mode="api" on the fake OCR endpoint of
     scripts/fake_providers.py), which loads no tower (its boot allocates
     < 64 MiB on the card). (a) 8 PNG pages through A: E embeds each (K3
     28 a forward, one forward a page), the closed embedding endpoint is
     tried once and then skipped, each upload's parse reaches the fake
     after the closed parse endpoint fails, and each row A stores equals
     E's in-process embed of the stored payload bit for bit, with its FDE
     row equal to fde_document_batch of it; (b) 4 text queries x 10
     retrieves on A (E's text tower encodes over HTTP, A reranks through
     K1), each equal to A's in-process store on E's in-process encoding,
     and a PNG image self-query top-1; (c) a two-page PDF with
     use_colpali=false parsed by the fake (the filename sanitised), and a
     blank scan that the deep rung OCRs through the fake, each the top
     text retrieve of its text; (d) /embeddings on A, relayed to E, equal
     to E's own bit for bit; (e) storage.provider="aws-s3" raises the
     reference's RuntimeError without boto3. Prints a {"remote": ...}
     line (pages/s, last_metrics, the first embed call beside the later
     ones' p50, retrieve p50 / p99 and the remote encode, parse and OCR
     s, launches, peak memory, the card).
 16. the connectors and the console (after phase 15), on a server from
     the toml serving phase 3b's model: the committed connector files
     (tests/fixtures/connector_files.npz: a progressive JPEG page, a
     multi-scan baseline JPEG, an Adam7 PNG, 16-bit RGB and gray PNGs, a
     CMYK JPEG) decode to Pillow's pixels (hashes), each timed on the
     host beside a baseline JPEG of the progressive page; a local
     connector over a directory outside storage.storage_path (a root over
     it answers 400) lists and ingests them with a 4-page text PDF and a
     .txt, each to `completed`, an arithmetic-coded JPEG answering 415
     (the CMYK file answered 415 until its decoder was written); each stored
     image page is the reference's q80 payload byte for byte; GitHub
     (a file by download_url), Google Drive (the OAuth code flow and its
     single-use state, a PDF) and Zotero (an item's attachment), each
     listed over two pages of 100, run end to end against the fake APIs of
     scripts/fake_providers.py; K3 = 28 a tower forward; 40 retrieves and
     an image query with the progressive file, each through K1;
     /console's sha256 equals its file's. Prints a {"connectors": ...}
     line (each ingest's s to completed, host decode ms a page, retrieve
     p50 / p99, launches, peak memory, the phase's s, the card).
 10. the text index at a real size, in process: a TextVectorStore on the
     card with 200,000 rows of 768 (the toml's embedding dimensions;
     seeded unit vectors, texts of 20-60 words from a seeded 30,000-word
     Zipf vocabulary) fed in batches of 10,000; capacity doubling gives
     262,144 rows, so a scan reads 805 MB. 20 queries with and without a
     doc_ids filter (10% of the documents), with and without the hybrid,
     each equal to an f64 numpy oracle of the same contract (ids; ties as
     sets; scores within 1e-5); the scan's device time (CUDA events
     around `_masked_topm`) beside its bound; 1,000 rows appended (the
     tail alone is uploaded), a document deleted (it never returns), a
     save and a reopen (the same answers). Prints a {"text_index": {...}}
     line.
 17. the f32 path at full width (after phase 13, before its checkpoint is
     deleted): ColQwenModel.from_checkpoint(ckpt, dtype=torch.float32) on
     the card (phase 3a's bf16 weights, exact in f32) embeds phase 3a's 8
     pages at grid 20 x 28 with batch 8 twice through ColpaliEmbeddingModel:
     K3 launches = 28 x forwards (the f32 kernel), the page embeddings'
     mean per-token cosine against phase 3a's bf16 ones above
     MIN_F32_COSINE; then the committed tiny fixture
     (tests/fixtures/tiny_colqwen.npz, head width 16) embeds 4 pages on the
     card (K3 in f32) and on the CPU (the plain version), within 5e-4.
     Prints an {"f32": ...} line (load s, pages/s of the second batch,
     launches, cosine mean / min, peak memory, the tiny model's error, the
     phase's s, the card).
 18. the binary index at a real size (after phase 10): a
     TorchMultiVectorStore(provider="binary") on the card stores phase 3b's
     8 pages and 16,384 seeded rows of 64-632 tokens (generated and
     stored in chunks; 16,392 x 1024 x 16 B = 256 MiB of resident sign
     bits), answers phase 5's text queries and a self-query of each page
     (first, at its token count exactly) 10 times each (K4 once a query),
     the same queries again with the device budget under the resident size
     (blocks of 4096 rows stream: the same ids and score bits, K4 once a
     block), a doc_ids filter and a delete; then a DualMultiVectorStore over
     a new fde store and this one takes the pages again, and its reads equal
     the primary's. Prints a {"binary": ...} line (rows/s, query p50 / p99,
     launches, peak memory, the phase's s, the card).
 19. the operator scripts' port twins on the card (after phase 18), over a
     deployment of phase 18's pages (a database, local storage with their
     PNG payloads, an fde index): check_completeness (consistent; --gc-apply
     on an empty index root refused with exit 2, nothing deleted),
     scrub_metadata (dry run, apply), export_chunks_resumable (one run
     against a run interrupted after a shard and resumed: the same bytes),
     rebuild_fde under another FDE config (a self-query first after the
     reopen), migrate_index_format on a legacy snapshot, migrate_store_provider
     fde -> fde (every row kept; --to binary refused), purge_app; then
     soak_serving for SOAK_S s with 2 ingesters and 2 queriers on phase 3b's
     model (no 5xx, drained, no pending task). Prints a {"scripts": ...}
     line.
 20. the evaluation harnesses and the measuring twins on the card (after
     phase 19), launch counts reset before and read after: the int8
     fidelity gate's Part A at the 3B width with the small counts (24
     pages, 8 queries: a bf16 3B tower from a seed, then quantized in
     place; K3 in the tower, K1 in the rerank and the score matrix) and
     Part B at 100,000 clustered rows, its verdict reported, not checked;
     colpali_eval --small on the trained fixture (identity rung recall@10
     1.0); the offline RAG eval's builtin corpus (recall@4 1.0);
     profile_int8's matmul families at the 3B shapes (bf16, q8, q8 with
     the activations quantized beforehand); bench_ingest --small (12
     pages through the job queue, each stage alone). Prints an
     {"evals": ...} line; the kernels line gains `evals_launches`.
 21. the mesh paths (after phase 20), on phase 3b's int8 + static-scales
     model: (a) `build_services` from the toml with `tpu.auto_mesh = true`
     (`mesh_shape = [-1, 1]`) and one visible card serves single-device:
     no mesh; (b) a virtual (data 2, model 2) mesh whose four entries are
     this card: phase 3b's model is put on it in place
     (`shard_colqwen_params`: the decoder tensor-parallel over "model"),
     phase 3b's 8 pages embedded (two data shards of 4, K3 28 a shard
     forward) equal the single-device embeddings of the same per-shard
     batches bit for bit, and stay within mean page cosine 0.9999 of the
     single-device batch of 8 (its max abs diff printed: other GEMM
     shapes); the text queries' tokens and embeddings equal the
     single-device encode's; (c) phase 4's 2,048 rows plus
     MESH_SYNTH short synthetic rows (16,384 rows, 16 blocks) in a mesh
     index and a single-device one, the shipped retrieval config: phase
     5's queries give the same ids, scores within MESH_SCORE_ATOL, with
     the pooled tier (K1 on each data shard); the mesh-encoded queries the
     same top-1 as the single-device ones; a doc_ids-filtered query keeps
     to the gate; `last_mesh_upload_rows` cold = every row, warm = 0, and
     <= one block after a store of MESH_TAIL rows; (d) the HTTP server on
     that mesh (`build_services(mesh=...)`), serving phase 8's static
     scales (restored, `model.static_act_scales` off: a boot recalibrates
     from the scales in place and serves slightly other ones): phase 8's 9 PNG pages
     ingested, the text queries' /retrieve/chunks give phase 8's
     filenames in the same order, scores within 1e-2 relative (the
     reference's test_mesh_serving.py bound). Each step's seconds, launches
     and peak memory are printed with the card: a virtual mesh runs its
     shards one after another on one card, so no figure here is a
     multi-card speed. Prints a {"mesh": ...} line; the kernels line gains
     `mesh_launches`.
 22. the page image formats (run after phase 20 and before phase 21,
     which puts the model on its mesh in place), on a server from the
     toml serving phase 3b's model: each committed file of
     tests/fixtures/image_formats.npz (BMPs of 1, 4, 8, 16, 24 and 32 bits
     and RLE8 / RLE4; a GIF, an animated GIF, an interlaced offset GIF;
     TIFFs in Group 4, Group 3 1D and 2D, Modified Huffman, LZW with
     predictor 2, Deflate tiles (big-endian), PackBits, raw WhiteIsZero
     gray, YCbCr JPEG, and a multi-page LZW file; lossy, lossless, alpha
     and animated WebPs; CMYK and YCCK JPEGs) decodes to Pillow's mode and
     pixels (hashes written beside Pillow), each timed on the host, and a
     letter page at 200 dpi as Group 4 (1700 x 2200) and a lossy WebP
     1024 px wide timed beside a baseline JPEG of the same page; an
     arithmetic-coded and a 12-bit JPEG are refused from their headers, the
     first answering 415 over HTTP before any document exists, the second
     (which `Image.open` fails on) completing with no page, as the
     reference's job does; each file is
     ingested over HTTP to `completed` with one page (the first frame or
     page), the reference's q80 payload byte for byte (hashes made by the
     JAX package's `_image_to_data_uri`); K3 = 28 a tower forward; image
     queries in WebP and TIFF (Group 4 and LZW) each find a file of their
     own page first, through K1. Prints a {"formats": ...} line (host
     decode ms per file and size, ingest s per file, image query ms,
     launches, peak memory, the phase's s, the card); the kernels line
     gains `formats_launches`. The phase also runs
     tests/fixtures/image_formats_more.npz: Netpbm (P6, 16-bit P5, plain
     P1, Pf), ICO, CUR, PSD (RGB over a layer section, CMYK), PCX (RGB,
     256 colours), DCX, TGA (RLE, colour-mapped, mirrored 32-bit), SGI RLE,
     Sun RLE, QOI, XBM, XPM and arithmetic-coded (sequential, progressive)
     and lossless (gray, RGB with restarts) JPEGs, each decoded to Pillow's
     mode and pixels and ingested to the reference's payload; each decoder
     timed on the 200 dpi letter page beside a baseline JPEG of it (the
     arithmetic-coded letter page, whose data run past Pillow's 64 KiB
     block, with the port's refusal of it off); a hierarchical JPEG and an
     AVIF file answering 415, a 12-bit JPEG completing with no page; PNM, PSD and
     arithmetic-coded JPEG image queries each finding a file of their own
     page first. And tests/fixtures/image_formats_jp2.npz: JP2 (9/7, 3
     layers), raw J2K (5/3), tiles with offsets, precincts, RPCL and SOP /
     EPH, every code-block style with POC and an ROI shift, I;16,
     subsampled chroma (Pillow's sYCC), a palette (P) and RGBA, each decoded
     on the card (tier-1 through K5) to Pillow's mode and pixels and
     ingested to the reference's payload, K5 once a file and K3 28 a
     forward, counted on their own; a JP2 image query finding its own page
     first; the letter page, lossless and 9/7, timed by stage (headers and
     tier-2, K5, the DWT and component transforms, Pillow's unpacking)
     beside its baseline JPEG; HTJ2K and Part-2 files answering 415.
 23. text pages in every left-to-right script (after phase 22, before
     phase 21), on a server from the toml serving phase 3b's model: the
     host render ms of a page (`render_text_page` at 150 dpi, median of 3)
     in Latin, Cyrillic, CJK, Hebrew, Arabic, vocalized Arabic and pointed
     Hebrew beside a Latin-1 page of the same length; the DOCX, PPTX and 6-page PDF of
     tests/fixtures/text_pages.npz (Greek, Cyrillic, Vietnamese, Romanian,
     symbols, box drawing, the font's emoji, CJK boxes; a `Г“A`
     script-boundary kerning case) and the Hebrew DOCX,
     Arabic PPTX and 4-page Hebrew / Arabic / mixed PDF of
     tests/fixtures/rtl_pages.npz (bidi levels, mirrored brackets, Arabic
     joining, lam-alef, bidi controls) ingested over HTTP to `completed`,
     every stored page the reference's payload byte for byte (q80 for DOCX
     / PPTX, q70 from the raster pool for the PDF; made by the JAX package
     under PIL); K3 = 28 a tower forward; an image query of the boundary
     page's payload and one of the mixed right-to-left page's find their
     pages first, through K1. Since PR 21, combining marks placed by the
     font's GPOS anchors: the DOCX (Russian stress marks, IPA, Vietnamese
     stacks), PPTX (vocalized Arabic) and 3-page PDF (pointed Hebrew,
     polytonic Greek, mixed right-to-left) of tests/fixtures/mark_pages.npz
     the same way, the render ms of vocalized Arabic and pointed Hebrew
     pages, an image query of a vocalized Arabic slide. The complex
     scripts shaped as HarfBuzz 12 shapes them (the Hindi, Bengali
     and Tamil DOCX, the Thai, Lao and Khmer PPTX and the Myanmar,
     Sinhala, Tibetan, Tifinagh, Syriac, jamo and mixed PDF of
     tests/fixtures/complex_pages.npz) the same way, the render ms of a
     Devanagari, a Thai, a Lao and a Khmer page, an image query of the
     Khmer slide. N'Ko, the newer Arabic letters and Ahom
     (tests/fixtures/nko_pages.npz) the same way. The text pages' last
     refusals, drawn: the DOCX (IPA tone contours, ZWJ emoji in Hebrew and
     Arabic paragraphs), PPTX (CJK Extensions I and J, Garay, Unicode 16
     Latin and Cyrillic) and 4-page PDF (isolates open at paragraph
     separators, lines of more than 62 bidi controls, tone letters, Unicode
     17 text) of tests/fixtures/unicode17_pages.npz, and the PDF with a page
     of tone letters and the one with a page of U+1C89 that were refused
     before, each page the reference's payload; an image query of the Garay
     slide; two more servers on phase 3b's model at `pdf.colpali_pdf_dpi`
     72 and 300 store that PDF's reference payloads at those dpis; a build
     at dpi 110 (13 px, a size the atlas lacks) raises naming item 3b-ii
     and leaves no row. The two formerly refused PDFs uploaded again,
     drawn with a copy of the atlas that classes U+02E9 and U+1C89
     MISDRAWN, end `failed`, their errors naming item 3b-ii, with no row
     of them in the ColPali or the text store and /health's row counts
     unchanged. The render ms of the Unicode 17, tone-contour and
     right-to-left emoji pages, and of the Latin-1 page at 72, 150 and 300
     dpi. Prints a {"text_pages": ...} line; the kernels line gains
     `text_pages_launches`.
The last line is {"ok": true, "device": {...}}. Without CUDA, an sm_90
card, nvcc or the package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
GRID = (20, 28)  # pages at grid 20 x 28 units (560 x 784 px)
BATCH = 8
N_SYNTH = 2040  # synthetic rows stored beside the 8 pages
BLOCK_ROWS = 1024  # small device blocks: the 2048-row index spans 2
SHIPPED = dict(  # morphik_tpu.toml [vector_store] (compact_min_rows: the config default), no mesh
    prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8",
    device_cache_slots=2048, device_cache_token_bucket=1024, rerank_dtype="int8",
    rerank_prefilter_pooling=4, pooled_tier_factor=32, pooled_tier_budget_mb=6144,
    query_token_dedup=0.98, compact_dead_fraction=0.25, compact_min_rows=4096,
)
N_APPEND = 2048  # phase 9: rows appended to the 2048 saved ones, reaching compact_min_rows
N_DELETE = 1100  # phase 9: the 1025th delete takes the dead share of 4096 rows past 0.25
QUERIES = ["quarterly revenue growth", "table of contents", "signature page of the contract",
           "figure 3: latency distribution"]
# K1: per-token products are bit-identical to the plain version; only the
# f32 sum over <= 640 query tokens is reordered (|err| <= 640 * 2^-24 * sum|terms|).
K1_RTOL, K1_ATOL = 1e-5, 1e-4
# K2: the f32 query (and f32 docs) enter the tensor cores split into bf16
# hi + lo (~2^-17 of |d||q| per dot), accumulated in another order than
# the plain einsum, summed over <= 640 query tokens.
K2_RTOL, K2_ATOL = 1e-4, 1e-3
# K3 in f32: the plain einsums and softmax sum in another order.
K3_F32_ATOL = 1e-5
# K3 in bf16: the plain einsum rounds the scores to bf16 before the f32
# softmax, K3 keeps them in f32 as the Pallas kernel does, and both round
# P and the output to bf16. Measured 1.5625e-2 on one NVIDIA H100 (one
# bf16 ulp of an output in [2, 4)); the bound allows two.
K3_BF16_ATOL = 3e-2
# F.scaled_dot_product_attention in f32, timed beside the f32 K3 (the
# port never calls it): its fused kernels sum in their own order, so it
# is held to the plain version at 1e-4.
SDPA_F32_ATOL = 1e-4
# K3 in bf16 against window_attention_pallas_numerics, which rounds where
# the Pallas kernel does: one bf16 ulp of an output (rtol 2^-7) plus 1e-3.
# A P whose f32 value differs by an ulp (exp, sum order) can round to the
# other bf16 neighbour and move an output by ulp(P) |v|; at the path's
# 22.9 M outputs a few exceed the tight bound, so at most one in 10^6 may.
K3_MIRROR_RTOL, K3_MIRROR_ATOL, K3_MIRROR_MAX_SHARE = 2.0**-7, 1e-3, 1e-6
WINDOW = 64  # patches per vision window (4 x 4 merge units of 2 x 2)
# mean per-token cosine of the int8 + static embeddings against the bf16
# tower's on the same pages and weights (the measure of the reference's
# tests/test_quantized_serving.py, whose bound 0.98 is for the tiny
# model). At 3B depth with random weights it measured 0.9603 on one
# NVIDIA H100 (min 0.908): 32 + 36 quantized blocks compound the error.
MIN_MEAN_COSINE = 0.95
# the same measure for the text queries' embeddings (36 quantized
# decoder layers, dynamic scales on the text side): it measured 0.9840
# on one NVIDIA H100 (min 0.976) over the four queries.
MIN_QUERY_COSINE = 0.97
# phase 21: the virtual mesh, its index and its bounds
MESH_SHAPE = (2, 2)  # (data, model), every entry this card
MESH_SYNTH = 14_336  # short synthetic rows beside phase 4's 2,048: 16,384 rows, 16 blocks of BLOCK_ROWS
MESH_SYNTH_TOKENS = (64, 161)  # short rows keep the ingest pooling (host k-means) cheap; phase 4's rows are long
MESH_TAIL = 100  # rows stored after the warm query: the refresh re-uploads at most one block
MESH_SCORE_ATOL = 1e-5  # index scores, mesh vs single device: the same rows through the same K1 rerank
MESH_MIN_PAGE_COSINE = 0.9999  # the mesh's pages against the single-device batch of 8 (other GEMM shapes)
MESH_REL_SCORE = 1e-2  # HTTP scores, mesh vs phase 8 (tests/test_mesh_serving.py's bound)


def log(msg: str) -> None:
    print(msg, flush=True)


def setup():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "morphik_core_tpu_torch" / "csrc" / "window_attention.cu").is_file():
        raise SystemExit("chip_smoke: morphik_core_tpu_torch/ not found beside this script")
    sys.path.insert(0, str(ROOT))
    from morphik_core_tpu_torch.device import kernels_available

    if not kernels_available():
        raise SystemExit(f"chip_smoke: needs an sm_90 card, got {torch.cuda.get_device_capability(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch, smi


SASS_OPS = {op: r"\b" + re.escape(op) + r"[.\s]" for op in ("HMMA", "IMMA", "LDSM", "LDGSTS", "FFMA", "MUFU.EX2",
                                                                "POPC")}
SASS_OPS["HMMA.TF32"] = r"\bHMMA\.[\w.]*TF32\b"  # tensor-core products with TF32 operands
K3_BF16_SASS = "window_attention_mma_kernel<64,80>"
K3_F32_SASS = re.compile(r"window_attention_tf32_kernel<64,80,(1|true)>")  # the path's shape, exact instantiation
K4_SASS = "binary_maxsim_kernel<4,1>"  # 16 packed bytes, one query token a thread: phase 18's queries


def build_kernels():
    from morphik_core_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.build(verbose=True)
    _kernels.library()
    log(f"phase 1: kernels built (nvcc, from source) and loaded in {time.perf_counter() - t0:.3f} s")
    counts = sass_counts(lib, Path(_kernels._nvcc()).parent)
    for name, ops in counts.items():
        log(f"  SASS {name}: {json.dumps(ops)}")
    k3 = counts.get(K3_BF16_SASS, {})
    if not all(k3.get(op) for op in ("HMMA", "LDSM", "LDGSTS")):
        raise AssertionError(f"the bf16 K3 at the path's shape is not a tensor-core kernel: {k3}")
    k3 = next((ops for name, ops in counts.items() if K3_F32_SASS.fullmatch(name)), {})
    if not all(k3.get(op) for op in ("HMMA.TF32", "LDGSTS")):
        raise AssertionError(f"the f32 K3 at the path's shape is not a TF32 tensor-core kernel with cp.async: {k3}")
    if not counts.get(K4_SASS, {}).get("POPC"):
        raise AssertionError(f"K4 at 16 packed bytes has no POPC: {counts.get(K4_SASS)}")
    return counts


def sass_counts(lib: Path, cuda_bin: Path) -> dict:
    """Per kernel of the built library, how many of SASS_OPS its machine
    code holds (cuobjdump --dump-sass; names demangled by cu++filt)."""
    sass = subprocess.run([str(cuda_bin / "cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
        elif cur is not None:
            for op, pattern in SASS_OPS.items():
                if re.search(pattern, line):
                    cur[op] += 1
    names = subprocess.run([str(cuda_bin / "cu++filt"), *counts], capture_output=True, text=True,
                           check=True, timeout=60).stdout.splitlines()
    # "void <unnamed>::window_attention_mma_kernel<(int)64, (int)80>(...)" -> "window_attention_mma_kernel<64,80>"
    labels = [re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\(int\)|\(bool\)", "", n).replace(", ", ",").split("(")[0]
              for n in names]
    return dict(zip(labels, counts.values()))


def _time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call: one replay of a CUDA graph of `iters` calls
    (no host cost between launches). Outputs and scratch come from the
    graph's own memory pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
# dense peak rates of one H100 SXM (NVIDIA's data sheet): int8 and bf16 on
# the tensor cores, f32 outside them
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def _bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (inputs read once, output written once) over the HBM rate and
    its operations over the peak rate of their type."""
    bytes_us = bytes_moved / HBM_BYTES_PER_S * 1e6
    ops_us = ops / PEAK_OPS_PER_S[kind] * 1e6
    return {"bytes_us": bytes_us, "ops_us": ops_us, "bound_us": max(bytes_us, ops_us),
            "bound_by": "bytes" if bytes_us >= ops_us else "operations"}


def _compare(torch, name, kernel_fn, plain_fn, rtol, atol, exact=False, bound=None, plain_iters=20):
    """The kernel against its plain version, then both timed in turns
    (plain, kernel, kernel, plain). With `plain_iters=0` (a plain version
    that takes seconds a call) the plain side is timed only over the
    comparison's own call, with CUDA events, and its device time is not
    measured."""
    got = kernel_fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_fn()
    end.record()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{name}: expected bit-identical scores, max err {err}")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max err {err} beyond rtol={rtol} atol={atol}")
    p1 = pg1 = p2 = pg2 = None
    if plain_iters:
        p1, pg1 = _time_ms(torch, plain_fn, plain_iters), _graph_ms(torch, plain_fn, plain_iters)
    k1, kg1 = _time_ms(torch, kernel_fn), _graph_ms(torch, kernel_fn)
    k2, kg2 = _time_ms(torch, kernel_fn), _graph_ms(torch, kernel_fn)
    if plain_iters:
        p2, pg2 = _time_ms(torch, plain_fn, plain_iters), _graph_ms(torch, plain_fn, plain_iters)
    res = {"case": name, "max_abs_err": err, "ms": (k1 + k2) / 2,
           "plain_ms": (p1 + p2) / 2 if plain_iters else start.elapsed_time(end), "device_ms": (kg1 + kg2) / 2,
           "plain_device_ms": (pg1 + pg2) / 2 if plain_iters else None}
    extra = ""
    if bound is not None:
        res.update(bound)
        extra = (f" bytes_us={bound['bytes_us']:.3f} ops_us={bound['ops_us']:.3f} bound_us={bound['bound_us']:.3f}"
                 f" ({bound['bound_by']}, {bound['bound_us'] / (res['device_ms'] * 1e3):.1%} of it)")
    plain_dev = f"{res['plain_device_ms']:.5f}" if plain_iters else "not measured"
    log(f"  {name}: max_abs_err={err:.3e} kernel_ms={res['ms']:.5f} plain_ms={res['plain_ms']:.5f} "
        f"kernel_device_ms={res['device_ms']:.5f} plain_device_ms={plain_dev}{extra}")
    return res


def _deterministic(torch, name, fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    log(f"  {name}: two calls bit-identical")


def kernel_checks(torch):
    """Phase 2: K1, K2 and K3 against their plain versions on the card."""
    import numpy as np

    from morphik_core_tpu_torch.index.multivector_index import MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.ops.maxsim import (
        maxsim, maxsim_plain, maxsim_q8, maxsim_q8_plain, quantize_query_q8,
    )

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    D = 128

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def query_q8(nq):
        q = rng.standard_normal((nq, D)).astype(np.float32)
        q8, qs = quantize_query_q8(q / np.linalg.norm(q, axis=1, keepdims=True))
        return t(q8), t(qs)

    def pool_q8(rows, n_pad, lengths):  # large pools are drawn on the card
        d8 = torch.randint(-127, 128, (rows, n_pad, D), generator=gen, device=dev, dtype=torch.int8)
        ds = torch.rand((rows, n_pad), generator=gen, device=dev) * 0.01 + 1e-3
        mask = t((np.arange(n_pad)[None, :] < lengths[:, None]).astype(np.float32))
        return d8, ds * mask, mask

    def docs_f(rows, n_pad):
        return torch.randn((rows, n_pad, D), generator=gen, device=dev) / D**0.5

    def query_f32(nq, pad_to):
        q = np.zeros((pad_to, D), np.float32)
        q[:nq] = rng.standard_normal((nq, D)).astype(np.float32) / np.sqrt(D)
        return t(q)

    def n_read(c, idx=None):  # candidates whose row is read
        return c if idx is None else int((idx >= 0).sum())

    def k1_bound(c, n_pad, q8, idx=None):  # int8 docs + ds + mask, query + scales, f32 scores
        n = n_read(c, idx)
        return _bound(n * n_pad * (D + 8) + q8.shape[0] * (D + 4) + 4 * c,
                      2 * q8.shape[0] * n * n_pad * D, "int8")

    def k2_bound(c, n_pad, q, esize, idx=None):  # docs + mask, f32 query, f32 scores
        n = n_read(c, idx)  # flops at the bf16 tensor-core rate: the least the card could take
        return _bound(n * n_pad * (D * esize + 4) + q.numel() * 4 + 4 * c,
                      2 * q.shape[0] * n * n_pad * D, "bf16")

    # the main path's self-query: stored row BATCH + 123 (synthetic row 123);
    # the rerank gets all its tokens, the pooled stage its deduplicated ones
    q_self = synthetic_rows((600, 661), 124)[123].astype(np.float32)
    q_sel = MultiVectorIndex(FDEConfig(), device="cuda", **SHIPPED)._dedup_query_tokens(q_self)
    log(f"phase 2: kernels vs plain on the card (self-query {q_self.shape[0]} tokens, "
        f"{q_sel.shape[0]} after dedup)")
    k1, k2 = [], []
    # K1 at the pooled stage: tier block (1024 rows, bucket 24), pool 304
    # gathered in-kernel, rows of the other block = -1
    d8, ds, m = pool_q8(BLOCK_ROWS, 24, rng.integers(1, 25, BLOCK_ROWS))
    idx = rng.integers(0, BLOCK_ROWS, 304).astype(np.int32)
    idx[rng.random(304) < 0.5] = -1
    q8, qs = query_q8(32)
    idx_t = t(idx)
    k1.append(_compare(torch, "K1 pooled stage C=304 Np=24 NQ=32 (idx)",
                       lambda: maxsim_q8(q8, qs, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8, qs, d8, ds, m, idx_t), K1_RTOL, K1_ATOL,
                       bound=k1_bound(304, 24, q8, idx)))
    q8s, qss = (t(x) for x in quantize_query_q8(q_sel))
    k1.append(_compare(torch, f"K1 pooled stage, self-query C=304 Np=24 NQ={q8s.shape[0]} (idx)",
                       lambda: maxsim_q8(q8s, qss, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8s, qss, d8, ds, m, idx_t), K1_RTOL, K1_ATOL,
                       bound=k1_bound(304, 24, q8s, idx)))
    # K1 at the cache rerank: 2048 int8 slots of 1024 tokens, 32 gathered
    d8, ds, m = pool_q8(2048, 1024, rng.integers(500, 1025, 2048))
    idx_t = t(rng.choice(2048, 32, replace=False).astype(np.int32))
    k1.append(_compare(torch, "K1 cache rerank C=32 Np=1024 NQ=32 (idx)",
                       lambda: maxsim_q8(q8, qs, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8, qs, d8, ds, m, idx_t), K1_RTOL, K1_ATOL,
                       bound=k1_bound(32, 1024, q8)))
    main_k1 = k1[-1]
    q8s, qss = (t(x) for x in quantize_query_q8(q_self))
    k1.append(_compare(torch, f"K1 cache rerank, self-query C=32 Np=1024 NQ={q8s.shape[0]} (idx)",
                       lambda: maxsim_q8(q8s, qss, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8s, qss, d8, ds, m, idx_t), K1_RTOL, K1_ATOL,
                       bound=k1_bound(32, 1024, q8s)))
    # one real query token (+7 zero rows): score = one max, bit-identical
    q8_1, qs_1 = query_q8(1)
    _compare(torch, "K1 single query token (exact)",
             lambda: maxsim_q8(q8_1, qs_1, d8, ds, m, idx_t),
             lambda: maxsim_q8_plain(q8_1, qs_1, d8, ds, m, idx_t), 0.0, 0.0, exact=True)
    # ragged: C = 13, one fully masked candidate, zero query rows, NQ > 256
    lengths = rng.integers(1, 700, 13)
    lengths[5] = 0
    d8r, dsr, mr = pool_q8(13, 700, lengths)
    q8r, qsr = query_q8(633)  # padded to 640: 7 zero rows
    got = _compare(torch, "K1 ragged C=13 Np=700 NQ=640, masked cand",
                   lambda: maxsim_q8(q8r, qsr, d8r, dsr, mr),
                   lambda: maxsim_q8_plain(q8r, qsr, d8r, dsr, mr), K1_RTOL, K1_ATOL,
                   bound=k1_bound(13, 700, q8r))
    if float(maxsim_q8(q8r, qsr, d8r, dsr, mr)[5]) != 0.0:
        raise AssertionError("K1: a fully masked candidate must score exactly 0")
    _deterministic(torch, "K1 ragged NQ=640", lambda: maxsim_q8(q8r, qsr, d8r, dsr, mr))
    k1.append(got)

    # K2 at the bf16 cache rerank: 2048 bf16 slots of 1024 tokens; the
    # cache passes the query unpadded (29 text tokens, 631 self-query)
    docs = docs_f(2048, 1024).to(torch.bfloat16)
    mask = m  # same ragged slot lengths
    qf = query_f32(29, 32)
    k2.append(_compare(torch, "K2 cache rerank bf16 C=32 Np=1024 NQ=32 (idx)",
                       lambda: maxsim(qf, docs, mask, idx_t),
                       lambda: maxsim_plain(qf, docs, mask, idx_t), K2_RTOL, K2_ATOL,
                       bound=k2_bound(32, 1024, qf, 2)))
    qf29 = qf[:29].contiguous()
    k2.append(_compare(torch, "K2 cache rerank bf16 C=32 Np=1024 NQ=29 (idx)",
                       lambda: maxsim(qf29, docs, mask, idx_t),
                       lambda: maxsim_plain(qf29, docs, mask, idx_t), K2_RTOL, K2_ATOL,
                       bound=k2_bound(32, 1024, qf29, 2)))
    main_k2 = k2[-1]
    qfs = t(q_self)
    k2.append(_compare(torch, f"K2 cache rerank bf16, self-query C=32 Np=1024 NQ={qfs.shape[0]} (idx)",
                       lambda: maxsim(qfs, docs, mask, idx_t),
                       lambda: maxsim_plain(qfs, docs, mask, idx_t), K2_RTOL, K2_ATOL,
                       bound=k2_bound(32, 1024, qfs, 2)))
    del docs
    # K2 cold rerank layout (no idx), bf16, C = 32, Np = round_up(max_n, 128)
    docs_c = docs_f(32, 768).to(torch.bfloat16)
    mask_c = t((np.arange(768)[None] < rng.integers(600, 700, 32)[:, None]).astype(np.float32))
    k2.append(_compare(torch, "K2 cold rerank bf16 C=32 Np=768 NQ=32",
                       lambda: maxsim(qf, docs_c, mask_c),
                       lambda: maxsim_plain(qf, docs_c, mask_c), K2_RTOL, K2_ATOL,
                       bound=k2_bound(32, 768, qf, 2)))
    # ragged f32: C = 13, fully masked candidate, zero query rows, NQ = 640
    docs_r = docs_f(13, 700)
    mask_r = t((np.arange(700)[None] < lengths[:, None]).astype(np.float32))
    qfr = query_f32(633, 640)
    k2.append(_compare(torch, "K2 ragged f32 C=13 Np=700 NQ=640, masked cand",
                       lambda: maxsim(qfr, docs_r, mask_r),
                       lambda: maxsim_plain(qfr, docs_r, mask_r), K2_RTOL, K2_ATOL,
                       bound=k2_bound(13, 700, qfr, 4)))
    if float(maxsim(qfr, docs_r, mask_r)[5]) != 0.0:
        raise AssertionError("K2: a fully masked candidate must score exactly 0")
    _deterministic(torch, "K2 ragged f32 NQ=640", lambda: maxsim(qfr, docs_r, mask_r))
    del docs_r
    # K2 at the reranker's shape (ColQwenReranker over the oversampled
    # chunks of a text retrieve, phase 8): the f32 query of one text query,
    # RERANK_C f32 chunks of byte tokens, the longest a 6000-character chunk
    nq_t, np_t = rerank_token_counts()
    n_pad_t = -(-np_t // 128) * 128  # pad_multivectors
    lengths_t = rng.integers(np_t // 4, np_t + 1, RERANK_C)
    lengths_t[0] = np_t
    docs_t = docs_f(RERANK_C, n_pad_t)
    mask_t = t((np.arange(n_pad_t)[None] < lengths_t[:, None]).astype(np.float32))
    qft = query_f32(nq_t, nq_t)
    rerank_k2 = _compare(torch, f"K2 reranker f32 C={RERANK_C} Np={n_pad_t} NQ={nq_t}",
                         lambda: maxsim(qft, docs_t, mask_t), lambda: maxsim_plain(qft, docs_t, mask_t),
                         K2_RTOL, K2_ATOL, bound=k2_bound(RERANK_C, n_pad_t, qft, 4))
    k2.append(rerank_k2)
    del docs_t
    k3 = window_attention_checks(torch, gen)
    return main_k1, main_k2, k3[0], k3[1], k3[2], rerank_k2, k1 + k2 + k3


def rerank_token_counts():
    """(query tokens of TEXT_QUERIES[0], tokens of a chunk_size-character
    chunk) under the tower's byte tokenizer (`query_token_ids`)."""
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel

    def n_tokens(text):
        return len((ColQwenModel.QUERY_PREFIX + text).encode()) + ColQwenModel.QUERY_AUGMENTATION_TOKENS

    return n_tokens(TEXT_QUERIES[0]), n_tokens("x" * CHUNK_SIZE)


def window_attention_checks(torch, gen):
    """K3 against `window_attention_plain`: the windowed vision blocks'
    shape (8 pages at grid 20 x 28: T = 17,920 rows, 16 heads of 80) in
    bf16 and f32, phase 11's PDF pages (8 at grid 28 x 24: T = 21,504) in
    bf16, and a ragged edge (one window of 32, D = 64). The bf16 cases are
    also held to the Pallas kernel's rounding, called twice for
    bit-identity, and timed beside F.scaled_dot_product_attention."""
    from morphik_core_tpu_torch.models.colqwen.config import VisionConfig
    from morphik_core_tpu_torch.ops import _kernels
    from morphik_core_tpu_torch.ops.window_attention import (
        window_attention, window_attention_pallas_numerics, window_attention_plain,
    )

    vc = VisionConfig()
    t = BATCH * GRID[0] * GRID[1] * vc.merge_unit
    t_doc = BATCH * DOC_GRID[0] * DOC_GRID[1] * vc.merge_unit  # phase 11's PDF pages
    cases = []
    for label, (rows, heads, dim, win, dtype, atol) in {
        f"K3 vision blocks bf16 T={t} H={vc.num_heads} D={vc.head_dim} window={WINDOW}":
            (t, vc.num_heads, vc.head_dim, WINDOW, torch.bfloat16, K3_BF16_ATOL),
        f"K3 vision blocks bf16 T={t_doc} H={vc.num_heads} D={vc.head_dim} window={WINDOW} (PDF pages)":
            (t_doc, vc.num_heads, vc.head_dim, WINDOW, torch.bfloat16, K3_BF16_ATOL),
        f"K3 vision blocks f32 T={t} H={vc.num_heads} D={vc.head_dim} window={WINDOW}":
            (t, vc.num_heads, vc.head_dim, WINDOW, torch.float32, K3_F32_ATOL),
        "K3 ragged edge f32 T=32 H=3 D=64 window=32 (one window)": (32, 3, 64, 32, torch.float32, K3_F32_ATOL),
    }.items():
        q, k, v = (torch.randn((rows, heads, dim), generator=gen, device="cuda").to(dtype) for _ in range(3))
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        bound = _bound(4 * q.numel() * q.element_size(), 4 * rows * win * dim * heads, kind)
        case = _compare(torch, label, lambda: window_attention(q, k, v, window=win),
                        lambda: window_attention_plain(q, k, v, window=win), 0.0, atol, bound=bound)
        case["occupancy"] = _kernels.window_attention_occupancy(dtype, dim, win)
        log(f"  {label}: resident per SM {json.dumps(case['occupancy'])}")
        if dtype == torch.bfloat16:
            mirror = window_attention_pallas_numerics(q, k, v, window=win)
            case.update(_near_mirror(torch, label, window_attention(q, k, v, window=win), mirror))
            _deterministic(torch, label, lambda: window_attention(q, k, v, window=win))
            case.update(sdpa_yardstick(torch, q, k, v, win, mirror, K3_BF16_ATOL))
            case.update(same_bytes_yardstick(torch, q, k, v))
        elif rows == t:
            plain = window_attention_plain(q, k, v, window=win)
            case.update(sdpa_yardstick(torch, q, k, v, win, plain, SDPA_F32_ATOL))
        cases.append(case)
    return cases


def _near_mirror(torch, name, got, want):
    """The bf16 K3 against the Pallas kernel's rounding: every output but
    a share of at most K3_MIRROR_MAX_SHARE within rtol 2^-7, atol 1e-3."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    beyond = float((diff > K3_MIRROR_ATOL + K3_MIRROR_RTOL * want.abs()).float().mean())
    res = {"mirror_max_abs_err": float(diff.max()), "mirror_share_beyond_tol": beyond,
           "mirror_share_differing": float((diff > 0).float().mean())}
    log(f"  {name} vs the Pallas-numerics mirror: max_abs_err={res['mirror_max_abs_err']:.3e} "
        f"share beyond rtol 2^-7 atol {K3_MIRROR_ATOL}: {beyond:.3e} (bound {K3_MIRROR_MAX_SHARE}); "
        f"share differing: {res['mirror_share_differing']:.3e}")
    if beyond > K3_MIRROR_MAX_SHARE:
        raise AssertionError(f"{name}: {beyond} of the outputs beyond the mirror's tolerance")
    return res


def sdpa_yardstick(torch, q, k, v, window, want, atol):
    """One PyTorch call that computes K3's function:
    F.scaled_dot_product_attention on the (windows, H, window, D) view of
    q/k/v (default scale D^-1/2). Timed like the kernel, held to `want`
    (bf16: the Pallas-numerics mirror; f32: the plain version) within
    `atol`; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    t, h, d = q.shape

    def view(x):
        return x.view(t // window, window, h, d).transpose(1, 2)

    qw, kw, vw = view(q), view(k), view(v)
    backend = SDPBackend(torch._fused_sdp_choice(qw, kw, vw)).name

    def fn():
        return F.scaled_dot_product_attention(qw, kw, vw)

    err = float((fn().transpose(1, 2).reshape(t, h, d).float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"scaled_dot_product_attention is {err} from K3's reference (atol {atol})")
    ms = [_time_ms(torch, fn) for _ in range(2)]
    dev_ms = [_graph_ms(torch, fn) for _ in range(2)]
    res = {"library_call": f"F.scaled_dot_product_attention ({backend})", "library_max_abs_err": err,
           "library_ms": sum(ms) / 2, "library_device_ms": sum(dev_ms) / 2}
    log(f"  yardstick {res['library_call']}: max_abs_err vs reference={err:.3e} "
        f"ms={res['library_ms']:.5f} device_ms={res['library_device_ms']:.5f}")
    return res


def same_bytes_yardstick(torch, q, k, v):
    """What one elementwise pass that moves K3's bytes (read q, k, v once,
    write one (T, H, D) output) takes: torch.addcmul, device time. The
    rate the card reaches for these bytes, beside the data-sheet 3.35 TB/s."""
    dev_ms = sum(_graph_ms(torch, lambda: torch.addcmul(q, k, v)) for _ in range(2)) / 2
    rate = 4 * q.numel() * q.element_size() / (dev_ms * 1e-3)
    log(f"  same bytes, one elementwise pass (torch.addcmul): device_ms={dev_ms:.5f} ({rate / 1e12:.3f} TB/s)")
    return {"same_bytes_device_ms": dev_ms}


def _embed_pages(torch, emb, prepped):
    """Two timed runs of the batch (the first includes library start-up);
    returns (embeddings, fde rows, wall seconds, peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        embs, fdes = emb._embed_prepped(prepped, with_fde=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return embs, fdes, times, torch.cuda.max_memory_allocated() / 1e9


def _check_embeddings(model, embs, fdes):
    import numpy as np

    from morphik_core_tpu_torch.ops.fde import FDEConfig

    n_seq = len(model.image_sequence_ids(GRID[0] * GRID[1]))
    for e, f in zip(embs, fdes):
        if e.shape != (n_seq, model.cfg.embedding_dim) or (f is not None and f.shape != (FDEConfig().fde_dim,)):
            raise AssertionError(f"ingest shapes {e.shape} {None if f is None else f.shape}")
        if not (np.isfinite(e).all() and (f is None or np.isfinite(f).all())):
            raise AssertionError("ingest produced non-finite values")
        norms = np.linalg.norm(e, axis=1)
        if np.abs(norms - 1.0).max() > 1e-3:
            raise AssertionError(f"rows not unit-norm: {norms.min()} .. {norms.max()}")
    return n_seq


def _pages(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED)
    s = GRID[0] * GRID[1] * cfg.vision.merge_unit
    pages = rng.integers(0, 256, (BATCH, s, cfg.vision.patch_input_dim // 2), dtype=np.uint8)
    return [(p, GRID) for p in pages]


def ingest_bf16(torch, _kernels):
    """Phase 3a, the earlier path: the 3B model in bf16 embeds the batch."""
    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel

    t0 = time.perf_counter()
    cfg = ColQwenConfig()
    model = ColQwenModel.init_random(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3a: ColQwen2.5-3B geometry, {n_params} params in bf16, init {time.perf_counter() - t0:.3f} s")
    emb = ColpaliEmbeddingModel(model, batch_size=BATCH)
    _kernels.reset_launch_counts()
    embs, _, times, peak = _embed_pages(torch, emb, _pages(cfg))
    t0 = time.perf_counter()
    queries = [emb.embed_query(text) for text in QUERIES]
    query_s = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    n_seq = _check_embeddings(model, embs, [None] * len(embs))
    _check_queries(model, queries, "bf16")
    log(f"  bf16: {BATCH} pages -> {BATCH} x ({n_seq}, {cfg.embedding_dim}); batch wall s "
        f"first={times[0]:.4f} second={times[1]:.4f} pages/s(second)={BATCH / times[1]:.3f}; "
        f"peak mem GB={peak:.2f}; {len(QUERIES)} queries encoded by the bf16 text tower in "
        f"{query_s:.3f} s; launches {counts}")
    if counts["window_attention"] <= 0:
        raise AssertionError(f"the bf16 path never launched K3: {counts}")
    return model, embs, queries, dict(pages_per_s=BATCH / times[1], peak_gb=peak)


def _check_queries(model, queries, label):
    import numpy as np

    for q in queries:
        if q.ndim != 2 or q.shape[1] != model.cfg.embedding_dim or not np.isfinite(q).all():
            raise AssertionError(f"{label} query embedding: shape {q.shape} or non-finite")
        norms = np.linalg.norm(q, axis=1)
        if np.abs(norms - 1.0).max() > 1e-3:
            raise AssertionError(f"{label} query rows not unit-norm: {norms.min()} .. {norms.max()}")


def compare_queries(emb, bf16_queries):
    """The int8 text tower's query embeddings against the bf16 tower's on
    the same weights: mean per-token cosine."""
    import numpy as np

    int8_queries = [emb.embed_query(text) for text in QUERIES]
    _check_queries(emb.model, int8_queries, "int8")
    if [q.shape for q in int8_queries] != [q.shape for q in bf16_queries]:
        raise AssertionError("int8 and bf16 query embeddings differ in shape")
    cos = np.concatenate([(a * b).sum(-1) for a, b in zip(int8_queries, bf16_queries)])
    log(f"  int8 vs bf16 query per-token cosine: mean {cos.mean():.6f} min {cos.min():.6f} "
        f"(bound: mean > {MIN_QUERY_COSINE})")
    if not cos.mean() > MIN_QUERY_COSINE:
        raise AssertionError(f"int8 query embeddings drift from bf16: mean cosine {cos.mean()}")
    return float(cos.mean())


def ingest_int8(torch, model, bf16_embs):
    """Phase 3b, the main path's ingest: quantize the same weights in
    place, calibrate static scales at embedder start-up, embed the batch
    with the fused FDE and hold it against the bf16 embeddings."""
    import numpy as np

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import CALIBRATION_BATCH, ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.calibrate import load_calibration_pages
    from morphik_core_tpu_torch.models.colqwen.model import quantize_colqwen_params
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    t0 = time.perf_counter()
    quantize_colqwen_params(model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emb = ColpaliEmbeddingModel(model, batch_size=BATCH, fde_config=FDEConfig())  # the shipped defaults
    torch.cuda.synchronize()
    cal_s = emb.last_metrics["calibration_s"]
    if any(blk.q_w.a_scale is None or blk.down_w.a_scale is None for blk in model.visual.blocks):
        raise AssertionError("calibration left a vision block without static scales")
    embs, fdes, times, peak = _embed_pages(torch, emb, _pages(model.cfg))
    n_seq = _check_embeddings(model, embs, fdes)
    cos = np.concatenate([(a * b).sum(-1) for a, b in zip(embs, bf16_embs)])
    log(f"phase 3b: W8A8 + static scales: quantize in place {quant_s:.3f} s, calibration {cal_s:.3f} s "
        f"({len(load_calibration_pages()[0])} committed pages, batches of {CALIBRATION_BATCH}); "
        f"{BATCH} pages -> {BATCH} x "
        f"({n_seq}, {model.cfg.embedding_dim}) + FDE ({FDEConfig().fde_dim},); batch wall s "
        f"first={times[0]:.4f} second={times[1]:.4f} pages/s(second)={BATCH / times[1]:.3f}; "
        f"peak mem GB={peak:.2f}")
    log(f"  int8 vs bf16 per-token cosine: mean {cos.mean():.6f} min {cos.min():.6f} "
        f"p01 {np.quantile(cos, 0.01):.6f} (bound: mean > {MIN_MEAN_COSINE})")
    if not cos.mean() > MIN_MEAN_COSINE:
        raise AssertionError(f"int8 embeddings drift from bf16: mean cosine {cos.mean()}")
    return emb, embs, fdes, dict(pages_per_s=BATCH / times[1], peak_gb=peak, calibration_s=cal_s,
                                 mean_cosine=float(cos.mean()))


def synthetic_rows(n_tok_range, n: int, seed: int = SEED + 1):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((int(rng.integers(*n_tok_range)), 128)).astype(np.float32)
        out.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float16))
    return out


def make_index(torch, rows, page_fdes, synth_fdes=None, **over):
    """An index with the shipped retrieval config over the 8 pages (with
    their fused ingest FDE) and the synthetic rows (FDE by the store's
    own device encoder unless given)."""
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    index = MultiVectorIndex(FDEConfig(), device="cuda", device_block_rows=BLOCK_ROWS,
                             **dict(SHIPPED, **over))
    recs = [IndexRecord(document_id=f"page{i}" if i < BATCH else f"synth{i - BATCH}", chunk_number=0)
            for i in range(len(rows))]
    t0 = time.perf_counter()
    index.store(rows[:BATCH], recs[:BATCH], fde_vectors=page_fdes)
    index.store(rows[BATCH:], recs[BATCH:], fde_vectors=synth_fdes)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def answer(index, queries, k: int = 10):
    """[(document_id, score)] best-first for each query."""
    return [[(r.document_id, s) for r, s in index.query(q, k=k)] for q in queries]


def run_queries(torch, emb, index, rows, label):
    """The text queries (embedded by `emb`, timed with the index) and the
    self-query of stored row BATCH + 123. Returns the query embeddings and
    each one's [(document_id, score)]."""
    import numpy as np

    lat, queries, answers = [], [], []
    for text in QUERIES:
        t0 = time.perf_counter()
        q = emb.embed_query(text)
        res = index.query(q, k=10, return_timing=True)
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(res) != 10 or not all(np.isfinite(s) for _, s in res):
            raise AssertionError(f"{label}: query {text!r} returned {len(res)} results")
        if not index.last_timing["pooled_tier"]:
            raise AssertionError(f"{label}: the pooled tier did not serve the query")
        queries.append(q)
        answers.append([(r.document_id, s) for r, s in res])
    self_row = BATCH + 123
    q = np.asarray(rows[self_row], np.float32)
    t0 = time.perf_counter()
    res = index.query(q, k=10, return_timing=True)
    self_ms = (time.perf_counter() - t0) * 1e3
    top = res[0][0].document_id
    if top != f"synth{self_row - BATCH}":
        raise AssertionError(f"{label}: self-query top-1 is {top}")
    queries.append(q)
    answers.append([(r.document_id, s) for r, s in res])
    log(f"  {label}: text query ms {[round(x, 3) for x in lat]} (embed + index); "
        f"self-query top-1 ok, score {res[0][1]:.4f} vs n_tokens {q.shape[0]}, ms {self_ms:.3f}, "
        f"index timing {json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in index.last_timing.items()})}")
    return queries, answers


def run_encoded_queries(index, queries, label):
    """Query embeddings encoded earlier (the bf16 text tower's) through the
    index. Returns each one's [(document_id, score)]."""
    import numpy as np

    answers = answer(index, queries)
    for text, res in zip(QUERIES, answers):
        if len(res) != 10 or not all(np.isfinite(s) for _, s in res):
            raise AssertionError(f"{label}: query {text!r} returned {len(res)} results")
    log(f"  {label}: {len(queries)} queries, 10 finite results each")
    return answers


def brute_force_top1(torch, rows, q):
    """Exact f32 MaxSim of q against every stored row, chunked, on the card."""
    import numpy as np

    from morphik_core_tpu_torch.ops.maxsim import maxsim_scores_ref, pad_multivectors

    scores = []
    qt = torch.from_numpy(q).cuda()
    for s in range(0, len(rows), 128):
        dense, mask = pad_multivectors(rows[s : s + 128])
        scores.append(maxsim_scores_ref(qt, torch.from_numpy(dense).cuda(), torch.from_numpy(mask).cuda()))
    return int(torch.cat(scores).argmax())


# phase 8, the text half: three /ingest/text documents of seeded prose
# (the first two also into the ColPali store), one upload of each text
# type with use_colpali=false, then retrieves from the text store
TEXT_DOC_KB = (8, 12, 16)
TEXT_COLPALI = (True, True, False)
CHUNK_SIZE = 6000  # morphik_tpu.toml [parser] chunk_size
TEXT_QUERIES = ["quarterly revenue growth in the northern region", "supplier invoice renewal clause",
                "audit committee risk schedule"]
RERANK_C = 12  # the reranker's oversampling at k=4: max(k, min(3k, 20))
RERANK_SCORE_ATOL = 1e-3  # HTTP reranker scores vs an in-process ColQwenReranker (K2 within its tolerance)
_PROSE = (
    "the a of to in and for with on by from quarterly annual revenue growth margin region northern southern "
    "supplier invoice renewal clause contract signature page audit committee risk schedule budget forecast "
    "table figure latency distribution customer account payment terms policy review board meeting minutes "
    "report summary operations finance legal compliance product launch market share cost savings headcount "
    "inventory shipment warehouse logistics capital expenditure depreciation tax liability equity debt "
    "interest rate exchange currency hedging pension plan benefit employee retention training safety "
    "incident environment emissions energy water waste recycling community investment research "
    "development patent license software hardware service support contract term termination notice"
).split()

SERVICE_PAGES = 8  # PNG pages at GRID, plus one that takes the resize path
RESIZED_PAGE = (600, 830)  # height x width: bicubic to the same 20 x 28 bucket
RETRIEVE_REPEATS = 10
SERVICE_POLL_S = 120.0
SCORE_ATOL = 1e-5  # HTTP scores vs the in-process store's on the same embedding

# phase 11, documents as pages: a PDF of text pages (one of them "." alone,
# which renders blank and is skipped), a PPTX, a DOCX of four 3200-character
# pages and two JPEG uploads, at the shipped settings (150 dpi PDF pages
# -> 1024 x 1325 q70 payloads -> grid 28 x 24)
DOC_PDF_PAGES = 24
DOC_BLANK_PAGE = 11
DOC_SLIDES = 3
DOC_DOCX_CHARS = 10_000
DOC_JPEG_SIZES = ((1100, 1300), (784, 560))  # (h, w): the first takes the LANCZOS resize to 1024 wide
DOC_GRID = (28, 24)  # a 150 dpi page after the resize to 1024 x 1325
JPEG_FIXTURES = ROOT / "tests" / "fixtures" / "jpeg_decode_cases.npz"


def service_pages():
    """Seeded page images with structure (blocks and bars on white), so
    none is blank: 8 at GRID (560 x 784 px) and one at RESIZED_PAGE."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    sizes = [(GRID[0] * 28, GRID[1] * 28)] * SERVICE_PAGES + [RESIZED_PAGE]
    pages = []
    for h, w in sizes:
        page = np.full((h, w, 3), 255, np.uint8)
        for _ in range(int(rng.integers(6, 14))):
            y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
            page[y : y + int(rng.integers(20, h // 3)), x : x + int(rng.integers(20, w // 3))] = rng.integers(0, 220, 3)
        for y in range(int(rng.integers(10, 40)), h, int(rng.integers(14, 30))):
            page[y : y + 3, w // 12 : w - int(rng.integers(w // 12, w // 3))] = int(rng.integers(0, 100))
        pages.append(page)
    return pages


class Client:
    """A stdlib HTTP client (urllib) for the port's server."""

    def __init__(self, base: str):
        self.base = base

    def call(self, method: str, path: str, body=None, ctype: str = "application/json"):
        status, raw = self.request(method, path, body, ctype)
        if status != 200:
            raise AssertionError(f"{method} {path}: HTTP {status} {raw[:500]!r}")
        return json.loads(raw)

    def request(self, method: str, path: str, body=None, ctype: str = "application/json", token=None):
        """-> (status, raw body), whatever the status."""
        import urllib.error
        import urllib.request

        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        headers = {"Content-Type": ctype}
        if token is not None:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(self.base + path, data=body, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    @staticmethod
    def multipart(filename: str, data: bytes, ctype: str, fields=None):
        """-> (body, content type) of a multipart upload built by hand."""
        boundary = "chip-smoke-boundary-7f3a"
        body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                        for k, v in (fields or {}).items())
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
                 f"Content-Type: {ctype}\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
        return body, f"multipart/form-data; boundary={boundary}"

    def upload(self, filename: str, data: bytes, ctype: str = "image/png", fields=None, path: str = "/ingest/file"):
        """POST a multipart upload (by default to /ingest/file)."""
        return self.call("POST", path, *self.multipart(filename, data, ctype, fields))


class ServerThread:
    """The port's HTTP server on an event loop in a background thread."""

    def __init__(self, services):
        import asyncio
        import threading

        from morphik_core_tpu_torch.api.app import build_app
        from morphik_core_tpu_torch.api.http import HTTPServer

        self.services = services
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.run(services.initialize())
        self.server = HTTPServer(build_app(services), "127.0.0.1", 0)
        self.run(self.server.start())

    def run(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=600)

    def stop(self):
        try:
            self.run(self.server.stop())
        finally:
            self.run(self.services.shutdown())
            self.run(self.loop.shutdown_default_executor())  # the ingest worker threads
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            self.loop.close()


def _wait_completed(client, doc_ids):
    deadline = time.perf_counter() + SERVICE_POLL_S
    while True:
        states = {d: client.call("GET", f"/documents/{d}/status") for d in doc_ids}
        failed = {d: st["error"] for d, st in states.items() if st["status"] == "failed"}
        if failed:
            raise AssertionError(f"ingest failed: {failed}")
        if all(st["status"] == "completed" for st in states.values()):
            return time.perf_counter()
        if time.perf_counter() > deadline:
            raise AssertionError(f"ingest not completed after {SERVICE_POLL_S} s: {states}")
        time.sleep(0.02)


def service_settings(tmp: Path):
    """morphik_tpu.toml with every path in `tmp` and port 0."""
    from morphik_core_tpu_torch.config import load_settings

    settings = load_settings(ROOT / "morphik_tpu.toml")
    settings.api.port = 0
    settings.storage.storage_path = str(tmp / "storage")
    settings.storage.cache_path = str(tmp / "storage" / "cache")
    settings.database.path = str(tmp / "storage" / "morphik.db")
    settings.vector_store.index_path = str(tmp / "storage" / "index")
    settings.telemetry.telemetry_dir = str(tmp / "logs" / "telemetry")
    return settings


def service_path(torch, model, _kernels, smi):
    """Phase 8: the port's server on the card, driven over a socket."""
    import numpy as np

    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg
    from morphik_core_tpu_torch.utils.png import decode_png, encode_png

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_service_"))
    settings = service_settings(tmp)
    t0 = time.perf_counter()
    services = build_services(settings, colqwen_model=model)  # the card; recalibrates static scales
    server = ServerThread(services)
    boot_s = time.perf_counter() - t0
    scales = vision_scales(model)  # phase 21's mesh server serves these again
    client = Client(f"http://127.0.0.1:{server.server.port}")
    log(f"phase 8: service path, server up in {boot_s:.3f} s (morphik_tpu.toml: max_jobs "
        f"{settings.worker.max_jobs}, store batch {settings.worker.colpali_store_batch_size}, "
        f"static scales {settings.model.static_act_scales}); pages as PNG over HTTP")
    try:
        try:
            pages = service_pages()
            pngs = [encode_png(p) for p in pages]
            # the stored payload of a page (at most 1024 wide): its q80 JPEG, as the reference stores it
            payloads = [bytes_to_data_uri(encode_jpeg(p, 80)[0], "image/jpeg") for p in pages]
            _kernels.reset_launch_counts()  # the HTTP path starts here
            health = client.call("GET", "/health")["components"]["colpali"]
            if health["backend"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"/health backend {health['backend']!r}, expected the card")
            t_ingest = time.perf_counter()
            docs = [client.upload(f"page{i}.png", data)["external_id"] for i, data in enumerate(pngs)]
            t_done = _wait_completed(client, docs)
            ingest_s = t_done - t_ingest
            ingest_launches = dict(_kernels.launch_counts)
            phases = [client.call("GET", f"/documents/{d}")["system_metadata"]["phase_times"] for d in docs]
            lat, timings, http_results = [], [], {}
            for text in QUERIES:
                for rep in range(RETRIEVE_REPEATS + 1):  # the first is a warm-up, untimed
                    t = time.perf_counter()
                    res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
                    if rep:
                        lat.append((time.perf_counter() - t) * 1e3)
                        timings.append(dict(services.colpali_vector_store._indexes["default"].last_timing))
                if len(res) != 4 or not all(np.isfinite(r["score"]) for r in res):
                    raise AssertionError(f"/retrieve/chunks {text!r}: {res}")
                http_results[text] = res
            q_img = bytes_to_data_uri(pngs[3], "image/png")
            t = time.perf_counter()
            img_res = client.call("POST", "/retrieve/chunks", {"query_image": q_img, "k": 4})
            image_ms = (time.perf_counter() - t) * 1e3
            if img_res[0]["document_id"] != docs[3] or img_res[0]["content"] != payloads[3]:
                raise AssertionError(f"image self-query top-1 is {img_res[0]['document_id']}, expected {docs[3]} "
                                     "with its q80 JPEG payload")
            t = time.perf_counter()
            answer = client.call("POST", "/query", {"query": QUERIES[0], "k": 4})
            query_ms = (time.perf_counter() - t) * 1e3
            if not answer["completion"] or [x["document_id"] for x in answer["sources"]] != [
                    r["document_id"] for r in http_results[QUERIES[0]]]:
                raise AssertionError(f"/query: {answer['completion']!r}, sources {answer['sources']}")
            health = client.call("GET", "/health")["components"]["colpali"]
            launches = dict(_kernels.launch_counts)  # the HTTP path ends here
            if health["index_rows"] != {"default": len(pngs)}:
                raise AssertionError(f"/health index_rows {health['index_rows']}")
            if health["device_cache"]["default"]["hits"] <= 0:
                raise AssertionError(f"/health device cache shows no hits: {health['device_cache']}")
            if launches["window_attention"] <= 0 or launches["maxsim_q8"] <= 0:
                raise AssertionError(f"the HTTP path did not launch K3 and K1: {launches}")

            # the same answers from the in-process store, on the same embeddings
            emb, store = services.colpali_embedding_model, services.colpali_vector_store
            t = time.perf_counter()
            for _ in range(RETRIEVE_REPEATS):
                query_embs = {text: emb.embed_query(text) for text in QUERIES}
            encode_ms = (time.perf_counter() - t) * 1e3 / (RETRIEVE_REPEATS * len(QUERIES))
            query_embs["<page 3>"] = emb.embed_query(decode_png(pngs[3]))
            http_results["<page 3>"] = img_res
            for key, q in query_embs.items():
                lib = server.run(store.query_similar(q, k=4, doc_ids=docs))
                got = [(r["document_id"], r["chunk_number"]) for r in http_results[key]]
                if got != [(c.document_id, c.chunk_number) for c in lib]:
                    raise AssertionError(f"{key!r}: HTTP {got} vs in-process store {[c.document_id for c in lib]}")
                err = max(abs(r["score"] - c.score) for r, c in zip(http_results[key], lib))
                if err > SCORE_ATOL:
                    raise AssertionError(f"{key!r}: HTTP scores differ from the store's by {err}")
            answers = {text: [[r["filename"], r["score"]] for r in res] for text, res in http_results.items()
                       if text in QUERIES}  # phase 21 holds its mesh server to these
            text_metrics, expect = service_text_half(torch, services, server, client, _kernels, docs)
        finally:
            server.stop()  # the shutdown saves the indexes
        restart = service_restart(settings, model, _kernels, payloads, docs, expect)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    p50, p99 = (float(np.percentile(lat, p)) for p in (50, 99))
    mean_ms = float(np.mean(lat))
    index_ms = {k: float(np.mean([t[k] for t in timings])) for k in ("encode_ms", "ann_ms", "rerank_ms")}
    service = {
        "card": smi, "pages": len(pngs), "ingest_s": ingest_s, "ingest_pages_per_s": len(pngs) / ingest_s,
        "ingest_job_phase_s": {k: float(np.mean([p[k] for p in phases])) for k in phases[0]},
        "retrieve_n": len(lat), "retrieve_p50_ms": p50, "retrieve_p99_ms": p99, "retrieve_mean_ms": mean_ms,
        "image_query_ms": image_ms, "query_ms": query_ms, "text_encode_ms": encode_ms,
        "text_encode_share": encode_ms / mean_ms,
        "index_ms": index_ms, "index_share": sum(index_ms.values()) / mean_ms,
        "pooled_tier": any(t["pooled_tier"] for t in timings), "pool": timings[-1]["pool"],
        "cache": health["device_cache"]["default"], "boot_s": boot_s,
        "launches": launches, "ingest_launches": ingest_launches, "retrieve_answers": answers,
        **text_metrics, **restart,
    }
    log(f"  {len(pngs)} PNG pages ingested over HTTP in {ingest_s:.3f} s ({service['ingest_pages_per_s']:.3f} "
        f"pages/s; mean job phases s {json.dumps(service['ingest_job_phase_s'])}); retrieve p50 {p50:.3f} ms p99 {p99:.3f} ms over {len(lat)}; image query {image_ms:.3f} ms; "
        f"/query {query_ms:.3f} ms; text encode {encode_ms:.3f} ms a query; index {json.dumps(index_ms)}; "
        f"launches {launches}; HTTP results equal the in-process store's")
    log(f"  restart: second server up in {restart['restart_boot_s']:.3f} s on the saved indexes; retrieve p50 "
        f"{restart['restart_retrieve_p50_ms']:.3f} ms p99 {restart['restart_retrieve_p99_ms']:.3f} ms; the same ids "
        f"(max score diff {restart['restart_max_score_diff']:.3e}), the same text retrieves; launches "
        f"{restart['restart_launches']}")
    return service, scales


def vision_scales(model) -> list:
    """The int8 vision tower's static scales, block by block: each
    boot's calibration starts from the scales in place, so a later boot
    serves slightly other ones."""
    return [({name: getattr(blk, name).a_scale.clone() for name in ("q_w", "k_w", "v_w", "proj_w", "gate_w", "up_w",
                                                                      "down_w")}, blk.attn_qk_as)
            for blk in model.visual.blocks]


def restore_vision_scales(model, scales) -> None:
    for blk, (act, qk) in zip(model.visual.blocks, scales):
        for name, a in act.items():
            getattr(blk, name).set_act_scale(a)
        blk.set_qk_scales(qk)
    if model.mesh is not None:
        model.place_replicas()


def seeded_prose(rng, n_bytes: int) -> str:
    """Sentences of words from _PROSE, in paragraphs, about n_bytes long."""
    out, size = [], 0
    while size < n_bytes:
        sentence = " ".join(rng.choice(_PROSE, int(rng.integers(6, 18)))).capitalize() + "."
        out.append(sentence + ("\n\n" if rng.random() < 0.15 else " "))
        size += len(out[-1])
    return "".join(out).strip()


def text_pdf(pages) -> bytes:
    """A born-digital PDF (stdlib only): one FlateDecode content stream of
    text lines per page."""
    import zlib

    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages)))}]"
            f"/Count {len(pages)}>>endobj\n".encode()]
    for i, lines in enumerate(pages):
        ops = b"BT /F1 11 Tf 72 720 Td " + b"".join(
            (b"0 -14 Td " if j else b"") + b"(" + line.encode("latin-1") + b") Tj " for j, line in enumerate(lines))
        comp = zlib.compress(ops + b"ET")
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]/Contents {4 + 2 * i} 0 R>>"
                    "endobj\n".encode())
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def text_files(rng) -> dict:
    """One upload of each text type: filename -> (bytes, content type)."""
    para = [seeded_prose(rng, 300) for _ in range(6)]
    xml = "<report>" + "".join(f'<section id="s{i}"><title>Part {i}</title><p>{p}</p></section>'
                               for i, p in enumerate(para[:3])) + "</report>"
    return {
        "notes.md": (f"# Notes\n\n{para[0]}\n\n## Detail\n\n{para[1]}".encode(), "text/markdown"),
        "page.html": (f"<html><head><title>Board minutes</title></head><body><h1>Minutes</h1><p>{para[2]}</p>"
                      f"<ul><li>{para[3][:80]}</li></ul></body></html>".encode(), "text/html"),
        "report.xml": (xml.encode(), "application/xml"),
        "record.json": (json.dumps({"summary": para[4], "items": para[5].split(". ")}).encode(), "application/json"),
        "statement.pdf": (text_pdf([[w[:90] for w in para[4].split(". ")], [w[:90] for w in para[5].split(". ")]]),
                          "application/pdf"),
    }


def service_text_half(torch, services, server, client, _kernels, png_docs):
    """Phase 8, the text half, on the running server: /ingest/text (two
    documents also into the ColPali store), uploads of each text type with
    use_colpali=false, text retrieves (held against the in-process text
    store), reranked retrieves (held against an in-process ColQwenReranker
    over the same oversampled chunks; K2), a ColPali retrieve of a text
    document (K1), /batch/chunks, /query and a DELETE from both stores.
    Returns (metrics, what the restart must give back)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    texts = [seeded_prose(rng, kb * 1024) for kb in TEXT_DOC_KB]
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    tdocs, ingest_s = [], []
    for i, (text, colpali) in enumerate(zip(texts, TEXT_COLPALI)):
        t = time.perf_counter()
        doc = client.call("POST", "/ingest/text", {"content": text, "filename": f"text{i}.txt",
                                                   "metadata": {"t": i}, "use_colpali": colpali})
        ingest_s.append(time.perf_counter() - t)
        if doc["system_metadata"]["status"] != "completed":
            raise AssertionError(f"/ingest/text {i}: {doc['system_metadata']}")
        tdocs.append(doc["external_id"])
    ingest_launches = dict(_kernels.launch_counts)
    t = time.perf_counter()
    fdocs = {name: client.upload(name, data, ctype, {"use_colpali": "false", "metadata": json.dumps({"f": name})})[
        "external_id"] for name, (data, ctype) in text_files(rng).items()}
    files_s = _wait_completed(client, list(fdocs.values())) - t
    store, emb = services.vector_store, services.embedding_model
    all_docs = png_docs + tdocs + list(fdocs.values())
    for name, d in fdocs.items():
        got = client.call("GET", f"/documents/{d}")
        if not got["chunk_ids"] or got["system_metadata"].get("unsearchable"):
            raise AssertionError(f"{name}: no text chunks ({got['system_metadata']})")
    # text chunks of each document (its chunk_ids also list its ColPali rows)
    n_chunks = {d: len(client.call("GET", f"/documents/{d}")["chunk_ids"]) // (2 if c else 1)
                for d, c in zip(tdocs, TEXT_COLPALI)}

    def lib_answer(text, k):
        return server.run(store.query_similar(emb._embed(text), k=k, doc_ids=all_docs, query_text=text))

    lat, text_results = [], {}
    for text in TEXT_QUERIES:
        for rep in range(RETRIEVE_REPEATS + 1):  # the first is a warm-up, untimed
            t = time.perf_counter()
            res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "use_colpali": False})
            if rep:
                lat.append((time.perf_counter() - t) * 1e3)
        want = lib_answer(text, 4)
        if [(r["document_id"], r["chunk_number"], r["score"]) for r in res] != [
                (c.document_id, c.chunk_number, c.score) for c in want] or len(res) != 4:
            raise AssertionError(f"text retrieve {text!r}: HTTP {res} vs the in-process text store")
        text_results[text] = res

    _kernels.reset_launch_counts()
    rr_lat, reranked = [], {}
    for text in TEXT_QUERIES:
        t = time.perf_counter()
        reranked[text] = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "use_colpali": False,
                                                                  "use_reranking": True})
        rr_lat.append((time.perf_counter() - t) * 1e3)
    rerank_launches = dict(_kernels.launch_counts)
    if rerank_launches["maxsim"] != len(TEXT_QUERIES):
        raise AssertionError(f"the reranked retrieves did not launch K2 once each: {rerank_launches}")
    reranker = services.document_service.reranker
    for text in TEXT_QUERIES:
        pool = lib_answer(text, RERANK_C)
        want = server.run(reranker.rerank(text, pool))[:4]
        got = reranked[text]
        if [(r["document_id"], r["chunk_number"]) for r in got] != [(c.document_id, c.chunk_number) for c in want]:
            raise AssertionError(f"reranked {text!r}: HTTP {got} vs the in-process reranker")
        err = max(abs(r["score"] - c.score) for r, c in zip(got, want))
        if err > RERANK_SCORE_ATOL:
            raise AssertionError(f"reranked {text!r}: scores differ from the in-process reranker's by {err}")
    pool_tokens = [len(c.content.encode()) for c in lib_answer(TEXT_QUERIES[0], RERANK_C)]

    _kernels.reset_launch_counts()
    colpali_text = client.call("POST", "/retrieve/chunks", {"query": TEXT_QUERIES[0], "k": 2, "filters": {"t": 0}})
    colpali_launches = dict(_kernels.launch_counts)
    if [r["document_id"] for r in colpali_text] != [tdocs[0]] * 2 or any(r["metadata"]["is_image"] for r in colpali_text):
        raise AssertionError(f"ColPali retrieve of text document 0: {colpali_text}")
    if colpali_launches["maxsim_q8"] <= 0:
        raise AssertionError(f"the ColPali retrieve of text chunks did not launch K1: {colpali_launches}")

    sources = [{"document_id": d, "chunk_number": 0} for d in tdocs + list(fdocs.values())]
    chunks = client.call("POST", "/batch/chunks", {"sources": sources, "use_colpali": False})
    lib = server.run(store.get_chunks_by_id([(x["document_id"], 0) for x in sources]))
    if [(c["document_id"], c["content"]) for c in chunks] != [(c.document_id, c.content) for c in lib] or len(
            chunks) != len(sources):
        raise AssertionError("/batch/chunks (use_colpali=false) differs from the text store's chunks")
    t = time.perf_counter()
    answer = client.call("POST", "/query", {"query": TEXT_QUERIES[1], "k": 4, "use_colpali": False})
    query_ms = (time.perf_counter() - t) * 1e3
    if not answer["completion"] or [x["document_id"] for x in answer["sources"]] != [
            r["document_id"] for r in text_results[TEXT_QUERIES[1]]]:
        raise AssertionError(f"/query use_colpali=false: sources {answer['sources']}")

    gone = tdocs[1]  # ingested into both stores
    index = services.colpali_vector_store._indexes["default"]
    client.call("DELETE", f"/documents/{gone}")
    if server.run(store.get_chunks_by_id([(gone, n) for n in range(n_chunks[gone])])) or any(
            index.get_chunks_by_id([(gone, n) for n in range(n_chunks[gone])])):
        raise AssertionError("the deleted text document is still in a store")
    # what the restart must answer (the delete moved the BM25 statistics)
    final_text = {text: client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "use_colpali": False})
                  for text in TEXT_QUERIES}
    if any(r["document_id"] == gone for res in final_text.values() for r in res):
        raise AssertionError("a retrieve after the DELETE returned the deleted document")
    final_colpali = {text: client.call("POST", "/retrieve/chunks", {"query": text, "k": 4}) for text in QUERIES}
    health = client.call("GET", "/health")["components"]
    metrics = {
        "text_docs": len(tdocs), "text_doc_bytes": [len(x.encode()) for x in texts], "text_chunks": n_chunks,
        "text_ingest_s": ingest_s, "text_ingest_s_per_doc": float(np.mean(ingest_s)),
        "text_ingest_launches": ingest_launches, "file_uploads": len(fdocs), "file_ingest_s": files_s,
        "text_retrieve_n": len(lat), "text_retrieve_p50_ms": float(np.percentile(lat, 50)),
        "text_retrieve_p99_ms": float(np.percentile(lat, 99)), "reranked_retrieve_ms": rr_lat,
        "reranked_retrieve_p50_ms": float(np.percentile(rr_lat, 50)), "rerank_pool_tokens": pool_tokens,
        "rerank_launches": rerank_launches, "colpali_text_launches": colpali_launches, "text_query_ms": query_ms,
        "text_peak_gb": torch.cuda.max_memory_allocated() / 1e9, "text_index_rows": health["text_index_rows"],
    }
    expect = {"text": final_text, "colpali": final_colpali, "colpali_rows": health["colpali"]["index_rows"],
              "text_rows": health["text_index_rows"], "wal_lines": index.count_rows + 1, "gone": gone}
    log(f"  text half: {len(tdocs)} /ingest/text documents ({metrics['text_doc_bytes']} bytes, chunks "
        f"{list(n_chunks.values())}) in {[round(x, 3) for x in ingest_s]} s (launches {ingest_launches}); "
        f"{len(fdocs)} uploads (md, html, xml, json, 2-page pdf) completed in {files_s:.3f} s; text retrieve p50 "
        f"{metrics['text_retrieve_p50_ms']:.3f} ms p99 {metrics['text_retrieve_p99_ms']:.3f} ms over {len(lat)}; "
        f"reranked retrieves ms {[round(x, 1) for x in rr_lat]} (K2 launches {rerank_launches['maxsim']}); "
        f"ColPali retrieve of a text document: K1 {colpali_launches['maxsim_q8']}; /query {query_ms:.3f} ms; "
        f"peak mem GB {metrics['text_peak_gb']:.2f}; /health text rows {health['text_index_rows']}; "
        f"HTTP results equal the in-process text store and reranker")
    return metrics, expect


def service_restart(settings, model, _kernels, payloads, docs, expect):
    """Phase 8, second half: a new server from `build_services` on the
    directories the first one left (its index files included) answers as
    the first did."""
    import numpy as np

    from morphik_core_tpu_torch.services_init import build_services

    wal = (Path(settings.vector_store.index_path) / "default" / "records.jsonl").read_text().splitlines()
    if len(wal) != expect["wal_lines"] or "_patches" in "".join(wal):
        raise AssertionError(f"the saved WAL has {len(wal)} lines (expected {expect['wal_lines']}) or carries _patches")
    t0 = time.perf_counter()
    server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
    boot_s = time.perf_counter() - t0
    client = Client(f"http://127.0.0.1:{server.server.port}")
    try:
        _kernels.reset_launch_counts()  # the restarted path starts here
        lat, diff = [], 0.0
        for text in QUERIES:
            for rep in range(RETRIEVE_REPEATS + 1):  # the first is a warm-up, untimed
                t = time.perf_counter()
                res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
                if rep:
                    lat.append((time.perf_counter() - t) * 1e3)
                want = expect["colpali"][text]
                if [r["document_id"] for r in res] != [r["document_id"] for r in want]:
                    raise AssertionError(f"after the restart {text!r}: {[r['document_id'] for r in res]} vs "
                                         f"{[r['document_id'] for r in want]}")
                diff = max(diff, max(abs(r["score"] - w["score"]) for r, w in zip(res, want)))
        if diff > SCORE_ATOL:
            raise AssertionError(f"after the restart the scores moved by {diff}")
        for text, want in expect["text"].items():
            res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "use_colpali": False})
            if res != want:
                raise AssertionError(f"after the restart the text retrieve {text!r} moved: {res} vs {want}")
        health = client.call("GET", "/health")["components"]
        if health["colpali"]["index_rows"] != expect["colpali_rows"] or health["text_index_rows"] != expect["text_rows"]:
            raise AssertionError(f"after the restart /health rows {health['colpali']['index_rows']} "
                                 f"{health['text_index_rows']}")
        launches = dict(_kernels.launch_counts)  # the restarted path ends here
        if launches["maxsim_q8"] <= 0:
            raise AssertionError(f"after the restart the retrieves did not launch K1: {launches}")
        for d in docs:
            status = client.call("GET", f"/documents/{d}")["system_metadata"]["status"]
            if status != "completed":
                raise AssertionError(f"after the restart document {d} is {status}")
        chunks = client.call("POST", "/batch/chunks", {
            "sources": [{"document_id": d, "chunk_number": 0} for d in docs], "use_colpali": True})
        if [c["document_id"] for c in chunks] != docs or [c["content"] for c in chunks] != payloads:
            raise AssertionError("after the restart /batch/chunks does not return every document's page")
    finally:
        server.stop()
    return {"restart_boot_s": boot_s, "restart_retrieve_n": len(lat),
            "restart_retrieve_p50_ms": float(np.percentile(lat, 50)),
            "restart_retrieve_p99_ms": float(np.percentile(lat, 99)),
            "restart_max_score_diff": diff, "restart_launches": launches}


def document_files(rng):
    """Phase 11's uploads: name -> (bytes, content type, metadata)."""
    import io
    import zipfile

    import numpy as np

    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg

    pdf_pages = []
    for i in range(DOC_PDF_PAGES):
        prose = seeded_prose(rng, 1800).replace("\n\n", " ")
        pdf_pages.append(["."] if i == DOC_BLANK_PAGE else [f"Page {i + 1}: AV office affluent"] + [
            line[:95] for line in prose.split(". ")])
    slides = [[f"Slide {i + 1}: quarterly revenue"] + seeded_prose(rng, 300).split(". ")[:4] for i in range(DOC_SLIDES)]
    pptx = io.BytesIO()
    with zipfile.ZipFile(pptx, "w") as z:
        for i, lines in enumerate(slides, start=1):
            runs = "".join(f"<a:p><a:r><a:t>{t}</a:t></a:r></a:p>" for t in lines)
            z.writestr(f"ppt/slides/slide{i}.xml", '<p:sld xmlns:a="http://schemas.openxmlformats.org/drawingml/'
                       f'2006/main" xmlns:p="p"><a:txBody>{runs}</a:txBody></p:sld>')
    paras, size = [], 0
    while size < DOC_DOCX_CHARS:
        paras.append(seeded_prose(rng, 600).replace("\n\n", " "))
        size += len(paras[-1]) + 2
    docx = io.BytesIO()
    with zipfile.ZipFile(docx, "w") as z:
        body = "".join(f"<w:p><w:r><w:t>{p}</w:t></w:r></w:p>" for p in paras)
        z.writestr("word/document.xml", '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/'
                   f'2006/main"><w:body>{body}</w:body></w:document>')
    files = {
        "report.pdf": (text_pdf(pdf_pages), "application/pdf", {"kind": "pdf"}),
        "deck.pptx": (pptx.getvalue(), "application/octet-stream", {"kind": "pptx"}),
        "memo.docx": (docx.getvalue(), "application/octet-stream", {"kind": "docx"}),
    }
    page_rng = np.random.default_rng(SEED + 11)
    for i, (h, w) in enumerate(DOC_JPEG_SIZES):
        page = np.full((h, w, 3), 255, np.uint8)
        for _ in range(10):
            y, x = int(page_rng.integers(0, h - 60)), int(page_rng.integers(0, w - 60))
            page[y : y + int(page_rng.integers(30, h // 3)), x : x + int(page_rng.integers(30, w // 3))] = (
                page_rng.integers(0, 220, 3))
        files[f"photo{i}.jpg"] = (encode_jpeg(page, 90)[0], "image/jpeg", {"kind": "jpeg"})
    return files


def _forwards(n_pages: int, batch: int, embed_batch: int) -> int:
    """Tower forwards of one document's pages (one grid bucket): store
    batches of `batch`, each in forwards of at most `embed_batch`."""
    return sum(-(-min(batch, n_pages - s) // embed_batch) for s in range(0, n_pages, batch))


def raster_stage_ms(texts, settings) -> dict:
    """Phase 11: one process's time per stage of a PDF page (the raster
    pool's `_finish_page` in prep mode), median over `texts`."""
    import numpy as np

    from morphik_core_tpu_torch.models.colqwen.preprocess import is_blank_page, preprocess_array_u8
    from morphik_core_tpu_torch.parser import raster_pool
    from morphik_core_tpu_torch.parser.text_render import render_text_page
    from morphik_core_tpu_torch.utils.jpeg import decode_own, encode_jpeg

    stages = {k: [] for k in ("render", "resize", "encode", "decode_own", "blank", "patches")}
    dpi = settings.pdf.colpali_pdf_dpi
    for text in texts:
        t = [time.perf_counter()]
        page = render_text_page(text, dpi)
        t.append(time.perf_counter())
        small = raster_pool._resize(page, raster_pool._MAX_WIDTH)
        t.append(time.perf_counter())
        _, coeffs = encode_jpeg(small, raster_pool._JPEG_QUALITY)
        t.append(time.perf_counter())
        stored = decode_own(coeffs)
        t.append(time.perf_counter())
        is_blank_page(stored)
        t.append(time.perf_counter())
        _, grid = preprocess_array_u8(stored, settings.model.min_pixels, settings.model.max_pixels)
        t.append(time.perf_counter())
        if tuple(grid) != DOC_GRID:
            raise AssertionError(f"a {dpi} dpi page lands on grid {grid}, expected {DOC_GRID}")
        for k, a, b in zip(stages, t, t[1:]):
            stages[k].append((b - a) * 1e3)
    out = {k: float(np.median(v)) for k, v in stages.items()}
    out["total"] = sum(out.values())
    return out


def check_jpeg_decoders():
    """Phase 11, on this machine: the upload decoder on every committed
    fixture (Pillow's decoded pixels, as hashes); the q70 payload of the
    fixtures' 150 dpi text page (render, LANCZOS, encode) against the
    reference's hash; `decode_own` against the decoder on the encoder's
    own bytes."""
    import hashlib

    import numpy as np

    from morphik_core_tpu_torch.parser import raster_pool
    from morphik_core_tpu_torch.parser.text_render import render_text_page
    from morphik_core_tpu_torch.utils.jpeg import decode_jpeg, decode_own, encode_jpeg

    z = np.load(JPEG_FIXTURES)
    payload = raster_pool._finish_page(0, render_text_page(str(z["page_text"]), 150), raster_pool._MAX_WIDTH, None)[1]
    if hashlib.sha256(payload).hexdigest() != str(z["page_q70_sha256"]):
        raise AssertionError("the q70 payload of the fixture's text page differs from the reference's")
    names = sorted(k[: -len("_jpeg")] for k in z.files if k.endswith("_jpeg"))
    for name in names:
        got = hashlib.sha256(decode_jpeg(z[f"{name}_jpeg"].tobytes()).tobytes()).hexdigest()
        if got != str(z[f"{name}_sha256"]):
            raise AssertionError(f"JPEG fixture {name}: decoded pixels differ from Pillow's (sha256 {got})")
    rng = np.random.default_rng(SEED + 12)
    for h, w, gray in ((37, 53, False), (64, 71, True), (130, 98, False)):
        px = rng.integers(0, 256, (h, w) if gray else (h, w, 3), dtype=np.uint8)
        data, coeffs = encode_jpeg(px, 80)
        if not np.array_equal(decode_own(coeffs), decode_jpeg(data)):
            raise AssertionError(f"decode_own differs from the decoder on the encoder's {h}x{w} JPEG")
    return names


def documents_phase(torch, model, _kernels, smi):
    """Phase 11: documents as pages over HTTP on a new server (the
    shipped toml, phase 3b's model)."""
    import os
    import resource

    import numpy as np

    from morphik_core_tpu_torch.parser.pdf import extract_pages_text
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.image import decode_image
    from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes

    fixtures = check_jpeg_decoders()
    files = document_files(np.random.default_rng(SEED + 10))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_documents_"))
    settings = service_settings(tmp)
    w = settings.worker
    stage_ms = raster_stage_ms(extract_pages_text(files["report.pdf"][0])[:3], settings)
    t0 = time.perf_counter()
    server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
    boot_s = time.perf_counter() - t0
    services = server.services
    client = Client(f"http://127.0.0.1:{server.server.port}")
    emb, store = services.colpali_embedding_model, services.colpali_vector_store
    forward_batches = []
    tower = model.embed_image_batch

    def counted_forward(patches, *args, **kw):
        forward_batches.append(int(patches.shape[0]))
        return tower(patches, *args, **kw)

    model.embed_image_batch = counted_forward
    log(f"phase 11: documents as pages over HTTP, server up in {boot_s:.3f} s ({os.cpu_count()} host cores, raster "
        f"processes {services.ingestion_service.raster_pool.processes}, store batch {w.colpali_store_batch_size}, "
        f"prefetch {w.ingest_embed_prefetch}); JPEG fixtures decoded as Pillow decodes them: {fixtures}; "
        "a text page's q70 payload hashes as the reference's")
    try:
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()  # the documents path starts here
        docs, ingest_s = {}, {}
        for name, (data, ctype, meta) in files.items():
            t = time.perf_counter()
            docs[name] = client.upload(name, data, ctype, {"metadata": json.dumps(meta)})["external_id"]
            ingest_s[name] = _wait_completed(client, [docs[name]]) - t
        ingest_launches = dict(_kernels.launch_counts)
        ingest_batches = list(forward_batches)
        got = {name: client.call("GET", f"/documents/{d}") for name, d in docs.items()}
        want_pages = {"report.pdf": DOC_PDF_PAGES - 1, "deck.pptx": DOC_SLIDES, "memo.docx": 4,
                      "photo0.jpg": 1, "photo1.jpg": 1}
        for name, n in want_pages.items():
            if got[name]["system_metadata"]["page_count"] != n:
                raise AssertionError(f"{name}: page_count {got[name]['system_metadata']['page_count']}, expected {n}")
        pdf = docs["report.pdf"]
        pdf_chunks = client.call("POST", "/batch/chunks", {
            "sources": [{"document_id": pdf, "chunk_number": n} for n in range(DOC_PDF_PAGES)], "use_colpali": True})
        pages_stored = [c["metadata"]["page"] for c in pdf_chunks]
        if pages_stored != [i for i in range(DOC_PDF_PAGES) if i != DOC_BLANK_PAGE]:
            raise AssertionError(f"the PDF's stored pages are {pages_stored}: page {DOC_BLANK_PAGE} is the blank one")
        if not all(c["content"].startswith("data:image/jpeg;base64,") for c in pdf_chunks):
            raise AssertionError("a PDF page payload is not a JPEG data URI")
        expected_forwards = sum(_forwards(n, w.colpali_store_batch_size, emb.batch_size) for n in want_pages.values())
        k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        if len(ingest_batches) != expected_forwards or ingest_launches["window_attention"] != k3_per_forward * len(
                ingest_batches):
            raise AssertionError(f"{len(ingest_batches)} tower forwards (expected {expected_forwards}), K3 launched "
                                 f"{ingest_launches['window_attention']} times, expected {k3_per_forward} a forward")

        # text queries that hit the PDF's pages, each through K1
        lat, k1, http_results = [], [], {}
        for text in QUERIES:
            for rep in range(RETRIEVE_REPEATS + 1):  # the first is a warm-up, untimed
                _kernels.reset_launch_counts()
                t = time.perf_counter()
                res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "filters": {"kind": "pdf"}})
                if rep:
                    lat.append((time.perf_counter() - t) * 1e3)
                k1.append(_kernels.launch_counts["maxsim_q8"])
            if len(res) != 4 or {r["document_id"] for r in res} != {pdf}:
                raise AssertionError(f"/retrieve/chunks {text!r} over the PDF: {res}")
            http_results[text] = res
        # a JPEG image query: a stored PDF page's own q70 payload comes back first
        self_page = pdf_chunks[5]
        _kernels.reset_launch_counts()
        t = time.perf_counter()
        img_res = client.call("POST", "/retrieve/chunks", {"query_image": self_page["content"], "k": 4})
        image_ms = (time.perf_counter() - t) * 1e3
        k1.append(_kernels.launch_counts["maxsim_q8"])
        if (img_res[0]["document_id"], img_res[0]["chunk_number"]) != (pdf, self_page["chunk_number"]):
            raise AssertionError(f"image self-query top-1 {img_res[0]['document_id']}#{img_res[0]['chunk_number']}")
        if min(k1) <= 0:
            raise AssertionError(f"a retrieve did not launch K1: {k1}")
        launches = {"ingest": ingest_launches, "retrieve_k1": k1}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the same answers from the in-process store, on the same embeddings
        queries = {text: emb.embed_query(text) for text in QUERIES}
        queries["<pdf page>"] = emb.embed_query(decode_image(data_uri_to_bytes(self_page["content"])))
        http_results["<pdf page>"] = img_res
        for key, q in queries.items():
            lib = server.run(store.query_similar(q, k=4, doc_ids=[pdf] if key in QUERIES else list(docs.values())))
            res = http_results[key]
            if [(r["document_id"], r["chunk_number"]) for r in res] != [(c.document_id, c.chunk_number) for c in lib]:
                raise AssertionError(f"{key!r}: HTTP results differ from the in-process store's")
            err = max(abs(r["score"] - c.score) for r, c in zip(res, lib))
            if err > SCORE_ATOL:
                raise AssertionError(f"{key!r}: HTTP scores differ from the store's by {err}")
        phases = got["report.pdf"]["system_metadata"]["phase_times"]
        corpus = corpus_phase(torch, server, client, _kernels, smi, files["report.pdf"][0], forward_batches,
                              k3_per_forward)
    finally:
        model.embed_image_batch = tower
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    documents = {
        "card": smi, "host_cores": os.cpu_count(), "raster_processes": services.ingestion_service.raster_pool.processes,
        "raster_stage_ms": stage_ms, "pdf_pages": DOC_PDF_PAGES, "pdf_pages_stored": len(pdf_chunks),
        "pdf_ingest_s": ingest_s["report.pdf"], "pdf_pages_per_s": DOC_PDF_PAGES / ingest_s["report.pdf"],
        "pdf_job_phase_s": phases, "ingest_s": ingest_s, "embed_batches": ingest_batches,
        "retrieve_n": len(lat), "retrieve_p50_ms": float(np.percentile(lat, 50)),
        "retrieve_p99_ms": float(np.percentile(lat, 99)), "image_query_ms": image_ms, "peak_gb": peak_gb,
        "host_maxrss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "boot_s": boot_s, "launches": launches, "jpeg_fixtures": fixtures, "corpus": corpus,
    }
    log(f"  PDF of {DOC_PDF_PAGES} pages ({len(pdf_chunks)} stored, page {DOC_BLANK_PAGE} blank) in "
        f"{ingest_s['report.pdf']:.3f} s ({documents['pdf_pages_per_s']:.3f} pages/s; job phases s "
        f"{json.dumps(phases)}); one process's page raster ms {json.dumps(stage_ms)}; other uploads s "
        f"{json.dumps({k: v for k, v in ingest_s.items() if k != 'report.pdf'})}; tower forwards {ingest_batches} "
        f"(K3 {ingest_launches['window_attention']}); retrieve p50 {documents['retrieve_p50_ms']:.3f} ms p99 "
        f"{documents['retrieve_p99_ms']:.3f} ms over {len(lat)}; JPEG image query {image_ms:.3f} ms; peak mem GB "
        f"{peak_gb:.2f}; HTTP results equal the in-process store's")
    return documents


CORPUS_REPEATS = 10  # folder-scoped and unscoped retrieves of each text query
PROFILE_S = 2.0  # the device profile's window


def _percentiles(lat) -> dict:
    import numpy as np

    return {"n": len(lat), "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def corpus_phase(torch, server, client, _kernels, smi, pdf: bytes, forward_batches, k3_per_forward):
    """Phase 12: the corpus routes on phase 11's server (before it stops):
    folders and folder-scoped retrieves, a folder rename, /retrieve/docs,
    update_file, /embeddings, app-token rotation, v2 and the device
    profile. The counts are reset here and read at the end."""
    import threading

    import numpy as np

    from morphik_core_tpu_torch.models.schemas import Chunk
    from morphik_core_tpu_torch.parser.pdf import extract_pages_text
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg
    from morphik_core_tpu_torch.utils.png import encode_png

    services = server.services
    emb, store = services.colpali_embedding_model, services.colpali_vector_store
    t_phase = time.perf_counter()
    _kernels.reset_launch_counts()  # the corpus path starts here
    reports = client.call("POST", "/folders", {"name": "Reports"})
    year = client.call("POST", "/folders", {"name": "2026", "parent_path": "/Reports"})
    if year["path"] != "/Reports/2026" or year["parent_id"] != reports["id"]:
        raise AssertionError(f"folder /Reports/2026: {year}")
    pages = service_pages()[:2]
    pngs = [encode_png(p) for p in pages]
    fdocs = [client.upload(f"folder{i}.png", data, fields={"folder_name": "Reports/2026"})["external_id"]
             for i, data in enumerate(pngs)]
    _wait_completed(client, fdocs)
    for d in fdocs:
        if client.call("GET", f"/documents/{d}")["folder_path"] != "/Reports/2026":
            raise AssertionError(f"{d} is not in /Reports/2026")

    def retrieve(body):
        before = _kernels.launch_counts["maxsim_q8"]
        t = time.perf_counter()
        res = client.call("POST", "/retrieve/chunks", body)
        return res, (time.perf_counter() - t) * 1e3, _kernels.launch_counts["maxsim_q8"] - before

    lat = {"scoped": [], "unscoped": []}
    k1, scoped = [], {}
    for text in QUERIES:
        for rep in range(CORPUS_REPEATS):
            for kind, extra in (("scoped", {"folder_name": "/Reports", "folder_depth": -1}), ("unscoped", {})):
                res, ms, n_k1 = retrieve({"query": text, "k": 4, **extra})
                lat[kind].append(ms)
                k1.append(n_k1)
                if kind == "scoped":
                    if not res or not {r["document_id"] for r in res} <= set(fdocs):
                        raise AssertionError(f"a scoped retrieve left the folder: {res}")
                    scoped[text] = [(r["document_id"], r["chunk_number"], r["score"]) for r in res]
    for d, png in zip(fdocs, pngs):  # each folder page's self-query, scoped
        res, _, n_k1 = retrieve({"query_image": bytes_to_data_uri(png, "image/png"), "k": 2,
                                 "folder_name": "/Reports", "folder_depth": -1})
        k1.append(n_k1)
        if res[0]["document_id"] != d:
            raise AssertionError(f"the self-query of {d} is not top-1 in its folder: {res}")
    if min(k1) <= 0:
        raise AssertionError(f"a retrieve did not launch K1: {k1}")

    # /retrieve/docs groups the same chunks: each document's best chunk
    for text in QUERIES:
        docs = client.call("POST", "/retrieve/docs", {"query": text, "k": 4, "folder_name": "/Reports",
                                                      "folder_depth": -1})
        best = {}
        for d, _, score in scoped[text]:
            best[d] = max(best.get(d, -1e30), score)
        got = {x["document_id"]: x["score"] for x in docs}
        if set(got) != set(best) or max(abs(got[d] - best[d]) for d in got) > SCORE_ATOL:
            raise AssertionError(f"/retrieve/docs {text!r}: {got} vs the chunks' grouping {best}")

    # rename /Reports to /Archive: the same answers under the new path
    if client.call("POST", f"/folders/{reports['id']}/rename", {"new_name": "Archive"})["path"] != "/Archive":
        raise AssertionError("the rename did not take")
    for text in QUERIES:
        res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4, "folder_name": "/Archive",
                                                       "folder_depth": -1})
        got = [(r["document_id"], r["chunk_number"], r["score"]) for r in res]
        if [g[:2] for g in got] != [w[:2] for w in scoped[text]] or max(
                abs(g[2] - w[2]) for g, w in zip(got, scoped[text])) > SCORE_ATOL:
            raise AssertionError(f"{text!r} under /Archive: {got} vs {scoped[text]}")
    if client.call("GET", f"/documents/{fdocs[0]}")["folder_path"] != "/Archive/2026":
        raise AssertionError("the rename did not reach the documents")

    # update_file: a new page replaces folder page 0 (the tower runs again)
    index = store._indexes["default"]

    def rows_of(doc):
        rows = [r for r in range(index.count_rows) if index.records[r].document_id == doc]
        return sum(bool(index._alive[r]) for r in rows), len(rows)

    new_page = np.ascontiguousarray(service_pages()[5][::-1])
    new_png = encode_png(new_page)
    k3_before, n_fwd = _kernels.launch_counts["window_attention"], len(forward_batches)
    alive_before, _ = rows_of(fdocs[0])
    t = time.perf_counter()
    updated = client.upload("replaced.png", new_png, path=f"/documents/{fdocs[0]}/update_file")
    update_s = time.perf_counter() - t
    k3_update = _kernels.launch_counts["window_attention"] - k3_before
    update_forwards = len(forward_batches) - n_fwd
    if updated["system_metadata"]["status"] != "completed" or updated["filename"] != "replaced.png":
        raise AssertionError(f"update_file: {updated['system_metadata']}")
    if update_forwards < 1 or k3_update != k3_per_forward * update_forwards:
        raise AssertionError(f"update_file: K3 {k3_update} over {update_forwards} forwards")
    alive, total = rows_of(fdocs[0])
    if alive_before != 1 or alive != 1 or total < 2:
        raise AssertionError(f"update_file: the document has {alive} live of {total} rows (before: {alive_before})")
    res, _, _ = retrieve({"query_image": bytes_to_data_uri(new_png, "image/png"), "k": 2})
    if (res[0]["document_id"], res[0]["chunk_number"]) != (fdocs[0], 0):
        raise AssertionError(f"the new page's self-query: {res}")
    status, raw = client.request("GET", f"/documents/{fdocs[0]}/file")
    if status != 200 or raw != new_png:
        raise AssertionError("/documents/{id}/file does not return the new bytes")
    pages_out = client.call("POST", "/documents/pages", {"document_id": fdocs[0], "end_page": 0})["pages"]
    if [p["image"] for p in pages_out] != [bytes_to_data_uri(encode_jpeg(new_page, 80)[0], "image/jpeg")]:
        raise AssertionError("/documents/pages does not return the new page's q80 payload")

    # /embeddings: two page images and two texts, equal to the in-process embed
    images = [bytes_to_data_uri(p, "image/png") for p in pngs]
    texts = QUERIES[:2]
    embed_ms, k3_embed, embed_forwards = {}, 0, 0
    for kind, inputs in (("image", images), ("text", texts)):
        k3_before, n_fwd = _kernels.launch_counts["window_attention"], len(forward_batches)
        t = time.perf_counter()
        status, raw = client.request("POST", "/embeddings", {"input_type": kind, "inputs": inputs})
        embed_ms[kind] = (time.perf_counter() - t) * 1e3
        k3_embed += _kernels.launch_counts["window_attention"] - k3_before
        embed_forwards += len(forward_batches) - n_fwd
        import io

        npz = np.load(io.BytesIO(raw))
        want = emb.embed_for_ingestion_sync([Chunk(content=v, metadata={"is_image": kind == "image"})
                                             for v in inputs])[0]
        if status != 200 or npz.files != [f"emb_{i}" for i in range(len(inputs))] or not all(
                np.array_equal(npz[f"emb_{i}"], w) for i, w in enumerate(want)):
            raise AssertionError(f"/embeddings {kind}: not bit-identical to embed_for_ingestion")
    if embed_forwards < 1 or k3_embed != k3_per_forward * embed_forwards:
        raise AssertionError(f"/embeddings: K3 {k3_embed} over {embed_forwards} image forwards")

    # apps: a minted token answers until its app's token is rotated
    app = client.call("POST", "/cloud/generate_uri", {"name": "smoke-app"})
    token_a = app["uri"].split(":", 2)[2].rsplit("@", 1)[0]
    body = {"query": QUERIES[0], "k": 1}
    if client.request("POST", "/retrieve/chunks", body, token=token_a)[0] != 200:
        raise AssertionError("the app token is refused before its rotation")
    rotated = client.call("POST", "/apps/rotate_token", {"app_id": app["app_id"]})
    token_b = rotated["uri"].split(":", 2)[2].rsplit("@", 1)[0]
    statuses = (client.request("POST", "/retrieve/chunks", body, token=token_a)[0],
                client.request("POST", "/retrieve/chunks", body, token=token_b)[0])
    if statuses != (401, 200):
        raise AssertionError(f"after the rotation the old and new tokens answer {statuses}, expected (401, 200)")

    # v2: phase 11's PDF, a sentence of page n finds page n
    t = time.perf_counter()
    v2doc = client.upload("report.pdf", pdf, "application/pdf", path="/v2/documents")
    v2_ingest_s = time.perf_counter() - t
    page_texts = extract_pages_text(pdf)
    n = 7
    sentence = max(page_texts[n].split("\n"), key=len)
    hits = client.call("POST", "/v2/retrieve/chunks", {"query": sentence, "k": 3})
    if v2doc["system_metadata"]["status"] != "completed" or hits[0]["metadata"]["page"] != n:
        raise AssertionError(f"v2: a sentence of page {n} found page {hits[0]['metadata']['page']}")

    # the device profile while another thread retrieves; the route logs its
    # profiler's start / stop / export seconds
    halt, n_bg = threading.Event(), [0]
    route_log = logging.getLogger("morphik_core_tpu_torch.api.app")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    level = route_log.level
    route_log.setLevel(logging.INFO)
    route_log.addHandler(handler)

    def background():
        while not halt.is_set():
            client.call("POST", "/retrieve/chunks", {"query": QUERIES[1], "k": 4})
            n_bg[0] += 1

    thread = threading.Thread(target=background)
    thread.start()
    captures = []
    try:
        # two captures: the first start in a process initialises CUPTI
        for _ in range(2):
            t, bg = time.perf_counter(), n_bg[0]
            prof = client.call("POST", "/logs/profile/device", {"seconds": PROFILE_S})
            captures.append({"route_s": time.perf_counter() - t, "retrieves_beside": n_bg[0] - bg,
                             "trace": Path(prof["trace_dir"]) / "trace.json"})
    finally:
        halt.set()
        thread.join(timeout=120)
        route_log.removeHandler(handler)
        route_log.setLevel(level)
    steps = [r.args[1:] for r in records if r.msg.startswith("device profile")]
    if len(steps) != len(captures):
        raise AssertionError(f"the profile route logged {len(steps)} of {len(captures)} captures")
    for cap, step in zip(captures, steps):
        trace_path = cap.pop("trace")
        trace = trace_path.read_text()
        cap.update(zip(("start_s", "stop_s", "export_s"), step))
        cap["trace_bytes"] = trace_path.stat().st_size
        cap["names"] = {k: k in trace for k in ("maxsim_mma_kernel", "window_attention_mma_kernel")}
        if not cap["names"]["maxsim_mma_kernel"] or cap["retrieves_beside"] <= 0:
            raise AssertionError(f"the device trace does not name the MaxSim kernel: {cap}")
    launches = dict(_kernels.launch_counts)  # the corpus path ends here
    out = {
        "card": smi, "scoped_retrieve": _percentiles(lat["scoped"]), "unscoped_retrieve": _percentiles(lat["unscoped"]),
        "retrieve_k1": k1, "update_file_s": update_s, "update_forwards": update_forwards, "update_k3": k3_update,
        "embeddings_ms": embed_ms, "embeddings_image_forwards": embed_forwards, "embeddings_k3": k3_embed,
        "v2_ingest_s": v2_ingest_s, "v2_pages": v2doc["system_metadata"]["page_count"],
        "profiles": captures, "launches": launches, "phase_s": time.perf_counter() - t_phase,
    }
    log(f"phase 12: corpus routes on phase 11's server ({smi}): scoped retrieve p50 "
        f"{out['scoped_retrieve']['p50_ms']:.3f} ms p99 {out['scoped_retrieve']['p99_ms']:.3f} ms, unscoped p50 "
        f"{out['unscoped_retrieve']['p50_ms']:.3f} ms p99 {out['unscoped_retrieve']['p99_ms']:.3f} ms over "
        f"{len(lat['scoped'])} each (K1 {sum(k1)}); the rename keeps the answers; update_file {update_s:.3f} s to "
        f"completed ({update_forwards} forward, K3 {k3_update}); /embeddings ms {json.dumps(embed_ms)} (K3 "
        f"{k3_embed}); app token rotation 401 / 200; v2 ingest of {out['v2_pages']} pages {v2_ingest_s:.3f} s; "
        f"device profiles (route s, the profiler's start / stop / export s, retrieves beside it, trace bytes, kernels "
        f"named) {json.dumps(captures)}; launches {launches}; phase {out['phase_s']:.3f} s")
    return out


def persistence_phase(torch, index, path: Path, answers5, answers6, smi):
    """Phase 9: the phase-4 index (2048 rows at full page width, its path
    `path`) saved, reopened, grown to the shipped compaction trigger,
    compacted inside delete_document and reopened. `answers5` / `answers6`
    are phase 5's and phase 6's (query, [(document_id, score)]) pairs."""
    import numpy as np

    from morphik_core_tpu_torch.index import multivector_index as mvi
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    def open_index(**over):
        return MultiVectorIndex(FDEConfig(), device="cuda", path=path, device_block_rows=BLOCK_ROWS,
                                **dict(SHIPPED, **over))

    def dir_bytes():
        return sum(f.stat().st_size for f in path.iterdir() if f.is_file())

    def timed_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    n_rows = index.count_rows
    _, save_ms = timed_ms(index.save)
    saved = dir_bytes()
    files = {f.name: f.stat().st_size for f in sorted(path.iterdir())}
    log(f"phase 9: persistence at full page width: saved {n_rows} rows, {saved} bytes in {save_ms / 1e3:.3f} s "
        f"({saved / save_ms / 1e3:.1f} MB/s); files {json.dumps(files)}")
    pool_calls = [0]
    real_pool = mvi.pool_multivector

    def counted_pool(*a, **kw):
        pool_calls[0] += 1
        return real_pool(*a, **kw)

    mvi.pool_multivector = counted_pool
    try:
        reopened, open_ms = timed_ms(open_index)
        queries5 = [q for q, _ in answers5]
        first, cold_ms = timed_ms(lambda: reopened.query(queries5[0], k=10))
        _, warm_ms = timed_ms(lambda: reopened.query(queries5[0], k=10))
        if pool_calls[0]:
            raise AssertionError(f"the reopened index ran pool_multivector {pool_calls[0]} times")
        if answer(reopened, queries5) != [a for _, a in answers5]:
            raise AssertionError("the reopened index does not answer phase 5's queries with the same ids and scores")
        log(f"  reopened with cold device state in {open_ms:.3f} ms; first query {cold_ms:.3f} ms (FDE blocks "
            f"and pooled tier from the files, pool_multivector calls 0), again {warm_ms:.3f} ms; phase 5's "
            f"{len(queries5)} queries: same ids and score bits")
        bf16 = open_index(rerank_dtype="bf16")
        got6 = answer(bf16, [q for q, _ in answers6])
        if [[d for d, _ in a] for a in got6] != [[d for d, _ in a] for _, a in answers6]:
            raise AssertionError("the bf16 index opened on the files does not give phase 6's ids")
        diff6 = max(abs(s - w) for a, (_, b) in zip(got6, answers6) for (_, s), (_, w) in zip(a, b))
        del bf16
        log(f"  rerank_dtype='bf16' opened on the same files: phase 6's {len(got6)} queries, same ids "
            f"(max score diff {diff6:.3e})")

        extra = synthetic_rows((600, 661), N_APPEND, seed=SEED + 3)
        t0 = time.perf_counter()
        reopened.store(extra, [IndexRecord(f"extra{i}", 0) for i in range(N_APPEND)])
        reopened.save()
        append_s = time.perf_counter() - t0
        before = dir_bytes()
        if reopened.count_rows != SHIPPED["compact_min_rows"]:
            raise AssertionError(f"{reopened.count_rows} rows after the append")
        fired, compact_s, after = [], None, None
        for i in range(N_DELETE):
            n = reopened.count_rows
            t0 = time.perf_counter()
            reopened.delete_document(f"extra{i}")
            dt = time.perf_counter() - t0
            if reopened.count_rows < n:
                fired.append(i + 1)
                compact_s, after = dt, dir_bytes()
                if reopened.dead_fraction != 0.0:
                    raise AssertionError(f"dead fraction {reopened.dead_fraction} right after the compaction")
        trigger = int(SHIPPED["compact_dead_fraction"] * SHIPPED["compact_min_rows"]) + 1  # 1025
        kept = SHIPPED["compact_min_rows"] - trigger
        if fired != [trigger] or reopened.dead_fraction != (N_DELETE - trigger) / kept:
            raise AssertionError(f"compaction fired at deletes {fired}; dead fraction {reopened.dead_fraction}")
        if not after < before or path.with_name(path.name + ".compact").exists():
            raise AssertionError(f"files {before} -> {after} bytes, or a .compact directory is left")
        log(f"  appended {N_APPEND} rows and saved ({append_s:.3f} s, {before} bytes); {N_DELETE} deletes: the "
            f"trigger fired once, at delete {fired[0]}, compacting {SHIPPED['compact_min_rows']} -> {kept} rows "
            f"in {compact_s:.3f} s ({after} bytes); dead fraction after the last delete {reopened.dead_fraction:.6f}")

        survivors = [r for r in range(reopened.count_rows) if reopened._alive[r]]
        calls = pool_calls[0]
        fresh = MultiVectorIndex(FDEConfig(), device="cuda", device_block_rows=BLOCK_ROWS, **SHIPPED)
        fresh.store([reopened._mv_row(r) for r in survivors],
                    [IndexRecord(reopened.records[r].document_id, 0) for r in survivors],
                    fde_vectors=reopened._fde_rows(0, reopened.count_rows)[survivors])
        last = reopened.records[survivors[-1]].document_id
        queries = queries5 + [reopened._mv_row(survivors[-1]).astype(np.float32)]
        want = answer(fresh, queries)
        if want[-1][0][0] != last:
            raise AssertionError(f"self-query of {last} came back as {want[-1][0][0]}")
        got = answer(reopened, queries)
        reopened.save()  # writes the deletes after the compaction
        again = answer(open_index(), queries)
        for label, res in (("the compacted index", got), ("its reopen", again)):
            if [[d for d, _ in a] for a in res] != [[d for d, _ in a] for a in want]:
                raise AssertionError(f"{label} and a fresh index of the survivors give other ids")
            if res != want:
                raise AssertionError(f"{label}: scores differ from the fresh index's")
        log(f"  {len(survivors)} survivors: the compacted index, and its reopen after a save, answer "
            f"{len(queries)} queries with the ids and score bits of a fresh in-memory index of the survivors "
            f"(pool_multivector calls {pool_calls[0] - calls} to build it)")
    finally:
        mvi.pool_multivector = real_pool
    return {"card": smi, "rows": n_rows, "bytes": saved, "files": files, "save_s": save_ms / 1e3,
            "save_mb_per_s": saved / save_ms / 1e3, "open_ms": open_ms, "cold_query_ms": cold_ms,
            "warm_query_ms": warm_ms, "append_rows": N_APPEND, "append_save_s": append_s,
            "compaction_at_delete": fired[0], "compaction_s": compact_s, "rows_after_compaction": kept,
            "bytes_before_compaction": before, "bytes_after_compaction": after,
            "bf16_max_score_diff": diff6}


# phase 10: the text index at a real size, in process
TEXT_ROWS = 200_000
TEXT_DIM = 768  # morphik_tpu.toml [embedding] dimensions
TEXT_VOCAB = 30_000
TEXT_ROWS_PER_DOC = 10
TEXT_APPEND = 1_000
TEXT_N_QUERIES = 20
TEXT_SCORE_ATOL = 1e-5  # store (f32; device matvec or host) vs the f64 oracle
TEXT_TIE = 2e-6  # oracle scores closer than this rank as a set
SCAN_REPEATS = 20


class TextOracle:
    """The text store's contract in f64 numpy, independent of its code:
    cosine over alive rows (and the doc_ids filter); with a query text,
    0.5 * cosine + 0.5 * BM25 / its peak on the rows that match a term
    (k1 1.5, b 0.75, idf and lengths over the alive rows); top-k.
    Documents are numbered (the store's ids are f"doc{n}")."""

    def __init__(self, vecs, words, offsets, docs):
        import numpy as np

        self.v = np.zeros((0, vecs.shape[1]))
        self.words, self.offsets, self.row_of = np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, np.int64)
        self.docs, self.alive = np.zeros(0, np.int64), np.zeros(0, bool)
        self.append(vecs, (words, offsets), docs)

    def append(self, vecs, words, docs):
        import numpy as np

        v = vecs.astype(np.float64)
        self.v = np.concatenate([self.v, v / np.linalg.norm(v, axis=1, keepdims=True)])
        self.row_of = np.concatenate([self.row_of, len(self.docs) + np.repeat(np.arange(len(docs)), np.diff(words[1]))])
        self.words = np.concatenate([self.words, words[0]])
        self.offsets = np.concatenate([self.offsets, self.offsets[-1] + words[1][1:]])
        self.docs = np.concatenate([self.docs, docs])
        self.alive = np.concatenate([self.alive, np.ones(len(docs), bool)])
        self._tf = {}  # term -> per-row counts

    def delete(self, doc):
        self.alive &= self.docs != doc

    def prepare(self, queries):
        """Cosines of every row against each query (one f64 product)."""
        import numpy as np

        q = np.stack(queries).astype(np.float64)
        self.cos = self.v @ (q / np.linalg.norm(q, axis=1, keepdims=True)).T

    def answer(self, qi, k, doc_filter=None, terms=None):
        import numpy as np

        cos = self.cos[:, qi]
        mask = self.alive & (np.isin(self.docs, doc_filter) if doc_filter is not None else True)
        score = np.where(mask, cos, -np.inf)
        if terms:
            lens = np.diff(self.offsets).astype(np.float64)
            n = int(self.alive.sum())
            avg = max(lens[self.alive].sum() / n, 1.0)
            bm25 = np.zeros(len(self.docs))
            for t in set(terms):
                if t not in self._tf:
                    self._tf[t] = np.bincount(self.row_of[self.words == t], minlength=len(self.docs)).astype(np.float64)
                f = self._tf[t]
                df = int(((f > 0) & self.alive).sum())
                if df:
                    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
                    bm25 += np.where(f > 0, idf * f * 2.5 / (f + 1.5 * (0.25 + 0.75 * lens / avg)), 0.0)
            lex = mask & (bm25 > 0)
            if lex.any():
                score = np.where(lex, 0.5 * cos + 0.5 * bm25 / bm25[lex].max(), 0.5 * score)
        top = np.argsort(-score, kind="stable")[:k]
        return [(int(i), float(score[i])) for i in top if np.isfinite(score[i])]


def _same_answer(label, got, want):
    """`got` [(row, score)] against the oracle's: scores within
    TEXT_SCORE_ATOL; rows equal rank by rank, except among oracle scores
    closer than TEXT_TIE, which compare as sets."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results, the oracle {len(want)}")
    err = max((abs(g[1] - w[1]) for g, w in zip(got, want)), default=0.0)
    if err > TEXT_SCORE_ATOL:
        raise AssertionError(f"{label}: scores {err} from the oracle's")
    ws = np.array([w[1] for w in want])
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and ws[j - 1] - ws[j] < TEXT_TIE:
            j += 1
        if {g[0] for g in got[i:j]} != {w[0] for w in want[i:j]}:
            raise AssertionError(f"{label}: rows {[g[0] for g in got]} vs the oracle's {[w[0] for w in want]}")
        i = j
    return err


def text_corpus(rng, n, vocab_p, start):
    """n rows: seeded unit vectors and texts of 20-60 Zipf-drawn words.
    Returns (vectors, (word ids, offsets), texts, document numbers)."""
    import numpy as np

    vecs = rng.standard_normal((n, TEXT_DIM), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    lens = rng.integers(20, 61, n)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    words = rng.choice(TEXT_VOCAB, int(offsets[-1]), p=vocab_p)
    vocab = np.array([f"w{i}" for i in range(TEXT_VOCAB)], dtype=object)
    texts = [" ".join(vocab[words[offsets[i] : offsets[i + 1]]]) for i in range(n)]
    docs = (start + np.arange(n)) // TEXT_ROWS_PER_DOC
    return vecs, (words, offsets), texts, docs


def text_index_phase(torch, smi):
    """Phase 10: the text store on the card at TEXT_ROWS rows of TEXT_DIM,
    held against TextOracle: queries with and without a doc_ids filter,
    with and without the hybrid; the scan's device time beside its bound;
    an appended tail (uploaded alone); a delete; save and reopen."""
    import asyncio

    import numpy as np

    from morphik_core_tpu_torch.models.schemas import DocumentChunk
    from morphik_core_tpu_torch.vector_store import text_vector_store as tvs

    rng = np.random.default_rng(SEED + 10)
    ranks = np.arange(1, TEXT_VOCAB + 1, dtype=np.float64)
    vocab_p = 1.0 / ranks ** 1.07
    vocab_p /= vocab_p.sum()
    t0 = time.perf_counter()
    vecs, (words, offsets), texts, docs = text_corpus(rng, TEXT_ROWS, vocab_p, 0)
    gen_s = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_text_"))
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    try:
        store = tvs.TextVectorStore(path=tmp / "text_index")  # no device: the card

        def feed(vecs, texts, docs, start):
            for s in range(0, len(texts), 10_000):
                run(store.store_embeddings([
                    DocumentChunk(document_id=f"doc{docs[i]}", chunk_number=(start + i) % TEXT_ROWS_PER_DOC,
                                  content=texts[i], embedding=vecs[i]) for i in range(s, min(s + 10_000, len(texts)))]))

        t0 = time.perf_counter()
        feed(vecs, texts, docs, 0)
        build_s = time.perf_counter() - t0
        ns = store._ns_map["default"]
        cap = ns.vectors.shape[0]
        oracle = TextOracle(vecs, words, offsets, docs)
        # queries: half near a stored row, half random; texts: 3 words of ranks 100-3000
        qrows = rng.choice(TEXT_ROWS, TEXT_N_QUERIES // 2, replace=False)
        queries = [vecs[r] + 0.05 * rng.standard_normal(TEXT_DIM, dtype=np.float32) for r in qrows]
        queries += [rng.standard_normal(TEXT_DIM, dtype=np.float32) for _ in range(TEXT_N_QUERIES - len(qrows))]
        qterms = [rng.integers(100, 3000, 3) for _ in queries]
        all_docs = np.unique(docs)
        filt = np.sort(rng.choice(all_docs, len(all_docs) // 10, replace=False))
        filt_ids = [f"doc{d}" for d in filt]

        def rows(res):
            return [(ns._id_to_row[f"{c.document_id}-{c.chunk_number}"], c.score) for c in res]

        def check(label, timed=None, gone=None):
            oracle.prepare(queries)
            errs, answers = [], []
            for qi, (q, terms) in enumerate(zip(queries, qterms)):
                text = " ".join(f"w{t}" for t in terms)
                for filtered in (False, True):
                    for hybrid in (False, True):
                        t = time.perf_counter()
                        res = run(store.query_similar(q, k=10, doc_ids=filt_ids if filtered else None,
                                                      query_text=text if hybrid else None))
                        ms = (time.perf_counter() - t) * 1e3
                        if timed is not None:
                            timed.setdefault((filtered, hybrid), []).append(ms)
                        want = oracle.answer(qi, 10, filt if filtered else None, list(terms) if hybrid else None)
                        errs.append(_same_answer(f"{label} q{qi} filter={filtered} hybrid={hybrid}", rows(res), want))
                        answers.append([(c.document_id, c.chunk_number, c.score) for c in res])
                near = qi < len(qrows) and docs[qrows[qi]] != gone
                if near and answers[-4][0][0] != f"doc{docs[qrows[qi]]}":
                    raise AssertionError(f"{label} q{qi}: the row it was drawn near is not first")
            return max(errs), answers

        timed = {}
        err0, _ = check("200k", timed)
        if ns.full_uploads != 1 or ns.dev_buf is None or ns.dev_buf.device.type != "cuda":
            raise AssertionError(f"the scan did not run on the card from one upload: {ns.full_uploads}")

        # the scan alone: CUDA events around _masked_topm on the resident buffer
        q_dev = torch.from_numpy(queries[0] / np.linalg.norm(queries[0])).cuda()
        m = max(4 * 10, 256)

        def device_us(fn):  # p50 of SCAN_REPEATS calls, each between CUDA events (after one untimed)
            times = []
            for _ in range(SCAN_REPEATS + 1):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return float(np.percentile(times[1:], 50)) * 1e3

        scan_us = device_us(lambda: tvs._masked_topm(ns.dev_buf, q_dev, ns.dev_alive, m))
        matvec_us = device_us(lambda: ns.dev_buf @ q_dev)  # its first step alone
        scan = _bound(cap * TEXT_DIM * 4 + cap * 4 + TEXT_DIM * 4 + m * 8, 2 * cap * TEXT_DIM, "f32")

        # an appended tail: only it is uploaded
        vecs2, words2, texts2, docs2 = text_corpus(rng, TEXT_APPEND, vocab_p, TEXT_ROWS)
        feed(vecs2, texts2, docs2, TEXT_ROWS)
        oracle.append(vecs2, words2, docs2)
        queries[-1] = vecs2[7]
        err1, _ = check("after the append")
        if ns.full_uploads != 1 or ns.tail_uploads != 1 or ns.dev_rows != TEXT_ROWS + TEXT_APPEND:
            raise AssertionError(f"uploads after the append: full {ns.full_uploads}, tail {ns.tail_uploads}")

        # a delete: the document never returns
        gone = docs[qrows[0]]
        run(store.delete_chunks_by_document_id(f"doc{gone}"))
        oracle.delete(gone)
        err2, answers = check("after the delete", gone=gone)
        if any(d == f"doc{gone}" for a in answers for d, _, _ in a):
            raise AssertionError(f"the deleted {gone} came back")

        t0 = time.perf_counter()
        store.save()
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in (tmp / "text_index").iterdir())
        t0 = time.perf_counter()
        store = tvs.TextVectorStore(path=tmp / "text_index")
        open_s = time.perf_counter() - t0
        ns = store._ns_map["default"]
        err3, reopened = check("after the reopen", gone=gone)
        if [[(d, n) for d, n, _ in a] for a in reopened] != [[(d, n) for d, n, _ in a] for a in answers]:
            raise AssertionError("the reopened store answers with other ids")
        reopen_diff = max(abs(x[2] - y[2]) for a, b in zip(reopened, answers) for x, y in zip(a, b))
        if reopen_diff > 1e-6:
            raise AssertionError(f"the reopened store's scores moved by {reopen_diff}")
    finally:
        loop.close()
        shutil.rmtree(tmp, ignore_errors=True)
    lat = {f"{'filter' if f else 'all'}{'_hybrid' if h else ''}": v for (f, h), v in timed.items()}
    out = {
        "card": smi, "rows": TEXT_ROWS, "dim": TEXT_DIM, "cap": cap, "bytes": n_bytes, "corpus_gen_s": gen_s,
        "build_s": build_s, "scan_device_us_p50": scan_us, "scan_matvec_us_p50": matvec_us,
        "scan_bound_us": scan["bound_us"],
        "scan_bound_by": scan["bound_by"], "scan_share_of_bound": scan["bound_us"] / scan_us,
        **{f"query_{k}_p50_ms": float(np.percentile(v, 50)) for k, v in lat.items()},
        **{f"query_{k}_p99_ms": float(np.percentile(v, 99)) for k, v in lat.items()},
        "max_err_vs_oracle": max(err0, err1, err2, err3), "reopen_max_score_diff": reopen_diff,
        "appended": TEXT_APPEND, "full_uploads": 1, "tail_uploads": 1, "save_s": save_s, "open_s": open_s,
        "filter_docs": len(filt), "queries": TEXT_N_QUERIES,
    }
    log(f"phase 10: text index on the card: {TEXT_ROWS} rows x {TEXT_DIM} (cap {cap}, {cap * TEXT_DIM * 4} bytes "
        f"scanned) built in {build_s:.3f} s; scan p50 {scan_us:.1f} us (device, CUDA events; the matvec "
        f"alone {matvec_us:.1f} us) vs bound "
        f"{scan['bound_us']:.1f} us ({scan['bound_by']}); query_similar p50 ms "
        f"{ {k: round(float(np.percentile(v, 50)), 3) for k, v in lat.items()} }; every answer equals the f64 "
        f"oracle (max score err {out['max_err_vs_oracle']:.2e}) before and after a {TEXT_APPEND}-row append "
        f"(tail upload only), a delete and a save ({n_bytes} bytes, {save_s:.3f} s) + reopen ({open_s:.3f} s)")
    return out


# phase 13: a real checkpoint on the card
TOKENIZER_FIXTURE = ROOT / "tests" / "fixtures" / "tokenizer_bpe.json"
TOKENIZER_CASES = ROOT / "tests" / "fixtures" / "tokenizer_cases.json"
# where the 7.5 GB checkpoint is written: the temporary directory, which
# had 80.2 GB free on the card's machine (PERF.md, phase 13's own print)
CHECKPOINT_PARENT = None
# int8 attention (the int8 QK^T, static scales) against bf16 attention,
# both with the int8 + static matmuls, on the same random 3B weights: mean
# per-token cosine of the 8 pages' embeddings, measured 0.9524 (min 0.889)
# on one NVIDIA H100, and of the text queries' (dynamic scales), 0.9849
# (min 0.971). The error compounds over 32 + 36 blocks, as W8A8's does.
MIN_INT8_ATTENTION_COSINE = 0.94
MIN_INT8_ATTENTION_QUERY_COSINE = 0.975


def _drop_page_cache(files) -> None:
    """Sync `files` to the disk and ask the kernel to drop their pages
    (advice: `_page_cache_share` says what it did)."""
    import os

    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def _page_cache_share(files) -> float:
    """The share of the pages of `files` held in the page cache: mincore(2)
    over a shared read-only mapping of each, which reads nothing."""
    import ctypes
    import os

    import numpy as np

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    page = os.sysconf("SC_PAGE_SIZE")
    resident = total = 0
    for f in files:
        size = os.path.getsize(f)
        if not size:
            continue
        fd = os.open(f, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, 1, 1, fd, 0)  # PROT_READ, MAP_SHARED
            if addr in (None, ctypes.c_void_p(-1).value):
                raise OSError(ctypes.get_errno(), f"mmap of {f}")
            try:
                vec = np.zeros((size + page - 1) // page, np.uint8)
                if libc.mincore(addr, size, vec.ctypes.data) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore of {f}")
            finally:
                libc.munmap(addr, size)
        finally:
            os.close(fd)
        resident += int((vec & 1).sum())
        total += len(vec)
    return resident / max(total, 1)


def _cold_read(files) -> tuple:
    """Drop `files` from the page cache, then read each once in 64 MiB
    reads: (the share cached before the read, bytes, seconds)."""
    _drop_page_cache(files)
    share = _page_cache_share(files)
    n = 0
    t0 = time.perf_counter()
    for f in files:
        with open(f, "rb", buffering=0) as fh:
            while chunk := fh.read(64 << 20):
                n += len(chunk)
    return share, n, time.perf_counter() - t0


def write_checkpoint_phase(torch, model):
    """Phase 13, first half (right after phase 3a, before phase 3b
    quantizes the weights in place): phase 3a's bf16 weights as an HF
    checkpoint (2 GiB shards, the index json, config.json and the
    committed tokenizer.json). The files are synced to the disk with the
    advice to drop them from the page cache; the phase reports the share
    that stays cached."""
    from morphik_core_tpu_torch.models.colqwen.convert import write_hf_checkpoint

    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=CHECKPOINT_PARENT))
    free_gb = shutil.disk_usage(ckpt).free / 1e9
    t0 = time.perf_counter()
    stats = write_hf_checkpoint(model, ckpt, tokenizer_file=TOKENIZER_FIXTURE)
    cached_s = time.perf_counter() - t0
    _drop_page_cache(sorted(ckpt.iterdir()))
    write_s = time.perf_counter() - t0
    gb = stats["bytes"] / 1e9
    log(f"phase 13 (write): phase 3a's bf16 weights as an HF checkpoint in {ckpt.parent} ({free_gb:.1f} GB free "
        f"before): {stats['tensors']} tensors in {stats['shards']} shards, {gb:.3f} GB in {write_s:.3f} s "
        f"({gb / write_s:.3f} GB/s with the fsync; {cached_s:.3f} s to the page cache)")
    return ckpt, dict(stats, gb=gb, write_s=write_s, write_to_page_cache_s=cached_s, free_gb=free_gb,
                      dir=str(ckpt.parent))


def _differing_leaves(a, b) -> list:
    """Names of the parameters and buffers (scales included) where two
    models differ."""
    la = dict(a.named_parameters()) | dict(a.named_buffers())  # a buffer left None is absent
    lb = dict(b.named_parameters()) | dict(b.named_buffers())
    return [n for n in sorted(set(la) | set(lb)) if n not in la or n not in lb or la[n].dtype != lb[n].dtype
            or la[n].shape != lb[n].shape or not la[n].equal(lb[n])]


def checkpoint_phase(torch, model, ckpt: Path, written: dict, _kernels, smi):
    """Phase 13: the checkpoint of phase 3a served through
    `model.checkpoint_path` (the shipped toml, no model passed in)."""
    import gc

    import numpy as np

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import CALIBRATION_BATCH, ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.calibrate import calibration_batches, load_calibration_pages
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
    from morphik_core_tpu_torch.models.colqwen.tokenizer import QwenTokenizer
    from morphik_core_tpu_torch.scripts.rehearse_checkpoint import (
        peak_rss_gb,
        rehearse_failure_modes,
        reset_peak_rss,
        rss_gb,
    )
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.png import decode_png, encode_png

    t_phase = time.perf_counter()
    tok = QwenTokenizer.from_file(TOKENIZER_FIXTURE)
    cases = json.loads(TOKENIZER_CASES.read_text(encoding="utf-8"))
    bad = [c["text"] for c in cases if tok.encode(c["text"]) != c["ids"]]
    if bad:
        raise AssertionError(f"the port's tokenizer differs from the committed tokenizers ids on {bad!r}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_service_"))
    failure_modes = rehearse_failure_modes(tmp / "failures")
    if not all(failure_modes.values()):
        raise AssertionError(f"checkpoint failure modes: {failure_modes}")
    settings = service_settings(tmp)
    settings.model.checkpoint_path = str(ckpt)
    shards = sorted(ckpt.glob("*.safetensors"))
    cached_share = _page_cache_share(shards)
    reset_peak_rss()
    rss_before = rss_gb()
    t0 = time.perf_counter()
    services = build_services(settings)  # no model passed: the checkpoint, loaded and calibrated at boot
    rss_peak = peak_rss_gb()
    server = ServerThread(services)
    boot_s = time.perf_counter() - t0
    emb, store = services.colpali_embedding_model, services.colpali_vector_store
    cm = emb.model
    load_s, cal_s = emb.last_metrics["checkpoint_load_s"], emb.last_metrics["calibration_s"]
    log(f"phase 13: the checkpoint served through model.checkpoint_path (morphik_tpu.toml: {cm.matmul_precision} "
        f"matmuls, static scales, {cm.attention_precision} attention): {cached_share:.4f} of the shards' pages in "
        f"the page cache before the load; load {load_s:.3f} s "
        f"({written['gb'] / load_s:.3f} GB/s read + convert + upload), host RSS {rss_before:.2f} GiB before and "
        f"{rss_peak:.2f} GiB at its peak, calibration "
        f"{cal_s:.3f} s, server up in {boot_s:.3f} s; tokenizer ids equal the committed ones on {len(cases)} cases; "
        f"failure modes {failure_modes}")
    client = Client(f"http://127.0.0.1:{server.server.port}")
    try:
        if cm.tokenizer is None or any(blk.attn_qk_as is None or blk.q_w.a_scale is None for blk in cm.visual.blocks):
            raise AssertionError("the served checkpoint lacks its tokenizer or its calibrated scales")
        # phase 3b's resident model was recalibrated at each server boot since phase 8, each time under its
        # previous static scales (the reference's capture runs the tower as it serves); calibrate it afresh
        # from dynamic scales, as the checkpoint's boot did
        for blk in model.visual.blocks:
            blk.set_qk_scales(None)
            for name in ("q_w", "k_w", "v_w", "proj_w", "gate_w", "up_w", "down_w"):
                getattr(blk, name).set_act_scale(None)
        u8, (hu, wu) = load_calibration_pages()
        model.calibrate_static_act_scales(calibration_batches(u8, CALIBRATION_BATCH), hu, wu)
        differ = _differing_leaves(model, cm)
        if differ:
            raise AssertionError(f"the checkpoint model's weights or scales differ from phase 3b's: {differ[:8]}")
        pages = _pages(cm.cfg)
        stacked = np.stack([p for p, _ in pages])
        model.tokenizer = cm.tokenizer  # phase 3b's resident model, given the same tokenizer
        try:
            want_pages, want_q = model.embed_image_batch(stacked, *GRID), model.embed_queries(QUERIES)
        finally:
            model.tokenizer = None
        got_pages, got_q = cm.embed_image_batch(stacked, *GRID), cm.embed_queries(QUERIES)
        if not (np.array_equal(got_pages, want_pages) and all(np.array_equal(a, b) for a, b in zip(got_q, want_q))):
            raise AssertionError(
                f"the checkpoint's embeddings differ from phase 3b's model: pages max "
                f"{float(np.abs(got_pages - want_pages).max())}, queries max "
                f"{max(float(np.abs(a - b).max()) for a, b in zip(got_q, want_q))}")
        _, _, times_bf16, peak_bf16 = _embed_pages(torch, emb, pages)

        pngs = [encode_png(p) for p in service_pages()]
        _kernels.reset_launch_counts()  # the HTTP path of the checkpoint starts here
        t0 = time.perf_counter()
        docs = [client.upload(f"ckpt_page{i}.png", data)["external_id"] for i, data in enumerate(pngs)]
        ingest_s = _wait_completed(client, docs) - t0
        ingest_launches = dict(_kernels.launch_counts)
        k3_per_forward = cm.cfg.vision.depth - len(cm.cfg.vision.fullatt_block_indexes)  # the windowed blocks: 28
        if ingest_launches["window_attention"] != k3_per_forward * len(pngs):
            raise AssertionError(f"ingest of {len(pngs)} pages (one forward each): K3 {ingest_launches}, expected "
                                 f"{k3_per_forward} a forward")
        lat, http_results = [], {}
        for text in QUERIES:
            for rep in range(RETRIEVE_REPEATS + 1):  # the first is a warm-up, untimed
                t = time.perf_counter()
                res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
                if rep:
                    lat.append((time.perf_counter() - t) * 1e3)
            http_results[text] = res
        img_res = client.call("POST", "/retrieve/chunks", {"query_image": bytes_to_data_uri(pngs[3], "image/png"),
                                                           "k": 4})
        if img_res[0]["document_id"] != docs[3]:
            raise AssertionError(f"image self-query top-1 is {img_res[0]['document_id']}, expected {docs[3]}")
        launches = dict(_kernels.launch_counts)  # and ends here
        n_retrieves = len(QUERIES) * (RETRIEVE_REPEATS + 1) + 1
        if launches["maxsim_q8"] - ingest_launches["maxsim_q8"] < n_retrieves:
            raise AssertionError(f"{n_retrieves} retrieves did not each launch K1: {launches}")
        query_embs = {text: emb.embed_query(text) for text in QUERIES}
        query_embs["<page 3>"] = emb.embed_query(decode_png(pngs[3]))
        http_results["<page 3>"] = img_res
        for key, q in query_embs.items():
            lib = server.run(store.query_similar(q, k=4, doc_ids=docs))
            got = [(r["document_id"], r["chunk_number"]) for r in http_results[key]]
            if got != [(c.document_id, c.chunk_number) for c in lib]:
                raise AssertionError(f"{key!r}: HTTP {got} vs in-process store {[c.document_id for c in lib]}")
            err = max(abs(r["score"] - c.score) for r, c in zip(http_results[key], lib))
            if err > SCORE_ATOL:
                raise AssertionError(f"{key!r}: HTTP scores differ from the store's by {err}")
    finally:
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    del services, emb, store, server
    gc.collect()
    torch.cuda.empty_cache()

    # int8 attention from the same checkpoint: the int8 QK^T in every block, static qk scales
    t0 = time.perf_counter()
    m8 = ColQwenModel.from_checkpoint(ckpt, matmul_precision="int8", attention_precision="int8")
    e8 = ColpaliEmbeddingModel(m8, batch_size=BATCH)  # calibrates the act scales and attn_qk_as
    torch.cuda.synchronize()
    int8_boot_s = time.perf_counter() - t0
    _kernels.reset_launch_counts()  # the int8-attention forwards start here
    embs8, _, times_int8, peak_int8 = _embed_pages(torch, e8, pages)
    q8 = [e8.embed_query(text) for text in QUERIES]
    launches8 = dict(_kernels.launch_counts)  # and end here
    if launches8["window_attention"] != 0:
        raise AssertionError(f"int8 attention launched K3: {launches8}")
    cos = np.concatenate([(a * b).sum(-1) for a, b in zip(embs8, got_pages)])
    qcos = np.concatenate([(a * b).sum(-1) for a, b in zip(q8, got_q)])
    del m8, e8
    gc.collect()
    torch.cuda.empty_cache()
    cold_share, cold_bytes, cold_s = _cold_read(shards)  # the disk's rate, for the load's beside it
    pages_s = {"bf16_attention": BATCH / times_bf16[1], "int8_attention": BATCH / times_int8[1]}
    out = {
        "card": smi, "write": written, "page_cache_share_before_load": cached_share,
        "load_s": load_s, "load_gb_per_s": written["gb"] / load_s,
        "cold_read": {"page_cache_share_before": cold_share, "gb": cold_bytes / 1e9, "s": cold_s,
                      "gb_per_s": cold_bytes / 1e9 / cold_s},
        "host_rss_gib_before": rss_before, "peak_host_rss_gib": rss_peak, "calibration_s": cal_s, "boot_s": boot_s, "int8_attention_boot_s": int8_boot_s,
        "pages_per_s": pages_s, "batch_wall_s": {"bf16_attention": times_bf16, "int8_attention": times_int8},
        "peak_mem_gb": {"bf16_attention": peak_bf16, "int8_attention": peak_int8},
        "http_ingest_s": ingest_s, "http_pages": len(pngs), "retrieve": _percentiles(lat),
        "int8_attention_cosine": {"pages_mean": float(cos.mean()), "pages_min": float(cos.min()),
                                  "queries_mean": float(qcos.mean()), "queries_min": float(qcos.min())},
        "tokenizer_cases": len(cases), "bit_identical_to_phase_3b": True,
        "launches": launches, "ingest_launches": ingest_launches, "int8_attention_launches": launches8,
        "failure_modes": failure_modes, "phase_s": time.perf_counter() - t_phase + written["write_s"],
    }
    log(f"  bit-identical to phase 3b's model given the same tokenizer ({BATCH} pages, {len(QUERIES)} queries); "
        f"pages/s(second batch) bf16 attention {pages_s['bf16_attention']:.3f}, int8 attention "
        f"{pages_s['int8_attention']:.3f}; HTTP: {len(pngs)} PNG pages in {ingest_s:.3f} s, retrieve p50 "
        f"{out['retrieve']['p50_ms']:.3f} ms p99 {out['retrieve']['p99_ms']:.3f} ms, equal to the in-process store, "
        f"image self-query top-1; launches {launches}; int8 attention: launches {launches8}, per-token cosine vs "
        f"bf16 attention pages mean {cos.mean():.6f} min {cos.min():.6f}, queries mean {qcos.mean():.6f} "
        f"(bounds {MIN_INT8_ATTENTION_COSINE}, {MIN_INT8_ATTENTION_QUERY_COSINE}); cold read of the shards "
        f"({cold_share:.4f} cached before): {cold_bytes / 1e9:.3f} GB in {cold_s:.3f} s "
        f"({cold_bytes / 1e9 / cold_s:.3f} GB/s); phase 13 took "
        f"{out['phase_s']:.3f} s with the write")
    if not (cos.mean() > MIN_INT8_ATTENTION_COSINE and qcos.mean() > MIN_INT8_ATTENTION_QUERY_COSINE):
        raise AssertionError(f"int8 attention drifts from bf16 attention: {out['int8_attention_cosine']}")
    return out


# phase 17: the f32 path at full width
# mean per-token cosine of the f32 tower's page embeddings against phase
# 3a's bf16 tower. The checkpoint holds phase 3a's bf16 weights, which load
# into f32 exactly, so the two towers differ only where bf16 rounds the
# activations: less than the int8 tower's matmuls differ from bf16 (held
# to MIN_MEAN_COSINE in phase 3b, measured 0.9603 there), so the same floor.
MIN_F32_COSINE = MIN_MEAN_COSINE
TINY_FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
TINY_GRID = (12, 16)  # the tiny tower's pages: 12 x 16 units, T = 3,072 for 4 pages, head width 16
TINY_PAGES = 4
TINY_ATOL = 5e-4  # the end-to-end tolerance of tests/test_colqwen_parity.py


def f32_phase(torch, ckpt: Path, bf16_embs, _kernels, smi):
    """Phase 17: phase 13's checkpoint loaded in f32 (the twin of the
    reference's `from_checkpoint(path, dtype=jnp.float32)`) embeds phase
    3a's pages through K3's 3xTF32 kernel; the tiny trained fixture on the
    card against the same model on the CPU."""
    import gc

    import numpy as np

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = ColQwenModel.from_checkpoint(ckpt, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("the f32 checkpoint model holds a parameter in another dtype")
    model.tokenizer = None  # phase 3a's model has none: the same byte-fallback prompt around the pages
    emb = ColpaliEmbeddingModel(model, batch_size=BATCH)
    k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
    _kernels.reset_launch_counts()  # the f32 forwards start here
    embs, _, times, peak = _embed_pages(torch, emb, _pages(model.cfg))
    launches = dict(_kernels.launch_counts)  # and end here
    n_forwards = len(times)  # one forward of the batch of 8 a run
    n_seq = _check_embeddings(model, embs, [None] * len(embs))
    cos = np.concatenate([(a * b).sum(-1) for a, b in zip(embs, bf16_embs)])
    del emb, model
    gc.collect()
    torch.cuda.empty_cache()

    tiny_gpu = ColQwenModel.from_fixture(TINY_FIXTURE, device="cuda")
    tiny_cpu = ColQwenModel.from_fixture(TINY_FIXTURE, device="cpu")
    tc = tiny_gpu.cfg.vision
    rng = np.random.default_rng(SEED + 17)
    tiny_pages = rng.integers(0, 256, (TINY_PAGES, TINY_GRID[0] * TINY_GRID[1] * tc.merge_unit,
                                       tc.patch_input_dim // 2), dtype=np.uint8)
    _kernels.reset_launch_counts()
    got = tiny_gpu.embed_image_batch(tiny_pages, *TINY_GRID)
    tiny_launches = dict(_kernels.launch_counts)
    want = tiny_cpu.embed_image_batch(tiny_pages, *TINY_GRID)
    tiny_err = float(np.abs(got - want).max())
    tiny_k3 = tc.depth - len(tc.fullatt_block_indexes)
    del tiny_gpu, tiny_cpu
    out = {
        "card": smi, "load_s": load_s, "pages": BATCH, "grid": list(GRID), "batch_wall_s": times,
        "pages_per_s": BATCH / times[1], "forwards": n_forwards, "launches": launches,
        "k3_per_forward": k3_per_forward, "peak_mem_gb": peak,
        "cosine_vs_bf16": {"mean": float(cos.mean()), "min": float(cos.min()), "p01": float(np.quantile(cos, 0.01)),
                           "floor": MIN_F32_COSINE},
        "tiny": {"grid": list(TINY_GRID), "pages": TINY_PAGES, "head_dim": tc.head_dim,
                 "max_abs_err_card_vs_cpu": tiny_err, "atol": TINY_ATOL, "launches": tiny_launches},
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"phase 17: the checkpoint in f32 ({smi}): loaded in {load_s:.3f} s; {BATCH} pages -> {BATCH} x "
        f"({n_seq}, {embs[0].shape[1]}); batch wall s first={times[0]:.4f} second={times[1]:.4f} "
        f"pages/s(second)={out['pages_per_s']:.3f}; peak mem GB={peak:.2f}; launches {launches} over {n_forwards} "
        f"forwards; per-token cosine vs phase 3a's bf16 pages mean {cos.mean():.6f} min {cos.min():.6f} (floor: mean > "
        f"{MIN_F32_COSINE}); tiny fixture on the card vs the CPU: max abs err {tiny_err:.3e} (atol {TINY_ATOL}), "
        f"launches {tiny_launches}; phase {out['phase_s']:.3f} s")
    if launches["window_attention"] != k3_per_forward * n_forwards:
        raise AssertionError(f"f32 forwards: K3 {launches}, expected {k3_per_forward} a forward x {n_forwards}")
    if not cos.mean() > MIN_F32_COSINE:
        raise AssertionError(f"f32 page embeddings drift from bf16: mean cosine {cos.mean()}")
    if tiny_launches["window_attention"] != tiny_k3:
        raise AssertionError(f"the tiny tower's forward: K3 {tiny_launches}, expected {tiny_k3}")
    if got.shape != want.shape or not np.isfinite(got).all() or not tiny_err <= TINY_ATOL:
        raise AssertionError(f"the tiny fixture on the card is {tiny_err} from the CPU's (atol {TINY_ATOL})")
    return out


# phase 14: /query answered through an LLM wire format (a local fake provider)
LLM_PAGES = 4  # phase 8's PNG pages ingested on phase 14's server
LLM_QUERY_REPEATS = 5  # /query (JSON) of each text query
LLM_PROVIDERS = {  # registered_models of phase 14, beside the fake's base URL
    "fake_openai": {"model_name": "fake-gpt", "api_key": "sk-chip-smoke"},
    "fake_ollama": {"model_name": "fake-llava", "provider": "ollama"},
    "fake_anthropic": {"model_name": "fake-claude", "provider": "anthropic", "api_key": "sk-ant-chip-smoke"},
    "fake_embed": {"model_name": "fake-embedding", "api_key": "sk-chip-smoke"},
}


def sse_query(base: str, body: dict):
    """POST /query with stream_response over a socket -> (the deltas, the
    sources, seconds to the first delta, seconds in all)."""
    import urllib.request

    req = urllib.request.Request(base + "/query", data=json.dumps(dict(body, stream_response=True)).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    deltas, sources, first = [], None, None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                break
            if not line.startswith("data: "):
                continue
            event = json.loads(line[6:])
            if event["type"] == "assistant":
                first = first if first is not None else time.perf_counter() - t0
                deltas.append(event["content"])
            elif event["type"] == "sources":
                sources = event["sources"]
    return deltas, sources, first, time.perf_counter() - t0


def llm_phase(torch, model, _kernels, smi):
    """Phase 14: /query through an LLM wire format on a fourth server from
    the shipped toml (phase 3b's model, cloud mode), its completion and
    text-embedding models registered keys of a local fake provider."""
    import asyncio

    from morphik_core_tpu_torch.completion.models import build_completion_model
    from morphik_core_tpu_torch.models.schemas import CompletionRequest
    from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, FakeProviders
    from morphik_core_tpu_torch.services_init import build_services

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_llm_"))
    settings = service_settings(tmp)
    fake = FakeProviders(embed_dim=settings.embedding.dimensions).start()
    base_urls = {"fake_openai": fake.url + "/v1", "fake_embed": fake.url + "/v1"}
    settings.registered_models = {k: dict(v, api_base=base_urls.get(k, fake.url)) for k, v in LLM_PROVIDERS.items()}
    settings.completion.model = "fake_openai"
    settings.embedding.model = "fake_embed"
    settings.morphik.mode = "cloud"
    try:
        t0 = time.perf_counter()
        server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
        boot_s = time.perf_counter() - t0
        services = server.services
        client = Client(f"http://127.0.0.1:{server.server.port}")
        log(f"phase 14: /query through an LLM wire format ({smi}), server up in {boot_s:.3f} s (morphik_tpu.toml, "
            f"mode {settings.morphik.mode!r}, completion {type(services.completion_model).__name__}, text embedder "
            f"{type(services.embedding_model).__name__}; the providers a local fake at {fake.url})")
        try:
            out = _llm_checks(client, fake, _kernels, services, settings)
        finally:
            server.stop()
        # h: one CompletionRequest of the phase's retrieved pages through the Ollama and Anthropic wire formats
        pages = out.pop("retrieved_payloads")
        request = CompletionRequest(query=QUERIES[0], context_chunks=["Context note."] + pages, max_tokens=256)
        raw_b64 = [u.split(",", 1)[1] for u in pages]
        native = {}
        for key in ("fake_ollama", "fake_anthropic"):
            provider = build_completion_model(settings.registered_models, key, settings.service.environment)

            async def both(provider=provider):
                return await provider.complete(request), [t async for t in provider.complete_stream(request)]

            n = len(fake.requests)
            t = time.perf_counter()
            resp, toks = asyncio.run(both())
            native[key] = {"provider": type(provider).__name__, "ms": (time.perf_counter() - t) * 1e3,
                           "stream_deltas": len(toks)}
            sent = [r["body"] for r in fake.requests[n:]]
            if resp.completion != ANSWER or "".join(toks) != ANSWER or len(sent) != 2:
                raise AssertionError(f"{key}: {resp.completion!r}, stream {toks!r}, {len(sent)} requests")
            for body in sent:
                user = body["messages"][-1]
                images = user.get("images") if key == "fake_ollama" else [
                    b["source"]["data"] for b in user["content"] if b["type"] == "image"]
                if images != raw_b64:
                    raise AssertionError(f"{key}: the request does not carry the pages' raw base64")
                if key == "fake_anthropic" and any(b["source"]["media_type"] != "image/jpeg"
                                                   for b in user["content"] if b["type"] == "image"):
                    raise AssertionError("fake_anthropic: an image block is not image/jpeg")
        out["native_providers"] = native
    finally:
        fake.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(card=smi, boot_s=boot_s, phase_s=time.perf_counter() - t_phase)
    log(f"  /query p50 {out['query']['p50_ms']:.3f} ms p99 {out['query']['p99_ms']:.3f} ms over "
        f"{out['query']['n']} (retrieve p50 {out['retrieve']['p50_ms']:.3f} ms, share {out['retrieve_share']:.3f}); "
        f"{out['data_uri_bytes_per_query']} data-URI bytes a /query; SSE first delta {out['sse_first_delta_ms']:.3f} "
        f"ms of {out['sse_ms']:.3f}; output_format=text retrieve {out['text_format_retrieve_ms']:.3f} ms; "
        f"on-the-fly query of the {DOC_PDF_PAGES}-page PDF {out['on_the_fly_s']:.3f} s (ingest to completed "
        f"{out['on_the_fly_ingest_s']:.3f} s); routed text ingest {out['routed_text_ingest_s']:.3f} s; 402 after "
        f"{out['usage_limits']['usage']['queries_used']} queries; native providers {json.dumps(native)}; launches "
        f"{out['launches']}; phase {out['phase_s']:.3f} s ({smi})")
    return out


def _llm_checks(client, fake, _kernels, services, settings):
    """Phase 14, a-g, on the running server."""
    import sqlite3

    import numpy as np

    from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, TRANSCRIPTION
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg
    from morphik_core_tpu_torch.utils.png import encode_png

    pages = service_pages()[:LLM_PAGES]
    payloads = [bytes_to_data_uri(encode_jpeg(p, 80)[0], "image/jpeg") for p in pages]
    model = services.colpali_embedding_model.model
    k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
    _kernels.reset_launch_counts()  # phase 14's path starts here
    # a: PNG pages through K3
    t = time.perf_counter()
    docs = [client.upload(f"llm_page{i}.png", encode_png(p))["external_id"] for i, p in enumerate(pages)]
    ingest_s = _wait_completed(client, docs) - t
    ingest_launches = dict(_kernels.launch_counts)
    if ingest_launches["window_attention"] != k3_per_forward * LLM_PAGES:
        raise AssertionError(f"ingest of {LLM_PAGES} pages: K3 {ingest_launches}, expected {k3_per_forward} a page")
    # b: /query (JSON): the provider gets the retrieved pages' stored payloads, in /retrieve/chunks' order
    q_lat, r_lat, uri_bytes, n_colpali = [], [], [], 0
    for text in QUERIES:
        for _ in range(LLM_QUERY_REPEATS):
            t = time.perf_counter()
            chunks = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
            r_lat.append((time.perf_counter() - t) * 1e3)
            n = len(fake.requests)
            t = time.perf_counter()
            answer = client.call("POST", "/query", {"query": text, "k": 4})
            q_lat.append((time.perf_counter() - t) * 1e3)
            n_colpali += 2
            sent = [r for r in fake.requests[n:] if r["path"] == "/v1/chat/completions"]
            if len(sent) != 1 or sent[0]["headers"].get("authorization") != "Bearer sk-chip-smoke":
                raise AssertionError(f"/query {text!r}: {len(sent)} completion requests, or no bearer key")
            content = sent[0]["body"]["messages"][-1]["content"]
            urls = [b["image_url"]["url"] for b in content if b["type"] == "image_url"]
            if urls != [c["content"] for c in chunks] or not set(urls) <= set(payloads) or len(urls) != 4:
                raise AssertionError(f"/query {text!r}: the provider got other images than /retrieve/chunks' "
                                     "stored q80 payloads")
            if answer["completion"] != ANSWER or [s["document_id"] for s in answer["sources"]] != [
                    c["document_id"] for c in chunks]:
                raise AssertionError(f"/query {text!r}: {answer['completion']!r}, sources {answer['sources']}")
            uri_bytes.append(sum(len(u) for u in urls))
    retrieved_payloads = urls
    # c: SSE: the deltas join to the provider's text
    deltas, sources, first_s, sse_s = sse_query(client.base, {"query": QUERIES[0], "k": 4})
    n_colpali += 1
    if "".join(deltas) != ANSWER or len(deltas) < 2 or not sources:
        raise AssertionError(f"SSE /query: deltas {deltas!r}, sources {sources}")
    # d: output_format="text": every image chunk as the provider's transcription
    t = time.perf_counter()
    as_text = client.call("POST", "/retrieve/chunks", {"query": QUERIES[1], "k": 4, "output_format": "text"})
    text_ms = (time.perf_counter() - t) * 1e3
    n_colpali += 1
    if len(as_text) != 4 or any(c["content"] != TRANSCRIPTION or not c["metadata"]["is_image"] for c in as_text):
        raise AssertionError(f"output_format=text: {[c['content'][:40] for c in as_text]}")
    # e: the on-the-fly query of phase 11's PDF with a schema, then stored (text path)
    pdf = document_files(np.random.default_rng(SEED + 10))["report.pdf"][0]
    schema = {"type": "object", "properties": {"topic": {"type": "string"}, "pages": {"type": "string"}}}
    body, ctype = Client.multipart("report.pdf", pdf, "application/pdf", {
        "prompt": "What is this report about?", "schema": json.dumps(schema),
        "ingestion_options": json.dumps({"ingest": True, "use_colpali": False, "metadata": {"source": "on-the-fly"}})})
    t = time.perf_counter()
    otf = client.call("POST", "/ingest/document/query", body, ctype)
    otf_s = time.perf_counter() - t
    want = {"topic": "topic from the fake provider", "pages": "pages from the fake provider"}
    if otf["structured_output"] != want or otf["document"] is None or otf["metadata"]["parsed_chars"] < 10_000:
        raise AssertionError(f"on-the-fly query: {json.dumps(otf)[:500]}")
    otf_ingest_s = _wait_completed(client, [otf["document"]["external_id"]]) - t
    stored = client.call("GET", f"/documents/{otf['document']['external_id']}")
    if stored["metadata"] != {"source": "on-the-fly", **want}:
        raise AssertionError(f"the on-the-fly document's metadata: {stored['metadata']}")
    # f: /ingest/text through the routed embedder (the fake's hashing vectors), then a text retrieve
    prose = seeded_prose(np.random.default_rng(SEED + 14), 9000)
    n = len(fake.requests)
    t = time.perf_counter()
    tdoc = client.call("POST", "/ingest/text", {"content": prose, "filename": "routed.txt", "use_colpali": False})
    routed_s = time.perf_counter() - t
    if tdoc["system_metadata"]["status"] != "completed" or not any(
            r["path"] == "/v1/embeddings" for r in fake.requests[n:]):
        raise AssertionError(f"routed /ingest/text: {tdoc['system_metadata']}")
    sentence = prose.split(". ")[3]
    hits = client.call("POST", "/retrieve/chunks", {"query": sentence, "k": 3, "use_colpali": False})
    if not hits or hits[0]["document_id"] != tdoc["external_id"]:
        raise AssertionError(f"routed text retrieve of {sentence!r}: {[h['document_id'] for h in hits]}")
    # g: the free tier's 500 queries: the 500th answers, the 501st is refused
    db = Path(settings.storage.storage_path) / "user_limits.db"
    with sqlite3.connect(db) as conn:
        conn.execute("UPDATE user_limits SET queries_used=499 WHERE user_id=?", (settings.auth.dev_user_id,))
    last = client.request("POST", "/query", {"query": QUERIES[2], "k": 4})
    refused = client.request("POST", "/query", {"query": QUERIES[2], "k": 4})
    n_colpali += 1
    limits = client.call("GET", "/usage/limits")
    if last[0] != 200 or refused[0] != 402 or limits["usage"]["queries_used"] != 500 or limits["limits"][
            "queries_per_month"] != 500:
        raise AssertionError(f"limits: /query {last[0]} then {refused[0]} {refused[1][:200]!r}; {limits}")
    launches = dict(_kernels.launch_counts)  # phase 14's path ends here
    if launches["maxsim_q8"] < n_colpali or launches["window_attention"] != ingest_launches["window_attention"]:
        raise AssertionError(f"phase 14 launches {launches}: K1 below its {n_colpali} ColPali retrieves, or K3 "
                             "launched after the ingest")
    return {
        "pages": LLM_PAGES, "ingest_s": ingest_s, "query": _percentiles(q_lat), "retrieve": _percentiles(r_lat),
        "retrieve_share": float(np.percentile(r_lat, 50) / np.percentile(q_lat, 50)),
        "data_uri_bytes_per_query": int(np.mean(uri_bytes)), "sse_first_delta_ms": first_s * 1e3,
        "sse_ms": sse_s * 1e3, "sse_deltas": len(deltas), "text_format_retrieve_ms": text_ms,
        "on_the_fly_s": otf_s, "on_the_fly_ingest_s": otf_ingest_s,
        "on_the_fly_parsed_chars": otf["metadata"]["parsed_chars"], "routed_text_ingest_s": routed_s,
        "usage_limits": limits, "provider_requests": len(fake.requests), "launches": launches,
        "ingest_launches": ingest_launches, "colpali_retrieves": n_colpali, "retrieved_payloads": retrieved_payloads,
    }


REMOTE_PAGES = 8  # phase 15: PNG pages at GRID ingested through the API node
REMOTE_KEY = "chip-smoke-embedding-key"  # morphik.morphik_embedding_api_key of both servers
REMOTE_PDF_NAME = "Q3\\report.pdf"  # a backslash: the parse request's filename is sanitised to Q3_report.pdf
REMOTE_SCAN_PAGES = 2


def closed_port_url() -> str:
    """A 127.0.0.1 URL whose port nothing listens on (connections are refused)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return f"http://127.0.0.1:{port}"


class _Count(logging.Handler):
    """Counts the records whose message contains `needle`."""

    def __init__(self, needle: str):
        super().__init__()
        self.needle, self.n = needle, 0

    def emit(self, record):
        if self.needle in record.getMessage():
            self.n += 1


def remote_phase(torch, model, _kernels, smi):
    """Phase 15: remote endpoints. Server E (a local-mode server from the
    toml, phase 3b's model, a keyed `/embeddings`) and server A, an API
    node (`colpali_mode="api"` on [a closed port, E], `parser_mode="api"`
    on [a closed port, the fake parse endpoint], `ocr_mode="api"` on the
    fake OCR endpoint), which loads no tower."""
    import importlib.util

    from morphik_core_tpu_torch.embedding.colpali_api_embedding_model import ColpaliApiEmbeddingModel
    from morphik_core_tpu_torch.scripts.fake_providers import FakeProviders
    from morphik_core_tpu_torch.services_init import build_services

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_remote_"))
    fake = FakeProviders().start()
    servers = []
    try:
        e_settings = service_settings(tmp / "e")
        e_settings.morphik.morphik_embedding_api_key = REMOTE_KEY
        t0 = time.perf_counter()
        e = ServerThread(build_services(e_settings, colqwen_model=model))  # recalibrates static scales
        servers.append(e)
        e_boot_s = time.perf_counter() - t0
        e_base = f"http://127.0.0.1:{e.server.port}"
        dead_embed, dead_parse = closed_port_url(), closed_port_url()
        a_settings = service_settings(tmp / "a")
        a_settings.morphik.colpali_mode = "api"
        a_settings.morphik.morphik_embedding_api_endpoints = [dead_embed, e_base]
        a_settings.morphik.morphik_embedding_api_key = REMOTE_KEY
        a_settings.model.embedding_dim = e.services.colpali_embedding_model.embedding_dim
        a_settings.parser.parser_mode = "api"
        a_settings.parser.parse_api_endpoints = [dead_parse, fake.url + "/parse"]
        a_settings.parser.ocr_mode = "api"
        a_settings.parser.ocr_api_endpoint = fake.url + "/ocr"
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        a = ServerThread(build_services(a_settings))
        servers.append(a)
        a_boot_s = time.perf_counter() - t0
        a_boot_bytes = torch.cuda.memory_allocated() - mem0
        emb = a.services.colpali_embedding_model
        if not isinstance(emb, ColpaliApiEmbeddingModel) or hasattr(emb, "model") or a_boot_bytes > (64 << 20):
            raise AssertionError(f"the API node's embedder is {type(emb).__name__} and its boot allocated "
                                 f"{a_boot_bytes} bytes on the card: it must be the remote embedder with no tower")
        log(f"phase 15: remote endpoints ({smi}): embedding server E up in {e_boot_s:.3f} s; API node A up in "
            f"{a_boot_s:.3f} s with {a_boot_bytes} bytes on the card (no tower); A embeds on [{dead_embed} (closed), "
            f"{e_base}], parses on [{dead_parse} (closed), the fake], OCRs on the fake at {fake.url}")
        out = _remote_checks(torch, _kernels, e, a, fake, dead_embed, dead_parse)
        # S3: the card's machine has no boto3; the provider raises the reference's RuntimeError
        s3_settings = service_settings(tmp / "s3")
        s3_settings.storage.provider = "aws-s3"
        had_boto3 = importlib.util.find_spec("boto3") is not None
        saved = sys.modules.get("boto3")
        sys.modules["boto3"] = None  # absent, whatever the machine has
        try:
            build_services(s3_settings, colqwen_model=model)
            raise AssertionError('storage.provider="aws-s3" built without boto3')
        except RuntimeError as err:
            if "boto3" not in str(err):
                raise
            s3_error = str(err)
        finally:
            if saved is None:
                sys.modules.pop("boto3", None)
            else:
                sys.modules["boto3"] = saved
    finally:
        for server in reversed(servers):
            server.stop()
        fake.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(card=smi, e_boot_s=e_boot_s, a_boot_s=a_boot_s, a_boot_bytes=a_boot_bytes, s3_error=s3_error,
               machine_has_boto3=had_boto3, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               phase_s=time.perf_counter() - t_phase)
    log(f"  A ingested {REMOTE_PAGES} PNG pages at {out['ingest_pages_per_s']:.3f} pages/s; embed calls: first "
        f"{out['first_call_s'] * 1e3:.3f} ms (met the closed endpoint), later p50 {out['later_call_p50_ms']:.3f} ms; "
        f"rows and FDE bit-identical to E's in-process embed; retrieve p50 {out['retrieve']['p50_ms']:.3f} ms p99 "
        f"{out['retrieve']['p99_ms']:.3f} ms (remote encode p50 {out['remote_encode_p50_ms']:.3f} ms) equal to A's "
        f"in-process store; image self-query top-1; parse {out['parse_s']:.3f} s, OCR ingest {out['ocr_s']:.3f} s; "
        f"relay bit-identical; S3 without boto3: {s3_error!r}; launches {out['launches']}; peak "
        f"{out['peak_memory_gb']:.2f} GB; phase {out['phase_s']:.3f} s ({smi})")
    return out


def _remote_checks(torch, _kernels, e, a, fake, dead_embed, dead_parse):
    """Phase 15, 1-4, on the running servers E and A."""
    import io

    import numpy as np

    from morphik_core_tpu_torch.models.schemas import Chunk
    from morphik_core_tpu_torch.ops.fde import fde_document_batch
    from morphik_core_tpu_torch.ops.maxsim import pad_multivectors
    from morphik_core_tpu_torch.scripts.fake_providers import ocr_answer, parse_answer
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg
    from morphik_core_tpu_torch.utils.png import encode_png

    client = Client(f"http://127.0.0.1:{a.server.port}")
    e_base = f"http://127.0.0.1:{e.server.port}"
    emb = a.services.colpali_embedding_model
    e_emb = e.services.colpali_embedding_model
    model = e_emb.model
    k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
    # what A's embedder sends, and each of its calls' time: recorded around the methods it calls
    posts, batches = [], []
    post_sync, embed_batch = emb._post_sync, emb._embed_batch

    def spy_post(endpoint, input_type, inputs):
        t = time.perf_counter()
        try:
            out = post_sync(endpoint, input_type, inputs)
            posts.append((endpoint, input_type, len(inputs), t, True))
            return out
        except Exception:
            posts.append((endpoint, input_type, len(inputs), t, False))
            raise

    async def spy_batch(input_type, inputs):
        t = time.perf_counter()
        out = await embed_batch(input_type, inputs)
        batches.append((input_type, len(inputs), time.perf_counter() - t))
        return out

    emb._post_sync, emb._embed_batch = spy_post, spy_batch
    parse_failures = _Count(f"parse API {dead_parse} failed")
    logging.getLogger("morphik_core_tpu_torch.parser.morphik_parser").addHandler(parse_failures)
    try:
        pages = service_pages()[:REMOTE_PAGES]
        pngs = [encode_png(p) for p in pages]
        payloads = [bytes_to_data_uri(encode_jpeg(p, 80)[0], "image/jpeg") for p in pages]
        _kernels.reset_launch_counts()  # phase 15's path starts here
        # 1: page ingest through A: each page's payload embedded by E's tower, one request a page
        n_parse = len(fake.requests)
        t = time.perf_counter()
        docs = [client.upload(f"remote_page{i}.png", data)["external_id"] for i, data in enumerate(pngs)]
        ingest_s = _wait_completed(client, docs) - t
        ingest_launches = dict(_kernels.launch_counts)
        forwards = sum(1 for p in posts if p[4] and p[1] == "image")  # one page a request, one forward each
        if ingest_launches["window_attention"] != k3_per_forward * forwards or forwards != REMOTE_PAGES:
            raise AssertionError(f"ingest: K3 {ingest_launches} over {forwards} forwards at E, expected "
                                 f"{k3_per_forward} a forward and {REMOTE_PAGES} forwards")
        parse_calls = [r for r in fake.requests[n_parse:] if r["path"] == "/parse"]
        if len(parse_calls) != REMOTE_PAGES or parse_failures.n != REMOTE_PAGES:
            raise AssertionError(f"{len(parse_calls)} calls to the fake parse endpoint and {parse_failures.n} "
                                 f"failures of the closed one, expected {REMOTE_PAGES} each")
        index = a.services.colpali_vector_store._indexes["default"]
        for doc, payload in zip(docs, payloads):
            want = e_emb.embed_for_ingestion_sync([Chunk(content=payload, metadata={"is_image": True})])[0][0]
            got = index.get_multivector(doc, 0)
            if not np.array_equal(got, want.astype(index.store_dtype).astype(np.float32)):
                raise AssertionError(f"{doc}: A's stored row differs from E's in-process embed of its payload")
            dense, mask = pad_multivectors([want])
            fde = fde_document_batch(torch.from_numpy(dense).cuda(), torch.from_numpy(mask).cuda(), index.fde_config)
            row = index._id_to_row[f"{doc}-0"]
            if not np.array_equal(index._fde_rows(row, row + 1)[0], fde[0].cpu().numpy()):
                raise AssertionError(f"{doc}: A's stored FDE row differs from fde_document_batch of its row")
        # 2: retrieves: the query encoded by E's text tower over HTTP, reranked on A through K1
        lat, encode_ms, results = [], [], {}
        n_retrieves = 0
        _kernels.reset_launch_counts()
        for text in QUERIES:
            for _ in range(RETRIEVE_REPEATS):
                n = len(batches)
                t = time.perf_counter()
                res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
                lat.append((time.perf_counter() - t) * 1e3)
                encode_ms += [b[2] * 1e3 for b in batches[n:]]
                n_retrieves += 1
            results[text] = res
        q_img = bytes_to_data_uri(pngs[3], "image/png")
        t = time.perf_counter()
        img_res = client.call("POST", "/retrieve/chunks", {"query_image": q_img, "k": 4})
        image_ms = (time.perf_counter() - t) * 1e3
        n_retrieves += 1
        retrieve_launches = dict(_kernels.launch_counts)
        if img_res[0]["document_id"] != docs[3] or img_res[0]["content"] != payloads[3]:
            raise AssertionError(f"image self-query top-1 is {img_res[0]['document_id']}, expected {docs[3]}")
        if retrieve_launches["maxsim_q8"] < n_retrieves or retrieve_launches["maxsim"] or retrieve_launches[
                "window_attention"] != k3_per_forward:
            raise AssertionError(f"retrieves: launches {retrieve_launches}: K1 below its {n_retrieves} retrieves, "
                                 f"K2 launched, or K3 not {k3_per_forward} (the image query's one forward at E)")
        max_err = 0.0
        for text, res in results.items():
            want = a.run(a.services.colpali_vector_store.query_similar(e_emb.embed_query(text), k=4, doc_ids=docs))
            if [(r["document_id"], r["chunk_number"]) for r in res] != [(c.document_id, c.chunk_number) for c in want]:
                raise AssertionError(f"{text!r}: A's answer differs from its in-process store on E's encoding")
            max_err = max([max_err] + [abs(r["score"] - c.score) for r, c in zip(res, want)])
        if max_err > SCORE_ATOL:
            raise AssertionError(f"A's scores differ from its in-process store's by {max_err}")
        # the closed endpoint: tried once, then skipped until its cooldown passes
        dead = [p[3] for p in posts if p[0] == dead_embed]
        if not dead or dead[0] != posts[0][3] or any(t1 - t0 < 60.0 for t0, t1 in zip(dead, dead[1:])):
            raise AssertionError(f"the closed endpoint was tried at {dead}: expected once, then after each cooldown")
        if any(p[4] for p in posts if p[0] == dead_embed) or not all(p[4] for p in posts if p[0] == e_base):
            raise AssertionError("a call to the closed endpoint succeeded, or one to E failed")
        call_s = [b[2] for b in batches]
        # 3: parse and OCR: a two-page PDF through the fake parse endpoint, a blank scan through the deep rung
        pdf = text_pdf([["Remote parse, page one: quarterly revenue."], ["Page two: the signature page."]])
        n = len(fake.requests)
        t = time.perf_counter()
        pdoc = client.upload(REMOTE_PDF_NAME, pdf, "application/pdf", {"use_colpali": "false"})["external_id"]
        parse_s = _wait_completed(client, [pdoc]) - t
        parsed = [r for r in fake.requests[n:] if r["path"] == "/parse"]
        if len(parsed) != 1 or parsed[0]["body"]["filename"] != "Q3_report.pdf":
            raise AssertionError(f"the PDF's parse requests: {[r['body'].get('filename') for r in parsed]}")
        hits = client.call("POST", "/retrieve/chunks", {"query": parse_answer("Q3_report.pdf", pdf), "k": 1,
                                                        "use_colpali": False})
        if not hits or hits[0]["document_id"] != pdoc:
            raise AssertionError(f"the parsed PDF is not the top text retrieve of its text: {hits}")
        scan = text_pdf([[]] * REMOTE_SCAN_PAGES)
        n = len(fake.requests)
        t = time.perf_counter()
        sdoc = client.upload("scan.pdf", scan, "application/pdf", {"use_colpali": "false"})["external_id"]
        ocr_s = _wait_completed(client, [sdoc]) - t
        ocr_calls = [r for r in fake.requests[n:] if r["path"].startswith("/ocr")]
        meta = client.call("GET", f"/documents/{sdoc}")["additional_metadata"]
        if len(ocr_calls) != REMOTE_SCAN_PAGES or meta.get("ocr_pages") != REMOTE_SCAN_PAGES:
            raise AssertionError(f"the scan: {len(ocr_calls)} OCR calls, metadata {meta}")
        shape = ocr_calls[0]["body"]["shape"]
        page_text = ocr_answer(np.full(shape, 255, np.uint8), True)["text"].split(", digest")[0]
        hits = client.call("POST", "/retrieve/chunks", {"query": page_text, "k": 1, "use_colpali": False})
        if not hits or hits[0]["document_id"] != sdoc:
            raise AssertionError(f"the OCRed scan is not the top text retrieve of {page_text!r}: {hits}")
        # 4: the relay: A's /embeddings (through E) equals E's, bit for bit
        relay = {}
        _kernels.reset_launch_counts()  # the relay: its forwards at E, for A's request and for E's own
        for body in ({"input_type": "image", "inputs": payloads[:2]}, {"input_type": "text", "inputs": QUERIES[:2]}):
            got = []
            for base in (client.base, e_base):
                status, raw = Client(base).request("POST", "/embeddings", body, token=REMOTE_KEY)
                if status != 200:
                    raise AssertionError(f"/embeddings at {base}: HTTP {status} {raw[:200]!r}")
                npz = np.load(io.BytesIO(raw))
                got.append([npz[f"emb_{i}"] for i in range(len(body["inputs"]))])
            if not all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(*got)):
                raise AssertionError(f"/embeddings {body['input_type']}: A's relay differs from E's answer")
            relay[body["input_type"]] = [list(x.shape) for x in got[0]]
        relay_launches = dict(_kernels.launch_counts)
        if relay_launches["window_attention"] != 2 * k3_per_forward:  # one forward of the 2 pages at E, twice
            raise AssertionError(f"the relay's launches {relay_launches}: expected K3 {2 * k3_per_forward}")
    finally:
        logging.getLogger("morphik_core_tpu_torch.parser.morphik_parser").removeHandler(parse_failures)
        emb._post_sync, emb._embed_batch = post_sync, embed_batch
    return {
        "pages": REMOTE_PAGES, "ingest_s": ingest_s, "ingest_pages_per_s": REMOTE_PAGES / ingest_s,
        "last_metrics": dict(emb.last_metrics), "first_call_s": call_s[0],
        "later_call_p50_ms": float(np.percentile(call_s[1:], 50)) * 1e3, "embed_calls": len(call_s),
        "dead_endpoint_tries": len(dead), "retrieve": _percentiles(lat),
        "remote_encode_p50_ms": float(np.percentile(encode_ms, 50)), "image_query_ms": image_ms,
        "max_score_diff": max_err, "parse_s": parse_s, "ocr_s": ocr_s, "relay_shapes": relay,
        "launches": {"ingest": ingest_launches, "retrieve": retrieve_launches, "relay": relay_launches},
        "k3_per_forward": k3_per_forward, "forwards_at_e": forwards,
    }


CONNECTOR_FIXTURES = ROOT / "tests" / "fixtures" / "connector_files.npz"
CONNECTOR_IMAGES = ("progressive.jpg", "multiscan.jpg", "adam7.png", "rgb16.png", "gray16.png", "cmyk.jpg")
CONNECTOR_REFUSED = "arith.jpg"  # an arithmetic-coded frame header: still refused (ROADMAP item 3b-ii)
CONNECTOR_PDF_PAGES = 4
CONNECTOR_LISTED = 101  # files in the fake GitHub root, Drive root and Zotero library: two pages of 100
DECODE_REPEATS = 3


def _decode_ms(fn, data: bytes, first_ms: "float | None" = None) -> float:
    """The median host ms of `fn(data)` over DECODE_REPEATS calls (one of
    them `first_ms`, a call already timed, when given)."""
    import numpy as np

    times = [] if first_ms is None else [first_ms]
    while len(times) < DECODE_REPEATS:
        t = time.perf_counter()
        fn(data)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def check_connector_decoders(z) -> dict:
    """Phase 16, on this machine: each committed connector file decodes to
    Pillow's pixels (their hash); the host ms a page of the progressive,
    the multi-scan and a baseline JPEG of the same page (the port's q80
    encode of its pixels), of the Adam7 and 16-bit PNGs and of the CMYK
    JPEG; the arithmetic-coded file is refused from its headers."""
    import hashlib

    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
    from morphik_core_tpu_torch.utils.image import read_image
    from morphik_core_tpu_torch.utils.jpeg import UnsupportedJpeg, encode_jpeg, probe_jpeg, read_jpeg

    decode_ms, pages = {}, {}
    for name in CONNECTOR_IMAGES:
        key = name.replace(".", "_")
        data = z[key].tobytes()
        rgb = to_rgb_u8(*read_image(data))
        if hashlib.sha256(rgb.tobytes()).hexdigest() != str(z[f"{key}_rgb_sha256"]):
            raise AssertionError(f"connector fixture {name}: decoded pixels differ from Pillow's")
        decode_ms[name] = _decode_ms(read_image, data)
        pages[name] = list(rgb.shape[:2])
    baseline, _ = encode_jpeg(to_rgb_u8(*read_image(z["progressive_jpg"].tobytes())), 80)
    decode_ms["baseline.jpg (the progressive page, q80)"] = _decode_ms(read_jpeg, baseline)
    try:
        probe_jpeg(z[CONNECTOR_REFUSED.replace(".", "_")].tobytes())
        raise AssertionError("the arithmetic-coded fixture was not refused")
    except UnsupportedJpeg:
        pass
    return {"decode_ms": decode_ms, "page_hw": pages,
            "progressive_over_baseline": decode_ms["progressive.jpg"] / decode_ms[
                "baseline.jpg (the progressive page, q80)"]}


def connectors_phase(torch, model, _kernels, smi):
    """Phase 16: the connectors and the console on a server from the toml
    serving phase 3b's model; the remote connectors against the fake
    GitHub, Google and Zotero APIs of scripts/fake_providers.py."""
    import base64
    import hashlib

    import numpy as np

    import morphik_core_tpu_torch.ee.connectors.github as gh
    import morphik_core_tpu_torch.ee.connectors.google_drive as gd
    import morphik_core_tpu_torch.ee.connectors.zotero as zt
    from morphik_core_tpu_torch.scripts.fake_providers import GITHUB_TOKEN, GOOGLE_CODE, ZOTERO_KEY, FakeProviders
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri

    t_phase = time.perf_counter()
    z = np.load(CONNECTOR_FIXTURES)
    decoders = check_connector_decoders(z)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_connectors_"))
    src = tmp / "src"   # outside storage.storage_path
    src.mkdir()
    for name in CONNECTOR_IMAGES + (CONNECTOR_REFUSED,):
        (src / name).write_bytes(z[name.replace(".", "_")].tobytes())
    rng = np.random.default_rng(SEED + 16)
    (src / "report.pdf").write_bytes(text_pdf([seeded_prose(rng, 1500) for _ in range(CONNECTOR_PDF_PAGES)]))
    (src / "notes.txt").write_text(seeded_prose(rng, 4000))
    fake = FakeProviders().start()
    for i in range(CONNECTOR_LISTED - 1):
        fake.add_github_file("acme/docs", f"n{i:03}.md", f"# note {i}\n".encode())
        fake.add_drive_file(f"d{i:03}", f"note {i:03}.txt", "text/plain", f"drive note {i}".encode())
        fake.add_zotero_item("4242", f"N{i:03}", {"itemType": "note", "title": f"note {i}"})
    fake.add_github_file("acme/docs", "photo.jpg", z["progressive_jpg"].tobytes())   # by download_url
    fake.add_drive_file("d-report", "drive.pdf", "application/pdf", text_pdf([seeded_prose(rng, 800)] * 2))
    fake.add_zotero_item("4242", "ITEM1", {"itemType": "journalArticle", "title": "On flux capacitors"})
    fake.add_zotero_item("4242", "ATT1", {"itemType": "attachment", "filename": "figure.png"},
                         file=z["adam7_png"].tobytes(), parent="ITEM1")
    saved = (gh.API, gd.TOKEN_URL, gd.API, zt.API)
    gh.API, gd.TOKEN_URL, gd.API, zt.API = (fake.url + "/github", fake.url + "/google/token",
                                            fake.url + "/google/drive/v3", fake.url + "/zotero")
    settings = service_settings(tmp)
    settings.ee.google_client_id, settings.ee.google_client_secret = "chip-smoke-client", "chip-smoke-secret"
    forward_batches = []
    tower = model.embed_image_batch

    def counted_forward(patches, *args, **kw):
        forward_batches.append(int(patches.shape[0]))
        return tower(patches, *args, **kw)

    server = None
    try:
        t0 = time.perf_counter()
        server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
        boot_s = time.perf_counter() - t0
        client = Client(f"http://127.0.0.1:{server.server.port}")
        model.embed_image_batch = counted_forward
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()  # the connectors path starts here
        log(f"phase 16: connectors ({smi}): server up in {boot_s:.3f} s; decoders (host ms a page) "
            f"{json.dumps(decoders['decode_ms'])}")
        C = "/ee/connectors"
        if client.call("GET", f"{C}/local/auth_status")["is_authenticated"]:
            raise AssertionError("the local connector is authenticated before its finalize")
        status, _ = client.request("POST", f"{C}/local/auth/finalize", {"root": settings.storage.storage_path})
        if status != 400:
            raise AssertionError(f"a root over the storage directory answered {status}, expected 400")
        client.call("POST", f"{C}/local/auth/finalize", {"root": str(src)})
        listed = [f["name"] for f in client.call("GET", f"{C}/local/files")["files"]]
        if listed != sorted(p.name for p in src.iterdir()):
            raise AssertionError(f"the local connector lists {listed}")
        ingest_s, docs = {}, {}

        def ingest(kind, file_id, **body):
            t = time.perf_counter()
            status, raw = client.request("POST", f"{C}/{kind}/ingest", {"file_id": file_id, **body})
            if status != 202:
                raise AssertionError(f"{kind} ingest {file_id}: HTTP {status} {raw[:300]!r}")
            doc = json.loads(raw)["document"]["external_id"]
            ingest_s[f"{kind}:{file_id}"] = _wait_completed(client, [doc]) - t
            docs[f"{kind}:{file_id}"] = doc
            return doc

        for name in CONNECTOR_IMAGES + ("report.pdf", "notes.txt"):
            ingest("local", name)
        status, raw = client.request("POST", f"{C}/local/ingest", {"file_id": CONNECTOR_REFUSED})
        if status != 415 or b"3b-ii" not in raw or b"arithmetic-coded" not in raw:
            raise AssertionError(f"the arithmetic-coded JPEG answered {status} {raw[:300]!r}, expected 415")
        for name in CONNECTOR_IMAGES:   # the stored page is the reference's q80 payload, byte for byte
            chunk = client.call("POST", "/batch/chunks", {
                "sources": [{"document_id": docs[f"local:{name}"], "chunk_number": 0}], "use_colpali": True})[0]
            payload = base64.b64decode(chunk["content"].split(",", 1)[1])
            if hashlib.sha256(payload).hexdigest() != str(z[name.replace(".", "_") + "_payload_sha256"]):
                raise AssertionError(f"{name}: the stored q80 payload differs from the reference's")
        pdf_pages = client.call("GET", f"/documents/{docs['local:report.pdf']}")["system_metadata"]["page_count"]
        if pdf_pages != CONNECTOR_PDF_PAGES:
            raise AssertionError(f"the connector PDF stored {pdf_pages} pages")

        def two_pages(kind):
            p1 = client.call("GET", f"{C}/{kind}/files")
            p2 = client.call("GET", f"{C}/{kind}/files?page_token={p1['next_page_token']}")
            if len(p1["files"]) != 100 or len(p2["files"]) != CONNECTOR_LISTED - 100 or p2["next_page_token"]:
                raise AssertionError(f"{kind}: pages of {len(p1['files'])} and {len(p2['files'])} files")
            return [f["id"] for f in p1["files"] + p2["files"]]

        # GitHub: a token, two pages of the root, a file by download_url
        client.call("POST", f"{C}/github/auth/finalize", {"token": GITHUB_TOKEN, "repo": "acme/docs"})
        two_pages("github")
        ingest("github", "photo.jpg")
        # Google Drive: the authorization-code flow with its state, a PDF
        state = client.call("GET", f"{C}/google_drive/auth/initiate_url")["state"]
        status, _ = client.request("GET", f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state={state}")
        if status != 200 or not client.call("GET", f"{C}/google_drive/auth_status")["is_authenticated"]:
            raise AssertionError(f"the Drive OAuth callback answered {status}")
        if client.request("GET", f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state={state}")[0] != 400:
            raise AssertionError("the Drive OAuth state was accepted twice")
        if "d-report" not in two_pages("google_drive"):
            raise AssertionError("the Drive listing lacks the report")
        ingest("google_drive", "d-report")
        # Zotero: an API key, an item's attachments, one attachment
        client.call("POST", f"{C}/zotero/auth/finalize", {"api_key": ZOTERO_KEY, "user_library_id": "4242"})
        if "ITEM1" not in two_pages("zotero"):
            raise AssertionError("the Zotero library lacks its item")
        if [f["id"] for f in client.call("GET", f"{C}/zotero/files?path=ITEM1")["files"]] != ["ATT1"]:
            raise AssertionError("the Zotero attachments differ")
        ingest("zotero", "ATT1")
        ingest_launches = dict(_kernels.launch_counts)
        ingest_forwards = len(forward_batches)
        k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        if not ingest_forwards or ingest_launches["window_attention"] != k3_per_forward * ingest_forwards:
            raise AssertionError(f"{ingest_forwards} tower forwards, K3 launched "
                                 f"{ingest_launches['window_attention']} times, expected {k3_per_forward} a forward")

        # 40 retrieves over the ingested pages, each through K1; an image query of the progressive file
        lat, k1 = [], []
        for i in range(40):
            before = _kernels.launch_counts["maxsim_q8"]
            t = time.perf_counter()
            res = client.call("POST", "/retrieve/chunks", {"query": QUERIES[i % len(QUERIES)], "k": 4})
            lat.append((time.perf_counter() - t) * 1e3)
            k1.append(_kernels.launch_counts["maxsim_q8"] - before)
            if len(res) != 4:
                raise AssertionError(f"a retrieve answered {len(res)} chunks")
        before = _kernels.launch_counts["maxsim_q8"]
        t = time.perf_counter()
        img = client.call("POST", "/retrieve/chunks", {
            "query_image": bytes_to_data_uri(z["progressive_jpg"].tobytes(), "image/jpeg"), "k": 4})
        image_ms = (time.perf_counter() - t) * 1e3
        k1.append(_kernels.launch_counts["maxsim_q8"] - before)
        if img[0]["document_id"] not in (docs["local:progressive.jpg"], docs["github:photo.jpg"]):
            raise AssertionError(f"the progressive image query's top-1 is {img[0]['document_id']}")
        if min(k1) <= 0:
            raise AssertionError(f"a retrieve did not launch K1: {k1}")
        console = client.request("GET", "/console")
        want = (ROOT / "morphik_core_tpu_torch" / "api" / "console.html").read_bytes()
        if console[0] != 200 or hashlib.sha256(console[1]).hexdigest() != hashlib.sha256(want).hexdigest():
            raise AssertionError("/console differs from the console's file")
        for kind in ("local", "github", "google_drive", "zotero"):
            if client.call("POST", f"{C}/{kind}/disconnect")["status"] != "disconnected":
                raise AssertionError(f"the {kind} connector was not connected")
        launches = dict(_kernels.launch_counts)
        if launches["window_attention"] != k3_per_forward * len(forward_batches):   # the image query's forward too
            raise AssertionError(f"K3 launched {launches['window_attention']} times over {len(forward_batches)} "
                                 f"tower forwards")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        model.embed_image_batch = tower
        gh.API, gd.TOKEN_URL, gd.API, zt.API = saved
        if server is not None:
            server.stop()
        fake.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": smi, "boot_s": boot_s, "ingest_s": ingest_s, "ingest_forwards": ingest_forwards,
           "tower_forwards": len(forward_batches), "embed_batches": forward_batches, "decoders": decoders, "retrieve": _percentiles(lat),
           "image_query_ms": image_ms, "launches": launches, "ingest_launches": ingest_launches,
           "peak_memory_gb": peak_gb, "console_sha256": hashlib.sha256(want).hexdigest(),
           "phase_s": time.perf_counter() - t_phase}
    log(f"  ingests to completed (s) {json.dumps(ingest_s)}; ingest tower forwards {ingest_forwards} (K3 "
        f"{ingest_launches['window_attention']}); retrieve p50 {out['retrieve']['p50_ms']:.3f} ms p99 "
        f"{out['retrieve']['p99_ms']:.3f} ms; progressive image query {image_ms:.3f} ms; launches {launches}; "
        f"peak {peak_gb:.2f} GB; phase {out['phase_s']:.3f} s ({smi})")
    return out


# phase 22: the page image formats the reference opens through Pillow
FORMAT_FIXTURES = ROOT / "tests" / "fixtures" / "image_formats.npz"
FORMAT_FILES = ("bmp1.bmp", "bmp8.bmp", "bmp24.bmp", "bmp4.bmp", "bmp16.bmp", "bmp32.bmp", "bmp_rle8.bmp",
                "bmp_rle4.bmp", "page.gif", "anim.gif", "interlaced.gif", "g4.tif", "g3.tif", "mh.tif", "g3_2d.tif",
                "lzw.tif", "deflate_tiles.tif", "packbits.tif", "raw_gray.tif", "jpeg.tif", "multipage.tif",
                "lossy.webp", "lossless.webp", "alpha.webp", "anim.webp", "cmyk.jpg", "ycck.jpg")
FORMAT_TIMED = ("letter_g4.tif", "wide_lossy.webp", "wide_baseline.jpg")  # timed on the host, not ingested
FORMAT_REFUSED = "arith.jpg"
FORMAT_QUERIES = ("lossy.webp", "g4.tif", "lzw.tif")  # image queries in WebP and in TIFF
FORMAT_CTYPES = {"bmp": "image/bmp", "gif": "image/gif", "tif": "image/tiff", "webp": "image/webp",
                 "jpg": "image/jpeg"}


def _twelve_bit(data: bytes) -> bytes:
    """A baseline JPEG whose frame header says 12-bit samples."""
    at = data.index(b"\xff\xc0")
    return data[:at + 4] + b"\x0c" + data[at + 5:]


def check_format_decoders(z) -> dict:
    """Phase 22, on the host: each committed file decodes to Pillow's
    mode and pixels (their hash), its host ms beside it (the median of
    DECODE_REPEATS for the two timed pages and their baseline JPEG); the
    arithmetic-coded and 12-bit JPEGs are refused from their headers."""
    import hashlib

    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
    from morphik_core_tpu_torch.utils.image import UnsupportedImage, probe_image, read_image

    decode_ms, sizes = {}, {}
    for name in FORMAT_FILES + FORMAT_TIMED:
        key = name.replace(".", "_")
        data = z[key].tobytes()
        t = time.perf_counter()
        pixels, mode, palette = read_image(data)
        ms = (time.perf_counter() - t) * 1e3
        rgb = to_rgb_u8(pixels, mode, palette)
        if mode != str(z[f"{key}_mode"]) or hashlib.sha256(rgb.tobytes()).hexdigest() != str(z[f"{key}_rgb_sha256"]):
            raise AssertionError(f"format fixture {name}: mode {mode} or pixels differ from Pillow's")
        decode_ms[name] = _decode_ms(read_image, data) if name in FORMAT_TIMED else ms
        sizes[name] = list(rgb.shape[:2])
    for words, data in (("arithmetic-coded", z[FORMAT_REFUSED.replace(".", "_")].tobytes()),
                        ("12-bit", _twelve_bit(z["wide_baseline_jpg"].tobytes()))):
        try:
            probe_image(data)
            raise AssertionError(f"the {words} JPEG was not refused")
        except UnsupportedImage as e:
            if words not in str(e) or "3b-ii" not in str(e):
                raise
    base = decode_ms["wide_baseline.jpg"]
    return {"decode_ms": decode_ms, "page_hw": sizes,
            "letter_g4_over_baseline": decode_ms["letter_g4.tif"] / base,
            "wide_lossy_webp_over_baseline": decode_ms["wide_lossy.webp"] / base}


MORE_FORMAT_FIXTURES = ROOT / "tests" / "fixtures" / "image_formats_more.npz"
MORE_FORMAT_FILES = ("page.ppm", "page16.pgm", "plain.pbm", "page.pfm", "icon.ico", "cursor.cur", "page.psd",
                     "cmyk.psd", "page.pcx", "indexed.pcx", "pages.dcx", "page.tga", "mapped.tga", "flipped.tga",
                     "page.sgi", "page.ras", "page.qoi", "page.xbm", "page.xpm", "arith.jpg",
                     "arith_progressive.jpg", "lossless.jpg", "lossless_rgb.jpg")
MORE_FORMAT_TIMED = ("letter.ppm", "letter.psd", "letter.pcx", "letter.tga", "letter.sgi", "letter.ras",
                     "letter.qoi", "letter.xbm", "letter.xpm", "letter_arith.jpg", "letter_lossless.jpg",
                     "letter_baseline.jpg")  # the 200 dpi letter page, timed on the host
MORE_FORMAT_PAST_PILLOW = ("letter_arith.jpg",)  # its data run past Pillow's 64 KiB block: timed, else refused
MORE_FORMAT_QUERIES = ("page.ppm", "page.psd", "arith.jpg")
MORE_FORMAT_REFUSED = (("hierarchical.jpg", "hierarchical JPEG"), ("page.avif", "AVIF"))
MORE_FORMAT_UNOPENED = "jpeg12.jpg"  # Image.open fails on it: no 415, its job completes with no page
MORE_FORMAT_FAILING = ("page_ht.j2k",)  # refused before: its job fails, as Pillow's load does
MORE_FORMAT_CTYPES = {"ppm": "image/x-portable-pixmap", "pgm": "image/x-portable-graymap",
                      "pbm": "image/x-portable-bitmap", "pfm": "image/x-portable-floatmap", "ico": "image/x-icon",
                      "cur": "image/x-icon", "psd": "image/vnd.adobe.photoshop", "pcx": "image/x-pcx",
                      "dcx": "image/x-dcx", "tga": "image/x-tga", "sgi": "image/sgi", "ras": "image/x-cmu-raster",
                      "qoi": "image/qoi", "xbm": "image/x-xbitmap", "xpm": "image/x-xpixmap", "jpg": "image/jpeg",
                      "jp2": "image/jp2", "j2k": "image/jp2", "avif": "image/avif"}


def check_more_format_decoders(z) -> dict:
    """Phase 22, on the host, for image_formats_more.npz: each file decodes
    to Pillow's mode and pixels (their hash); each letter-page file's host
    ms (the median of DECODE_REPEATS) beside the baseline JPEG's; the
    still-refused files are refused from their headers."""
    import hashlib

    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
    from morphik_core_tpu_torch.utils.image import UnsupportedImage, probe_image, read_image
    from morphik_core_tpu_torch.utils.jpeg import read_jpeg

    decode_ms, sizes = {}, {}
    for name in MORE_FORMAT_FILES + MORE_FORMAT_TIMED:
        key = name.replace(".", "_")
        data = z[key].tobytes()
        if name in MORE_FORMAT_PAST_PILLOW:
            try:
                probe_image(data)
                raise AssertionError(f"{name} was not refused")
            except UnsupportedImage as e:
                if "64 KiB" not in str(e):
                    raise
            decode_ms[name] = _decode_ms(lambda d: read_jpeg(d, pillow_blocks=False), data)
            continue
        t = time.perf_counter()
        pixels, mode, palette = read_image(data)
        ms = (time.perf_counter() - t) * 1e3
        rgb = to_rgb_u8(pixels, mode, palette)
        if mode != str(z[f"{key}_mode"]) or hashlib.sha256(rgb.tobytes()).hexdigest() != str(z[f"{key}_rgb_sha256"]):
            raise AssertionError(f"format fixture {name}: mode {mode} or pixels differ from Pillow's")
        decode_ms[name] = _decode_ms(read_image, data, ms) if name in MORE_FORMAT_TIMED else ms
        sizes[name] = list(rgb.shape[:2])
    for name, words in MORE_FORMAT_REFUSED + ((MORE_FORMAT_UNOPENED, "12-bit JPEG"),):
        try:
            probe_image(z[name.replace(".", "_")].tobytes())
            raise AssertionError(f"{name} was not refused")
        except UnsupportedImage as e:
            if words not in str(e) or "3b-ii" not in str(e):
                raise
    for name in MORE_FORMAT_FAILING:   # refused before: its headers pass, its decode fails as Pillow's load does
        data = z[name.replace(".", "_")].tobytes()
        probe_image(data)
        try:
            read_image(data, "cuda")
        except ValueError:
            continue
        raise AssertionError(f"{name} decoded; Pillow fails it")
    base = decode_ms["letter_baseline.jpg"]
    return {"decode_ms": decode_ms, "page_hw": sizes,
            "letter_over_baseline": {n: decode_ms[n] / base for n in MORE_FORMAT_TIMED if n != "letter_baseline.jpg"}}


def check_jp2_decoders(z, base_ms: float) -> dict:
    """Phase 22, JPEG 2000 on the card: each file of image_formats_jp2.npz
    decodes to Pillow's mode and pixels (their hash); the letter page,
    lossless and 9/7, timed by stage (the median of DECODE_REPEATS, host
    ms with the card synchronized after each stage: headers and tier-2 on
    the host, K5, the DWT and component transforms, Pillow's unpacking)
    beside the baseline JPEG of the same page; the formerly refused HTJ2K-
    and Part-2-flagged files pass their headers and fail their decode, as
    Pillow's load does."""
    import hashlib

    import numpy as np

    from morphik_core_tpu_torch.utils.image import UnsupportedImage, probe_image, read_image
    from morphik_core_tpu_torch.utils.jpeg2000 import read_jpeg2000

    decode_ms = {}
    for name in JP2_FILES + JP2_TIMED:
        key = name.replace(".", "_")
        data = z[key].tobytes()
        t = time.perf_counter()
        pixels, mode, _ = read_image(data, "cuda")
        decode_ms[name] = (time.perf_counter() - t) * 1e3
        if mode != str(z[f"{key}_mode"]) or hashlib.sha256(pixels.tobytes()).hexdigest() != str(z[f"{key}_sha256"]):
            raise AssertionError(f"JPEG 2000 fixture {name}: mode {mode} or pixels differ from Pillow's")
    stages = {}
    for name in JP2_TIMED:
        data = z[name.replace(".", "_")].tobytes()
        runs = []
        for _ in range(DECODE_REPEATS):
            st = {}
            t = time.perf_counter()
            read_jpeg2000(data, "cuda", st)
            st["total_ms"] = (time.perf_counter() - t) * 1e3
            runs.append(st)
        stages[name] = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    for name, _ in JP2_REFUSED:
        data = z[name.replace(".", "_")].tobytes()
        probe_image(data)
        try:
            read_image(data, "cuda")
        except ValueError:
            continue
        raise AssertionError(f"{name} decoded; Pillow fails it")
    return {"decode_ms": decode_ms, "letter_stages_ms": stages, "letter_baseline_jpeg_ms": base_ms,
            "letter_over_baseline": {n: stages[n]["total_ms"] / base_ms for n in JP2_TIMED}}


def check_ht_decoders(z, base_ms: float) -> dict:
    """Phase 22, HTJ2K and Part 2 on the card: each file of
    image_formats_htj2k.npz decodes to Pillow's mode and pixels (their
    hash); the HT letter page timed by stage (the median of
    DECODE_REPEATS, host ms with the card synchronized after each stage:
    headers and tier-2 on the host, K5 (no block here), K6, the DWT and
    component transforms, Pillow's unpacking) beside the baseline JPEG of
    the same page."""
    import hashlib

    import numpy as np

    from morphik_core_tpu_torch.utils.image import read_image
    from morphik_core_tpu_torch.utils.jpeg2000 import read_jpeg2000

    decode_ms = {}
    for name in HT_FILES + HT_TIMED:
        key = name.replace(".", "_")
        data = z[key].tobytes()
        t = time.perf_counter()
        pixels, mode, _ = read_image(data, "cuda")
        decode_ms[name] = (time.perf_counter() - t) * 1e3
        if mode != str(z[f"{key}_mode"]) or hashlib.sha256(pixels.tobytes()).hexdigest() != str(z[f"{key}_sha256"]):
            raise AssertionError(f"HTJ2K fixture {name}: mode {mode} or pixels differ from Pillow's")
    stages = {}
    for name in HT_TIMED:
        data = z[name.replace(".", "_")].tobytes()
        runs = []
        for _ in range(DECODE_REPEATS):
            st = {}
            t = time.perf_counter()
            read_jpeg2000(data, "cuda", st)
            st["total_ms"] = (time.perf_counter() - t) * 1e3
            runs.append(st)
        stages[name] = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    return {"decode_ms": decode_ms, "letter_stages_ms": stages, "letter_baseline_jpeg_ms": base_ms,
            "letter_over_baseline": {n: stages[n]["total_ms"] / base_ms for n in HT_TIMED}}


def formats_phase(torch, model, _kernels, smi):
    """Phase 22: the page image formats on a server from the toml serving
    phase 3b's model. Each file is ingested over HTTP to `completed` as
    its first frame or page, its stored page the reference's q80 payload
    byte for byte; the still-refused JPEGs answer 415 before any document
    exists; WebP and TIFF image queries find their own page first,
    through K1. The same for the files of image_formats_more.npz
    (`MORE_FORMAT_*`): PNM,
    PSD and arithmetic-coded JPEG queries."""
    import base64
    import hashlib

    import numpy as np

    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri

    t_phase = time.perf_counter()
    z = np.load(FORMAT_FIXTURES)
    zm = np.load(MORE_FORMAT_FIXTURES)
    zj = np.load(JP2_FIXTURES)
    zh = np.load(HT_FIXTURES)
    decoders = check_format_decoders(z)
    decoders["more"] = check_more_format_decoders(zm)
    decoders["jp2"] = check_jp2_decoders(zj, decoders["more"]["decode_ms"]["letter_baseline.jpg"])
    decoders["ht"] = check_ht_decoders(zh, decoders["more"]["decode_ms"]["letter_baseline.jpg"])
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_formats_"))
    settings = service_settings(tmp)
    forward_batches = []
    tower = model.embed_image_batch

    def counted_forward(patches, *args, **kw):
        forward_batches.append(int(patches.shape[0]))
        return tower(patches, *args, **kw)

    server = None
    try:
        t0 = time.perf_counter()
        server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
        boot_s = time.perf_counter() - t0
        client = Client(f"http://127.0.0.1:{server.server.port}")
        model.embed_image_batch = counted_forward
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()  # the formats path starts here
        log(f"phase 22: page image formats ({smi}): server up in {boot_s:.3f} s; host decode ms "
            f"{json.dumps({k: round(v, 3) for k, v in decoders['decode_ms'].items()})}; the newer files' "
            f"{json.dumps({k: round(v, 3) for k, v in decoders['more']['decode_ms'].items()})}; JPEG 2000 "
            f"(tier-1 on the card) {json.dumps({k: round(v, 3) for k, v in decoders['jp2']['decode_ms'].items()})}; "
            f"letter page by stage {json.dumps(decoders['jp2']['letter_stages_ms'])}; HTJ2K and Part 2 "
            f"{json.dumps({k: round(v, 3) for k, v in decoders['ht']['decode_ms'].items()})}; HT letter page by "
            f"stage {json.dumps(decoders['ht']['letter_stages_ms'])}")
        # still refused: 415 before any document exists
        refused = [(FORMAT_REFUSED, z[FORMAT_REFUSED.replace(".", "_")].tobytes(), "image/jpeg")]
        refused += [(name, zm[name.replace(".", "_")].tobytes(), MORE_FORMAT_CTYPES[name.rsplit(".", 1)[1]])
                    for name, _ in MORE_FORMAT_REFUSED]
        for name, data, ctype in refused:
            status, raw = client.request("POST", "/ingest/file", *client.multipart(name, data, ctype))
            if status != 415 or b"3b-ii" not in raw:
                raise AssertionError(f"{name} answered {status} {raw[:300]!r}, expected 415")
        if client.call("POST", "/documents", {}):
            raise AssertionError("a refused upload left a document")
        # Image.open fails on these (12-bit JPEGs): the reference stores no page and completes the job
        for name, data in (("twelve.jpg", _twelve_bit(z["wide_baseline_jpg"].tobytes())),
                           (MORE_FORMAT_UNOPENED, zm[MORE_FORMAT_UNOPENED.replace(".", "_")].tobytes())):
            doc = client.upload(name, data, "image/jpeg")["external_id"]
            _wait_completed(client, [doc])
            if client.call("POST", "/batch/chunks", {"sources": [{"document_id": doc, "chunk_number": 0}],
                                                     "use_colpali": True}):
                raise AssertionError(f"{name} left a page")
        # refused before, now accepted: their jobs fail as Pillow's load does, leaving no page
        failing_before, failing, failing_errors = dict(_kernels.launch_counts), {}, {}
        for name, _ in JP2_REFUSED:
            failing[name] = client.upload(name, zj[name.replace(".", "_")].tobytes(), "image/jp2")["external_id"]
        for name, doc in failing.items():
            failing_errors[name] = _wait_failed(client, doc)["error"]
            if "JPEG 2000" not in failing_errors[name]:
                raise AssertionError(f"{name} failed with {failing_errors[name]!r}")
            if client.call("POST", "/batch/chunks", {"sources": [{"document_id": doc, "chunk_number": 0}],
                                                     "use_colpali": True}):
                raise AssertionError(f"{name} left a page")
        failing_launches = {k: v - failing_before[k] for k, v in _kernels.launch_counts.items()}
        ingest_s, docs, fixture_of = {}, {}, {}
        for fx, names, ctypes_ in ((z, FORMAT_FILES, FORMAT_CTYPES), (zm, MORE_FORMAT_FILES, MORE_FORMAT_CTYPES)):
            for name in names:
                t = time.perf_counter()
                doc = client.upload(name, fx[name.replace(".", "_")].tobytes(), ctypes_[name.rsplit(".", 1)[1]])
                ingest_s[name] = _wait_completed(client, [doc["external_id"]]) - t
                docs[name], fixture_of[name] = doc["external_id"], fx
        # JPEG 2000: tier-1 through K5, one launch a decoded image; counted on their own
        jp2_before, jp2_forwards0 = dict(_kernels.launch_counts), len(forward_batches)
        for name in JP2_FILES:
            t = time.perf_counter()
            doc = client.upload(name, zj[name.replace(".", "_")].tobytes(), "image/jp2")
            ingest_s[name] = _wait_completed(client, [doc["external_id"]]) - t
            docs[name], fixture_of[name] = doc["external_id"], zj
        jp2_ingest = {k: v - jp2_before[k] for k, v in _kernels.launch_counts.items()}
        jp2_forwards = len(forward_batches) - jp2_forwards0
        # HTJ2K and Part 2: HT blocks through K6, Part-1 blocks through K5, one launch each a decoded image
        ht_before, ht_forwards0 = dict(_kernels.launch_counts), len(forward_batches)
        for name in HT_FILES:
            t = time.perf_counter()
            doc = client.upload(name, zh[name.replace(".", "_")].tobytes(), HT_CTYPES[name.rsplit(".", 1)[1]])
            ingest_s[name] = _wait_completed(client, [doc["external_id"]]) - t
            docs[name], fixture_of[name] = doc["external_id"], zh
        ht_ingest = {k: v - ht_before[k] for k, v in _kernels.launch_counts.items()}
        ht_forwards = len(forward_batches) - ht_forwards0
        for name in FORMAT_FILES + MORE_FORMAT_FILES + JP2_FILES + HT_FILES:   # one page each (the first frame or page), the reference's
            chunks = client.call("POST", "/batch/chunks", {
                "sources": [{"document_id": docs[name], "chunk_number": k} for k in range(3)], "use_colpali": True})
            if len(chunks) != 1:
                raise AssertionError(f"{name}: {len(chunks)} page chunks stored, expected the first page only")
            payload = base64.b64decode(chunks[0]["content"].split(",", 1)[1])
            if hashlib.sha256(payload).hexdigest() != str(fixture_of[name][name.replace(".", "_") + "_payload_sha256"]):
                raise AssertionError(f"{name}: the stored q80 payload differs from the reference's")
        ingest_launches = dict(_kernels.launch_counts)
        ingest_forwards = len(forward_batches)
        k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        if jp2_ingest["j2k_t1"] != len(JP2_FILES) or jp2_ingest["window_attention"] != k3_per_forward * jp2_forwards:
            raise AssertionError(f"the JPEG 2000 ingests launched {jp2_ingest} over {jp2_forwards} tower forwards: "
                                 f"expected K5 once a file, K3 {k3_per_forward} a forward")
        if (ht_ingest["j2k_ht"], ht_ingest["j2k_t1"]) != (3, 2) or \
                ht_ingest["window_attention"] != k3_per_forward * ht_forwards:
            raise AssertionError(f"the HTJ2K and Part-2 ingests launched {ht_ingest} over {ht_forwards} tower "
                                 f"forwards: expected K6 3 (page.jph, page.j2c, mixed.j2k), K5 2 (mixed.j2k, "
                                 f"part2.jp2), K3 {k3_per_forward} a forward")
        if any(failing_launches[k] for k in ("j2k_t1", "j2k_ht")):
            raise AssertionError(f"the failing JPEG 2000 uploads launched {failing_launches}: they fail on the host")
        if ingest_forwards < 1 or ingest_launches["window_attention"] != k3_per_forward * ingest_forwards:
            raise AssertionError(f"{ingest_forwards} tower forwards, K3 launched "
                                 f"{ingest_launches['window_attention']} times, expected {k3_per_forward} a forward")
        query_ms, k1, top = {}, [], {}
        jp2_query_before = dict(_kernels.launch_counts)
        for fx, name, ctypes_ in ([(z, n, FORMAT_CTYPES) for n in FORMAT_QUERIES]
                                  + [(zm, n, MORE_FORMAT_CTYPES) for n in MORE_FORMAT_QUERIES]
                                  + [(zj, n, {"jp2": "image/jp2", "j2k": "image/jp2"}) for n in JP2_QUERIES]
                                  + [(zh, n, HT_CTYPES) for n in HT_QUERIES]):
            key = name.replace(".", "_")
            uri = bytes_to_data_uri(fx[key].tobytes(), ctypes_[name.rsplit(".", 1)[1]])
            before = _kernels.launch_counts["maxsim_q8"]
            t = time.perf_counter()
            hits = client.call("POST", "/retrieve/chunks", {"query_image": uri, "k": 4})
            query_ms[name] = (time.perf_counter() - t) * 1e3
            k1.append(_kernels.launch_counts["maxsim_q8"] - before)
            own = {d for n, d in docs.items() if fixture_of[n] is fx
                   and int(fx[n.replace(".", "_") + "_page"]) == int(fx[key + "_page"])}
            top[name] = next(n for n, d in docs.items() if d == hits[0]["document_id"])
            if hits[0]["document_id"] not in own:
                raise AssertionError(f"the {name} image query's top-1 is {top[name]}, not a file of its page")
        if min(k1) <= 0:
            raise AssertionError(f"an image query did not launch K1: {k1}")
        jp2_queries = {"k5": _kernels.launch_counts["j2k_t1"] - jp2_query_before["j2k_t1"],
                       "k1": k1[-len(JP2_QUERIES) - len(HT_QUERIES):-len(HT_QUERIES)]}
        ht_queries = {"k6": _kernels.launch_counts["j2k_ht"] - jp2_query_before["j2k_ht"], "k1": k1[-len(HT_QUERIES):]}
        if jp2_queries["k5"] != len(JP2_QUERIES) or ht_queries["k6"] != len(HT_QUERIES):
            raise AssertionError(f"the JPEG 2000 image queries launched K5 {jp2_queries['k5']} times, K6 "
                                 f"{ht_queries['k6']}")
        launches = dict(_kernels.launch_counts)
        if launches["window_attention"] != k3_per_forward * len(forward_batches):   # the queries' forwards too
            raise AssertionError(f"K3 launched {launches['window_attention']} times over {len(forward_batches)} "
                                 f"tower forwards")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        model.embed_image_batch = tower
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": smi, "boot_s": boot_s, "decoders": decoders, "ingest_s": ingest_s,
           "ingest_forwards": ingest_forwards, "tower_forwards": len(forward_batches), "image_query_ms": query_ms,
           "image_query_top1": top, "image_query_k1": k1, "launches": launches, "ingest_launches": ingest_launches,
           "k3_per_forward": k3_per_forward, "peak_memory_gb": peak_gb, "phase_s": time.perf_counter() - t_phase,
           "jp2": {"ingest_launches": jp2_ingest, "ingest_forwards": jp2_forwards, "queries": jp2_queries,
                   "ingest_s": {n: ingest_s[n] for n in JP2_FILES}},
           "ht": {"ingest_launches": ht_ingest, "ingest_forwards": ht_forwards, "queries": ht_queries,
                  "ingest_s": {n: ingest_s[n] for n in HT_FILES}, "failing_errors": failing_errors,
                  "failing_launches": failing_launches}}
    log(f"  JPEG 2000 ingests: launches {jp2_ingest} over {jp2_forwards} tower forwards; image query K5 "
        f"{jp2_queries['k5']}, K1 {jp2_queries['k1']}")
    log(f"  HTJ2K and Part-2 ingests: launches {ht_ingest} over {ht_forwards} tower forwards; JPH image query K6 "
        f"{ht_queries['k6']}, K1 {ht_queries['k1']}; the formerly refused files failed: {json.dumps(failing_errors)}")
    log(f"  ingests to completed (s) {json.dumps({k: round(v, 3) for k, v in ingest_s.items()})}; ingest tower "
        f"forwards {ingest_forwards} (K3 {ingest_launches['window_attention']}); image queries (ms) "
        f"{json.dumps({k: round(v, 3) for k, v in query_ms.items()})}; launches {launches}; peak {peak_gb:.2f} GB; "
        f"phase {out['phase_s']:.3f} s ({smi})")
    return out


# phase 23: text pages in every script the reference draws, right-to-left included
TEXT_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "text_pages.npz"
RTL_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "rtl_pages.npz"
MARK_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "mark_pages.npz"
COMPLEX_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "complex_pages.npz"
NKO_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "nko_pages.npz"
UNICODE17_PAGES_FIXTURE = ROOT / "tests" / "fixtures" / "unicode17_pages.npz"
DOCX_TYPE = "application/vnd.openxmlformats-officedocument.wordprocessingml.document"
PPTX_TYPE = "application/vnd.openxmlformats-officedocument.presentationml.presentation"
TEXT_PAGE_FILES = (  # (fixture, upload name, key, content type)
    ("ltr", "mixed.docx", "docx", DOCX_TYPE), ("ltr", "mixed.pptx", "pptx", PPTX_TYPE),
    ("ltr", "mixed.pdf", "pdf", "application/pdf"),
    ("rtl", "hebrew.docx", "docx", DOCX_TYPE), ("rtl", "arabic.pptx", "pptx", PPTX_TYPE),
    ("rtl", "rtl.pdf", "pdf", "application/pdf"),
    ("marks", "marks.docx", "docx", DOCX_TYPE), ("marks", "vocalized.pptx", "pptx", PPTX_TYPE),
    ("marks", "marks.pdf", "pdf", "application/pdf"),
    ("complex", "indic.docx", "docx", DOCX_TYPE), ("complex", "thai_lao_khmer.pptx", "pptx", PPTX_TYPE),
    ("complex", "complex.pdf", "pdf", "application/pdf"),
    ("nko", "nko.docx", "docx", DOCX_TYPE), ("nko", "nko.pptx", "pptx", PPTX_TYPE),
    ("nko", "nko_arabic_ahom.pdf", "pdf", "application/pdf"),
    ("u17", "tones_emoji.docx", "docx", DOCX_TYPE), ("u17", "new_letters.pptx", "pptx", PPTX_TYPE),
    ("u17", "unicode17.pdf", "pdf", "application/pdf"),
    # refused before: a page 3 of 5 with tone letters in sequence, a page 4 of 4 with Unicode 16's U+1C89
    ("tones", "tone_letters.pdf", "pdf", "application/pdf"), ("u16", "unicode_16.pdf", "pdf", "application/pdf"))
# (fixture, document, payloads, page): the boundary page, the mixed RTL page, a vocalized Arabic slide, the
# Khmer slide, an N'Ko slide, the Garay slide
TEXT_PAGE_QUERIES = (("ltr", "mixed.pdf", "pdf", 2), ("rtl", "rtl.pdf", "pdf", 2),
                     ("marks", "vocalized.pptx", "pptx", 0), ("complex", "thai_lao_khmer.pptx", "pptx", 2),
                     ("nko", "nko.pptx", "pptx", 1), ("u17", "new_letters.pptx", "pptx", 1))
TEXT_PAGE_DPIS = (72, 300)   # servers at these `pdf.colpali_pdf_dpi` store unicode17.pdf's payloads at them
TEXT_PAGE_REFUSED_DPI = 110   # 13 px: a size the atlas lacks
# (TEXT_PAGE_FILES name, the character its error names): the committed atlas draws every text, so a copy of it
# that classes these two MISDRAWN refuses the formerly refused PDFs, and each job must fail and leave no row
TEXT_PAGE_REFUSED = (("tone_letters.pdf", "U+02E9"), ("unicode_16.pdf", "U+1C89"))
TEXT_RENDER_REPEATS = 3


def _fixture_blobs(z, key) -> list:
    """The payloads packed under `key` (bytes laid end to end, `key_sizes`)."""
    import numpy as np

    flat, sizes = z[key].tobytes(), z[f"{key}_sizes"]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [flat[a:b] for a, b in zip(starts, starts[1:])]


def text_render_ms(z, dpi: int = 150, names=None) -> dict:
    """Phase 23, on the host: `render_text_page` ms of a fixture's timing
    pages (one length; Latin-1, Latin, Cyrillic, CJK; Latin-1, Hebrew,
    Arabic; Latin-1, vocalized Arabic, pointed Hebrew; Latin-1,
    Devanagari, Thai, Lao, Khmer; Latin-1, N'Ko, the newer Arabic
    letters; Latin-1, Unicode 15.1-17 letters, tone contours, ZWJ emoji in
    right-to-left paragraphs), or those of `names`, at `dpi`, the median
    of TEXT_RENDER_REPEATS after one untimed render."""
    import numpy as np

    from morphik_core_tpu_torch.parser.text_render import render_text_page

    out = {}
    for name, text in zip(z["timing_names"].tolist(), z["timing_texts"].tolist()):
        if names is not None and name not in names:
            continue
        render_text_page(text, dpi)
        times = []
        for _ in range(TEXT_RENDER_REPEATS):
            t = time.perf_counter()
            render_text_page(text, dpi)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.median(times))
    return out


def _wait_failed(client, doc_id) -> dict:
    """A document's status once it is `failed` and the job queue has run
    its last retry (/health's `pending_jobs` 0): each attempt stores the
    text chunks before it reaches the refused page."""
    deadline = time.perf_counter() + SERVICE_POLL_S
    while True:
        st = client.call("GET", f"/documents/{doc_id}/status")
        if st["status"] == "failed" and client.call("GET", "/health")["pending_jobs"] == 0:
            return st
        if st["status"] == "completed" or time.perf_counter() > deadline:
            raise AssertionError(f"the refused PDF is {st['status']}, expected failed: {st}")
        time.sleep(0.02)


def _row_counts(client) -> tuple:
    """`/health`'s ColPali and text store rows per namespace."""
    components = client.call("GET", "/health")["components"]
    return components["colpali"]["index_rows"], components["text_index_rows"]


def _refusing_atlas(path: Path, letters) -> Path:
    """A copy of the committed glyph atlas with the code points `letters`
    ("U+02E9", ...) classed MISDRAWN, as a probe that found them drawn
    otherwise would class them."""
    import numpy as np

    from morphik_core_tpu_torch.parser import glyph_atlas, text_render

    with np.load(text_render.ATLAS_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    starts, values = arrays["class_starts"], arrays["class_values"]
    classes = values[np.searchsorted(starts, np.arange(0x110000), side="right") - 1]
    classes[[int(letter[2:], 16) for letter in letters]] = text_render.MISDRAWN
    arrays["class_starts"], arrays["class_values"] = glyph_atlas._ranges(classes)
    np.savez(path, **arrays)
    return path


_RASTER_PAGE = []   # raster_pool._raster_page, while phase 23 runs pages through _raster_page_with_atlas


def _raster_page_with_atlas(atlas: str, *args):
    """`raster_pool._raster_page(*args)` drawn with the atlas at `atlas`, in
    whichever process runs it (a raster pool child imports this script and
    takes the atlas from its task)."""
    from morphik_core_tpu_torch.parser import raster_pool, text_render

    if text_render.ATLAS_PATH != Path(atlas):
        text_render.ATLAS_PATH = Path(atlas)
        text_render._load_size.cache_clear()
    return (_RASTER_PAGE[0] if _RASTER_PAGE else raster_pool._raster_page)(*args)


def _refused_jobs(client, fixtures, tmp: Path) -> tuple:
    """Phase 23: the formerly refused PDFs uploaded again while every page
    is drawn with `_refusing_atlas` -> ({name: s to failed}, {name: error}).
    Each job must fail naming its character and item 3b-ii, leave no row in
    the ColPali or the text store, and leave /health's row counts as they
    were. The committed atlas and `_raster_page` are back afterwards; the
    server's raster pool must be shut down before another server draws."""
    import functools

    from morphik_core_tpu_torch.parser import raster_pool, text_render

    atlas = _refusing_atlas(tmp / "refusing_atlas.npz", [letter for _, letter in TEXT_PAGE_REFUSED])
    committed = text_render.ATLAS_PATH
    _RASTER_PAGE.append(raster_pool._raster_page)
    raster_pool._raster_page = functools.partial(_raster_page_with_atlas, str(atlas))
    text_render.ATLAS_PATH = atlas
    text_render._load_size.cache_clear()
    refused_s, refused_errors = {}, {}
    try:
        pdfs = {name: fixtures[fixture][key] for fixture, name, key, _ in TEXT_PAGE_FILES if name in dict(TEXT_PAGE_REFUSED)}
        for name, letter in TEXT_PAGE_REFUSED:
            before = _row_counts(client)
            t = time.perf_counter()
            refused = client.upload(name, pdfs[name].tobytes(), "application/pdf")["external_id"]
            status = _wait_failed(client, refused)
            refused_s[name] = time.perf_counter() - t
            refused_errors[name] = status["error"]
            if "3b-ii" not in status["error"] or letter not in status["error"]:
                raise AssertionError(f"{name} failed with {status['error']!r}")
            for colpali in (True, False):
                if client.call("POST", "/batch/chunks", {"sources": [
                        {"document_id": refused, "chunk_number": k} for k in range(40)], "use_colpali": colpali}):
                    raise AssertionError(f"{name} left rows in the {'ColPali' if colpali else 'text'} store")
            if _row_counts(client) != before:
                raise AssertionError(f"{name}: /health's row counts {_row_counts(client)}, before it {before}")
    finally:
        raster_pool._raster_page = _RASTER_PAGE.pop()
        text_render.ATLAS_PATH = committed
        text_render._load_size.cache_clear()
    return refused_s, refused_errors


def _stored_pages(client, doc_id, n: int) -> list:
    """The payloads a document's ColPali rows hold (up to n + 2 asked)."""
    import base64

    chunks = client.call("POST", "/batch/chunks", {"sources": [
        {"document_id": doc_id, "chunk_number": k} for k in range(n + 2)], "use_colpali": True})
    return [base64.b64decode(c["content"].split(",", 1)[1]) for c in chunks]


def _refused_dpi_build(model, dpi: int) -> str:
    """Phase 23: `build_services` at a `pdf.colpali_pdf_dpi` whose font size
    the atlas lacks -> its error; it must raise `UnsupportedText` naming
    item 3b-ii and leave no row in the database and no index behind."""
    import sqlite3

    from morphik_core_tpu_torch.parser.text_render import UnsupportedText
    from morphik_core_tpu_torch.services_init import build_services

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_text_pages_dpi_"))
    try:
        settings = service_settings(tmp)
        settings.pdf.colpali_pdf_dpi = dpi
        try:
            build_services(settings, colqwen_model=model)
        except UnsupportedText as e:
            error = str(e)
        else:
            raise AssertionError(f"a server built at dpi {dpi}")
        if "3b-ii" not in error or f"dpi {dpi}" not in error:
            raise AssertionError(f"the dpi {dpi} build failed with {error!r}")
        db = Path(settings.database.path)
        if db.exists():
            with sqlite3.connect(db) as con:
                tables = [r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table'")]
                rows = {t: con.execute(f'SELECT COUNT(*) FROM "{t}"').fetchone()[0] for t in tables}
            if any(rows.values()):
                raise AssertionError(f"the dpi {dpi} build left rows {rows}")
        if Path(settings.vector_store.index_path).exists() and any(Path(settings.vector_store.index_path).iterdir()):
            raise AssertionError(f"the dpi {dpi} build left an index")
        return error
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def text_pages_phase(torch, model, _kernels, smi):
    """Phase 23: text pages in every script the reference draws, Hebrew
    and Arabic included, with combining marks placed by the font's GPOS
    anchors, and the complex scripts (Indic, Thai, Lao, Khmer, Myanmar,
    Sinhala, Tibetan, Tifinagh, Syriac, jamo, N'Ko with its joining, the
    Arabic letters newer than FriBiDi's data, Ahom) shaped as HarfBuzz
    shapes them, and the last refusals (tone contours, ZWJ emoji in
    right-to-left paragraphs, Unicode 15.1-17 code points, isolates open
    at paragraph separators, more than 62 bidi controls), on a server from
    the toml serving phase 3b's model. Every stored page is the
    reference's payload byte for byte; an image query of a page finds it
    first (K1); servers at dpi 72 and 300 store the Unicode 17 PDF's
    payloads at those dpis; a build at dpi 110 raises naming item 3b-ii
    and leaves no row behind. Drawn with an atlas that refuses a character
    of each, the two formerly refused PDFs fail naming item 3b-ii and
    leave no row behind."""
    import numpy as np

    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri

    t_phase = time.perf_counter()
    fixtures = {"ltr": np.load(TEXT_PAGES_FIXTURE), "rtl": np.load(RTL_PAGES_FIXTURE),
                "marks": np.load(MARK_PAGES_FIXTURE), "complex": np.load(COMPLEX_PAGES_FIXTURE),
                "nko": np.load(NKO_PAGES_FIXTURE), "u17": np.load(UNICODE17_PAGES_FIXTURE)}
    # the PDFs refused before, with their payloads as the Unicode 17 fixture keeps them
    for key, source, payloads in (("tones", "ltr", "tone_pdf_payloads"), ("u16", "marks", "unicode16_pdf_payloads")):
        fixtures[key] = {"pdf": fixtures[source]["refused_pdf"], "pdf_payloads": fixtures["u17"][payloads],
                         "pdf_payloads_sizes": fixtures["u17"][f"{payloads}_sizes"]}
    render_ms = text_render_ms(fixtures["ltr"])
    for key in ("rtl", "marks", "complex", "nko", "u17"):
        render_ms.update({k: v for k, v in text_render_ms(fixtures[key]).items() if k != "latin1"})
    for dpi in TEXT_PAGE_DPIS:
        render_ms[f"latin1_{dpi}dpi"] = text_render_ms(fixtures["ltr"], dpi, ("latin1",))["latin1"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_text_pages_"))
    settings = service_settings(tmp)
    forward_batches = []
    tower = model.embed_image_batch

    def counted_forward(patches, *args, **kw):
        forward_batches.append(int(patches.shape[0]))
        return tower(patches, *args, **kw)

    server = None
    try:
        t0 = time.perf_counter()
        server = ServerThread(build_services(settings, colqwen_model=model))  # recalibrates static scales
        boot_s = time.perf_counter() - t0
        client = Client(f"http://127.0.0.1:{server.server.port}")
        model.embed_image_batch = counted_forward
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()  # the text pages path starts here
        log(f"phase 23: text pages in every script, right-to-left included ({smi}): server up in {boot_s:.3f} s; "
            f"host render ms a page {json.dumps({k: round(v, 3) for k, v in render_ms.items()})}")
        ingest_s, docs, pages = {}, {}, {}
        for fixture, name, key, ctype in TEXT_PAGE_FILES:
            t = time.perf_counter()
            docs[name] = client.upload(name, fixtures[fixture][key].tobytes(), ctype)["external_id"]
            ingest_s[name] = _wait_completed(client, [docs[name]]) - t
        for fixture, name, key, _ in TEXT_PAGE_FILES:   # the reference's payloads, page for page
            want = _fixture_blobs(fixtures[fixture], f"{key}_payloads")
            got = _stored_pages(client, docs[name], len(want))
            if got != want:
                raise AssertionError(f"{name}: {len(got)} stored pages, {sum(g != w for g, w in zip(got, want))} of "
                                     f"them differ from the reference's {len(want)} payloads")
            pages[name] = len(got)
        ingest_launches = dict(_kernels.launch_counts)
        ingest_forwards = len(forward_batches)
        k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        if ingest_forwards < 1 or ingest_launches["window_attention"] != k3_per_forward * ingest_forwards:
            raise AssertionError(f"{ingest_forwards} tower forwards, K3 launched "
                                 f"{ingest_launches['window_attention']} times, expected {k3_per_forward} a forward")
        query_ms = {}
        for fixture, name, key, page in TEXT_PAGE_QUERIES:
            uri = bytes_to_data_uri(_fixture_blobs(fixtures[fixture], f"{key}_payloads")[page], "image/jpeg")
            before = _kernels.launch_counts["maxsim_q8"]
            t = time.perf_counter()
            hits = client.call("POST", "/retrieve/chunks", {"query_image": uri, "k": 4})
            query_ms[name] = (time.perf_counter() - t) * 1e3
            k1 = _kernels.launch_counts["maxsim_q8"] - before
            if (hits[0]["document_id"], hits[0]["chunk_number"]) != (docs[name], page) or k1 <= 0:
                raise AssertionError(f"the page image query's top-1 is {hits[0]['document_id']}#"
                                     f"{hits[0]['chunk_number']} (K1 {k1}), not {name} page {page}")
        refused_s, refused_errors = _refused_jobs(client, fixtures, tmp)
        server.stop()   # its raster pool's children hold the refusing atlas
        server = None
        # servers at two more of the atlas's sizes store the Unicode 17 PDF's payloads at their dpi
        dpi_s, dpi_pages, boot_k3 = {}, {}, 0
        for dpi in TEXT_PAGE_DPIS:
            dpi_tmp = tmp / f"dpi{dpi}"
            dpi_settings = service_settings(dpi_tmp)
            dpi_settings.pdf.colpali_pdf_dpi = dpi
            t = time.perf_counter()
            before = _kernels.launch_counts["window_attention"]
            server = ServerThread(build_services(dpi_settings, colqwen_model=model))   # recalibrates: K3, no forward
            boot_k3 += _kernels.launch_counts["window_attention"] - before
            dpi_client = Client(f"http://127.0.0.1:{server.server.port}")
            doc = dpi_client.upload("unicode17.pdf", fixtures["u17"]["pdf"].tobytes(), "application/pdf")["external_id"]
            _wait_completed(dpi_client, [doc])
            dpi_s[dpi] = time.perf_counter() - t
            want = _fixture_blobs(fixtures["u17"], f"pdf_payloads_{dpi}")
            got = _stored_pages(dpi_client, doc, len(want))
            if got != want:
                raise AssertionError(f"dpi {dpi}: {len(got)} stored pages, {sum(g != w for g, w in zip(got, want))} "
                                     f"of them differ from the reference's {len(want)} payloads")
            dpi_pages[dpi] = len(got)
            server.stop()
            server = None
        launches = dict(_kernels.launch_counts)
        if launches["window_attention"] - boot_k3 != k3_per_forward * len(forward_batches):   # the queries' too
            raise AssertionError(f"K3 launched {launches['window_attention']} times ({boot_k3} in the dpi servers' "
                                 f"calibration) over {len(forward_batches)} tower forwards")
        refused_error = _refused_dpi_build(model, TEXT_PAGE_REFUSED_DPI)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        model.embed_image_batch = tower
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": smi, "boot_s": boot_s, "render_ms": render_ms,
           "render_over_latin1": {k: v / render_ms["latin1"] for k, v in render_ms.items()},
           "ingest_s": ingest_s, "pages": pages, "ingest_forwards": ingest_forwards,
           "tower_forwards": len(forward_batches), "image_query_ms": query_ms, "refused_s": refused_s,
           "refused_errors": refused_errors, "dpi_ingest_s": dpi_s,
           "dpi_pages": dpi_pages, "dpi_boot_k3": boot_k3, "refused_dpi": TEXT_PAGE_REFUSED_DPI, "refused_error": refused_error,
           "launches": launches, "ingest_launches": ingest_launches, "k3_per_forward": k3_per_forward,
           "peak_memory_gb": peak_gb, "phase_s": time.perf_counter() - t_phase}
    log(f"  ingests to completed (s) {json.dumps({k: round(v, 3) for k, v in ingest_s.items()})}, pages {pages}, "
        f"each the reference's payload; tower forwards {ingest_forwards} (K3 {ingest_launches['window_attention']}); "
        f"page image queries (ms) {json.dumps({k: round(v, 3) for k, v in query_ms.items()})} (top-1 their pages); "
        f"the formerly refused PDFs, drawn with an atlas that refuses {[c for _, c in TEXT_PAGE_REFUSED]}, failed (s) "
        f"{json.dumps({k: round(v, 3) for k, v in refused_s.items()})} naming 3b-ii, no row left in either store; "
        f"servers at dpi {list(TEXT_PAGE_DPIS)} stored the reference's payloads (boot + ingest s "
        f"{json.dumps({k: round(v, 3) for k, v in dpi_s.items()})}, pages {dpi_pages}); a build at dpi "
        f"{TEXT_PAGE_REFUSED_DPI} raised naming 3b-ii and left no row; launches {launches}; peak {peak_gb:.2f} GB; "
        f"phase {out['phase_s']:.3f} s ({smi})")
    return out


# K4 (the binary MaxSim of the binary index) and phases 18-19
BINARY_SYNTH = 16_384  # phase 18: synthetic rows beside the 8 pages (16,392 x 1024 x 16 B = 256 MiB resident)
BINARY_TOKENS = (64, 633)  # their token counts, drawn uniformly: up to the self-query's 632
BINARY_BUCKET = 1024  # BinaryMultiVectorIndex's token_bucket
BINARY_BLOCK = 4096  # its block_rows: a streamed query launches ceil(rows / 4096) times
BINARY_STORE_CHUNK = 1024  # rows generated and stored per store_embeddings call
BINARY_REPEATS = 10  # timed resident queries of each text query and page
POPC_PER_SM_CLOCK = 16  # CUDA C++ Programming Guide, arithmetic instruction throughput,
#                         "population count", compute capability 9.0: results per clock per SM
SCRIPTS_BATCH = 3  # phase 19: export shards of 3 rows (8 pages: 3 shards)
SOAK_S = 10  # phase 19: the soak's traffic window on the 3B model (its backlog drains after it)


def binary_row_lengths(n: int = BINARY_SYNTH, seed: int = SEED + 5):
    """Phase 18's synthetic rows' token counts (phase 2 draws its K4 rows
    from the same law)."""
    import numpy as np

    return np.random.default_rng(seed).integers(*BINARY_TOKENS, n)


def popcount_rate(torch) -> float:
    """The card's popcount rate: SMs x POPC_PER_SM_CLOCK x the max SM clock."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * POPC_PER_SM_CLOCK * mhz * 1e6


def _k4_bound(ntok, nq: int, nb: int, popc_per_s: float) -> dict:
    """K4's least time: the valid doc tokens' bytes + the query + ntok and
    the scores over the HBM rate, against one popcount per u32 word of
    each (query token, valid doc token) pair over the popcount rate. The
    kernel reads only each row's valid tokens, so both count those."""
    rows, tokens = int(len(ntok)), int(ntok.sum())
    bytes_us = (tokens * nb + nq * nb + 8 * rows) / HBM_BYTES_PER_S * 1e6
    ops_us = tokens * nq * (-(-nb // 4)) / popc_per_s * 1e6
    return {"bytes_us": bytes_us, "ops_us": ops_us, "bound_us": max(bytes_us, ops_us),
            "bound_by": "bytes" if bytes_us >= ops_us else "operations"}


def binary_kernel_checks(torch):
    """Phase 2, K4: the binary MaxSim against its plain version on the
    card, bit for bit: phase 18's resident scan (16,392 rows of 1024
    tokens x 16 B, valid prefixes drawn as phase 18's) at 32 query tokens
    and at the self-query's 632, and a ragged edge at dim 16 (2 bytes
    padded to one word, rows without tokens)."""
    import numpy as np

    from morphik_core_tpu_torch.ops import _kernels
    from morphik_core_tpu_torch.ops.binary import binary_maxsim, binary_maxsim_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    rate = popcount_rate(torch)
    log(f"phase 2, K4: popcount rate {rate / 1e12:.3f} T/s ({torch.cuda.get_device_properties(0).multi_processor_count}"
        f" SMs x {POPC_PER_SM_CLOCK} a clock, the CUDA C++ Programming Guide's 'population count' row for compute "
        "capability 9.0, x the max SM clock)")

    def bits(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)

    lengths = binary_row_lengths(n=BATCH + BINARY_SYNTH).astype(np.int32)
    n_rows = len(lengths)
    docs = bits((n_rows, BINARY_BUCKET, 16))
    docs *= (torch.arange(BINARY_BUCKET, device=dev)[None, :] < torch.from_numpy(lengths).to(dev)[:, None])[..., None]
    ntok = torch.from_numpy(lengths).to(dev)
    cases = []
    for nq, plain_iters in ((32, 2), (632, 0)):  # the plain chain: 0.17 s a call at 32 tokens, 3.3 s at 632
        q = bits((nq, 16))
        plan = _kernels.binary_maxsim_plan(nq)
        cases.append(_compare(
            torch, f"K4 resident scan C={n_rows} Nd={BINARY_BUCKET} B=16 NQ={nq} ({plan['threads_per_block']} threads,"
                   f" {plan['query_tokens_per_thread']} query tokens a thread)",
            lambda: binary_maxsim(q, docs, ntok, 128), lambda: binary_maxsim_plain(q, docs, ntok, 128), 0.0, 0.0,
            exact=True, bound=_k4_bound(lengths, nq, 16, rate), plain_iters=plain_iters))
    del docs
    # ragged: dim 16 (2 bytes padded to one u32 word), rows of 0..40 tokens
    lengths = np.random.default_rng(SEED + 6).integers(0, 41, 1000).astype(np.int32)
    lengths[:3] = (0, 40, 1)
    docs_r, q_r, ntok_r = bits((1000, 40, 2)), bits((20, 2)), torch.from_numpy(lengths).to(dev)
    q_r[0] = 0xFF
    ragged = _compare(torch, "K4 ragged dim 16 C=1000 Nd=40 B=2 NQ=20", lambda: binary_maxsim(q_r, docs_r, ntok_r, 16),
                      lambda: binary_maxsim_plain(q_r, docs_r, ntok_r, 16), 0.0, 0.0, exact=True,
                      bound=_k4_bound(lengths, 20, 2, rate))
    if float(binary_maxsim(q_r, docs_r, ntok_r, 16)[0]) != 0.0:
        raise AssertionError("K4: a row without tokens must score exactly 0")
    _deterministic(torch, "K4 ragged dim 16", lambda: binary_maxsim(q_r, docs_r, ntok_r, 16))
    return cases[0], cases + [ragged]


JP2_FIXTURES = ROOT / "tests" / "fixtures" / "image_formats_jp2.npz"
JP2_FILES = ("page.jp2", "page.j2k", "tiled.jp2", "styles.j2k", "gray16.jp2", "ycc.j2k", "palette.jp2", "rgba.jp2")
JP2_TIMED = ("letter.jp2", "letter_97.jp2")  # the 200 dpi letter page, lossless and 9/7, timed by stage
JP2_REFUSED = (("page_ht.j2k", "HTJ2K"), ("part2.jp2", "Part-2"))  # refused before; their jobs fail, as in Pillow
JP2_QUERIES = ("page.jp2",)
JP2_CROP = 128   # phase 2 holds K5 to its plain version on the code blocks of this top-left crop
HT_FIXTURES = ROOT / "tests" / "fixtures" / "image_formats_htj2k.npz"
HT_FILES = ("page.jph", "page.j2c", "mixed.j2k", "part2.jp2")   # HTJ2K (JPH, raw, COC-mixed) and Part 2
HT_TIMED = ("letter_ht.jph",)  # the 200 dpi letter page as HTJ2K, lossless, timed by stage
HT_QUERIES = ("page.jph",)
HT_CTYPES = {"jph": "image/jph", "j2c": "image/jp2", "j2k": "image/jp2", "jp2": "image/jp2"}
# K6 on phase 22's path: one launch a decoded image with HT blocks (page.jph, page.j2c, mixed.j2k
# ingested; part2.jp2 has none) and one for the JPH image query; the formerly refused files fail
# on the host before any launch
HT_K6_PREDICTED = 4
K5_THREADS_NOTE = ("a warp a code block: persistent warps (one a thread block, as many as are resident) take the "
                   "blocks heaviest first from an atomic counter, the block's state in shared memory")


def _k5_bound(blocks) -> dict:
    """K5's least time: its segment bytes, segment table and descriptors
    read once and its coefficients (int32, w x h a block) written once,
    over the HBM rate; it does no arithmetic a peak rate bounds (integer
    MQ decisions, a serial chain within each block), so bytes bound it."""
    import numpy as np

    desc = blocks.desc
    out_bytes = 4 * int((desc[:, 3].astype(np.int64) * desc[:, 4]).sum()) if len(desc) else 0
    moved = blocks.nbytes + 4 * blocks.segs.size + 4 * desc.size + out_bytes
    return dict(_bound(moved, 0, "f32"), bytes=moved)


def _residency(torch, occ: dict, nblocks: int) -> dict:
    """How a launch of `nblocks` code blocks sits on the card: one warp a
    thread block, as many resident as the shared memory allows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = min(nblocks, occ["warps_per_sm"] * sms)
    return {"code_blocks": nblocks, "warps": warps, "resident_warps": occ["warps_per_sm"] * sms,
            "sms_busy": min(warps, sms), "sm_share": min(warps, sms) / sms, "occupancy": occ}


def _one_block(blocks, k: int, ht: bool):
    """Block k of a packing, alone, writing where it wrote."""
    import numpy as np

    from morphik_core_tpu_torch.utils.jpeg2000_ht import HtBlocks
    from morphik_core_tpu_torch.utils.jpeg2000_t1 import Blocks

    d = blocks.desc[k:k + 1].copy()
    if ht:
        size = -(-int(d[0, 3]) // 16) * 16 + 16
        data = np.ascontiguousarray(blocks.data[d[0, 0]:d[0, 0] + size])
        d[0, 0] = 0
        return HtBlocks(data, d)
    size = -(-int(d[0, 11]) // 16) * 16 + 16
    data = np.ascontiguousarray(blocks.data[d[0, 0]:d[0, 0] + size])
    segs = np.ascontiguousarray(blocks.segs[2 * d[0, 1]:2 * (d[0, 1] + d[0, 2])])
    d[0, 0], d[0, 1] = 0, 0
    return Blocks(data, segs if segs.size else np.zeros(2, np.int32), d)


def j2k_t1_kernel_checks(torch):
    """Phase 2, K5: EBCOT tier-1 against its plain version, bit for bit, on
    the code blocks of the top-left JP2_CROP x JP2_CROP of the 550 x 425
    page, lossless (page.j2k) and 9/7 with 3 layers (page.jp2); its device
    time (one replay of a CUDA graph of launches on uploaded inputs) there
    and on every block of the letter page, lossless and 9/7, beside the
    bound, the warps and their residency; the crop's longest chain (its
    block of the most MQ decisions, counted by the plain version) timed
    alone, in ns a decision."""
    import numpy as np

    from morphik_core_tpu_torch.ops import _kernels
    from morphik_core_tpu_torch.utils.jpeg2000 import code_blocks
    from morphik_core_tpu_torch.utils.jpeg2000_t1 import decode_block, j2k_t1_decode, k5_buffers

    z = np.load(JP2_FIXTURES)
    log(f"phase 2, K5: {K5_THREADS_NOTE}")

    def device_ms(blocks, n):
        dev = torch.device("cuda")
        data = torch.from_numpy(blocks.data).to(dev)
        segs = torch.from_numpy(blocks.segs).to(dev)
        desc = torch.from_numpy(np.ascontiguousarray(blocks.desc)).to(dev)
        out = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
        next_block = torch.empty(1, dtype=torch.int32, device=dev)
        buffers = k5_buffers(blocks)

        def launch():
            out.zero_()
            _kernels.launch_j2k_t1(data, segs, desc, out, next_block, len(blocks), buffers)
            return out

        return _graph_ms(torch, launch, 10)

    def occupancy(blocks):
        return _residency(torch, _kernels.j2k_t1_occupancy(k5_buffers(blocks)), len(blocks))

    cases = []
    for name in ("page.j2k", "page.jp2"):
        data = z[name.replace(".", "_")].tobytes()
        blocks, n = code_blocks(data, JP2_CROP)
        t0 = time.perf_counter()
        want = j2k_t1_decode(blocks, n, "cpu")
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = j2k_t1_decode(blocks, n, "cuda")
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            diff = int((got.cpu() != want).sum())
            raise AssertionError(f"K5 on {name}'s {len(blocks)} crop blocks: {diff} coefficients differ from plain")
        err = float((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max()) if n else 0.0
        ms = _time_ms(torch, lambda: j2k_t1_decode(blocks, n, "cuda"), 10)
        dev_ms = device_ms(blocks, n)
        bound = _k5_bound(blocks)
        decisions = []
        buf = blocks.data.tobytes()
        for d in blocks.desc.tolist():   # the plain version's serial chain a block
            counts = {}
            segs = [tuple(blocks.segs[2 * s:2 * s + 2]) for s in range(d[1], d[1] + d[2])]
            decode_block(buf, d[0], segs, d[3], d[4], d[5], d[6], d[7], d[8], counts)
            decisions.append(counts.get("decisions", 0))
        k = int(np.argmax(decisions))
        one = _one_block(blocks, k, False)
        chain_ms = device_ms(one, n)
        chain = {"block": [int(v) for v in blocks.desc[k, 3:5]], "decisions": decisions[k], "device_ms": chain_ms,
                 "ns_per_decision": chain_ms * 1e6 / max(decisions[k], 1), "crop_decisions": int(sum(decisions))}
        case = dict({"case": f"K5 {name} {JP2_CROP} x {JP2_CROP} crop", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "device_ms": dev_ms, "plain_device_ms": None, "longest_chain": chain},
                    **bound, **occupancy(blocks))
        cases.append(case)
        log(f"  {case['case']}: {len(blocks)} blocks bit-identical to plain; kernel_ms={ms:.5f} (upload, launch, "
            f"sync) device_ms={dev_ms:.5f} plain_ms={plain_ms:.3f} (host Python) bound_us={bound['bound_us']:.3f} "
            f"({bound['bytes']} bytes); longest chain {json.dumps(chain)}; geometry "
            f"{json.dumps(occupancy(blocks))}")
    letter = {}
    for name in JP2_TIMED:
        blocks, n = code_blocks(z[name.replace(".", "_")].tobytes())
        bound = _k5_bound(blocks)
        letter[name] = dict({"device_ms": device_ms(blocks, n)}, **bound, **occupancy(blocks))
        log(f"  K5 {name} (1700 x 2200, every block): device_ms={letter[name]['device_ms']:.5f} "
            f"bound_us={bound['bound_us']:.3f} {json.dumps(occupancy(blocks))}")
    cases[0]["letter"] = letter
    return cases[0], cases


def _k6_bound(blocks) -> dict:
    """K6's least time: its blocks' segment bytes, the two VLC tables and
    the descriptors read once and their coefficients (int32, w x h a
    block) written once, over the HBM rate; its arithmetic (table look-ups
    and bit shifts, a serial chain within each block) no peak rate bounds,
    so bytes bound it."""
    import numpy as np

    desc = blocks.desc[blocks.desc[:, 4] > 0]
    out_bytes = 4 * int((desc[:, 5].astype(np.int64) * desc[:, 6]).sum())
    moved = int(desc[:, 3].astype(np.int64).sum()) + 2 * 2 * 1024 + 4 * desc.size + out_bytes
    return dict(_bound(moved, 0, "f32"), bytes=moved)


def j2k_ht_kernel_checks(torch, k5_letter: dict):
    """Phase 2, K6: HTJ2K block decoding against its plain version, bit for
    bit, on the HT code blocks of the top-left JP2_CROP x JP2_CROP of the
    550 x 425 pages, lossless (page.j2c, cleanup passes) and 9/7 (page.jph,
    with SigProp and MagRef); its device time (one replay of a CUDA graph
    of launches on uploaded inputs) there and on every block of the HT
    letter page, beside K5's on the Part-1 letter page, the bound, the
    warps and their residency; the crop's longest chain (its block of the
    most quads and SigProp / MagRef bits, counted by the plain version)
    timed alone, in ns a quad or bit."""
    import numpy as np

    from morphik_core_tpu_torch.ops import _kernels
    from morphik_core_tpu_torch.utils.jpeg2000 import code_blocks
    from morphik_core_tpu_torch.utils.jpeg2000_ht import decode_ht_block, j2k_ht_decode, k6_buffers

    z = np.load(HT_FIXTURES)
    log(f"phase 2, K6: {K5_THREADS_NOTE}; MagSgn a quad a lane, MagRef a column a lane")

    def device_ms(blocks, n):
        dev = torch.device("cuda")
        live = blocks.desc[:, 4] > 0
        data = torch.from_numpy(blocks.data).to(dev)
        desc = torch.from_numpy(np.ascontiguousarray(blocks.desc[live])).to(dev)
        out = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
        next_block = torch.empty(1, dtype=torch.int32, device=dev)
        errors = torch.zeros(max(int(live.sum()), 1), dtype=torch.int32, device=dev)
        buffers = k6_buffers(blocks)

        def launch():
            out.zero_()
            _kernels.launch_j2k_ht(data, desc, out, next_block, errors, int(live.sum()), buffers)
            return out

        ms = _graph_ms(torch, launch, 10)
        if int(errors.abs().sum()):
            raise AssertionError("K6 reported a malformed block in a timed launch")
        return ms

    def occupancy(blocks):
        return _residency(torch, _kernels.j2k_ht_occupancy(k6_buffers(blocks)), int((blocks.desc[:, 4] > 0).sum()))

    cases = []
    for name in ("page.j2c", "page.jph"):
        data = z[name.replace(".", "_")].tobytes()
        blocks, n = code_blocks(data, JP2_CROP, ht=True)
        t0 = time.perf_counter()
        want = j2k_ht_decode(blocks, n, "cpu")
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = j2k_ht_decode(blocks, n, "cuda")
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            diff = int((got.cpu() != want).sum())
            raise AssertionError(f"K6 on {name}'s {len(blocks)} crop blocks: {diff} coefficients differ from plain")
        err = float((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max()) if n else 0.0
        ms = _time_ms(torch, lambda: j2k_ht_decode(blocks, n, "cuda"), 10)
        dev_ms = device_ms(blocks, n)
        bound = _k6_bound(blocks)
        passes = np.bincount(blocks.desc[:, 4], minlength=4)[1:].tolist()
        work, buf = [], blocks.data.tobytes()
        for d in blocks.desc.tolist():   # the plain version's serial work a block
            counts = {}
            if d[4]:
                decode_ht_block(buf, d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], 0, d[9], counts)
            work.append(counts)
        k = int(np.argmax([sum(c.values()) for c in work]))
        chain_ms = device_ms(_one_block(blocks, k, True), n)
        units = sum(work[k].values())
        chain = dict({"block": [int(v) for v in blocks.desc[k, 5:7]], "device_ms": chain_ms,
                      "ns_per_quad_or_bit": chain_ms * 1e6 / max(units, 1)}, **work[k])
        case = dict({"case": f"K6 {name} {JP2_CROP} x {JP2_CROP} crop", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "device_ms": dev_ms, "plain_device_ms": None,
                     "blocks_by_passes": passes, "longest_chain": chain}, **bound, **occupancy(blocks))
        cases.append(case)
        log(f"  {case['case']}: {len(blocks)} blocks ({passes} of 1, 2, 3 passes) bit-identical to plain; "
            f"kernel_ms={ms:.5f} (upload, launch, sync) device_ms={dev_ms:.5f} plain_ms={plain_ms:.3f} (host Python) "
            f"bound_us={bound['bound_us']:.3f} ({bound['bytes']} bytes); longest chain {json.dumps(chain)}; "
            f"geometry {json.dumps(occupancy(blocks))}")
    letter = {}
    for name in HT_TIMED:
        blocks, n = code_blocks(z[name.replace(".", "_")].tobytes(), ht=True)
        bound = _k6_bound(blocks)
        letter[name] = dict({"device_ms": device_ms(blocks, n)}, **bound, **occupancy(blocks))
        log(f"  K6 {name} (1700 x 2200, every block): device_ms={letter[name]['device_ms']:.5f} "
            f"bound_us={bound['bound_us']:.3f} {json.dumps(occupancy(blocks))}; K5 on the Part-1 letter pages "
            f"{json.dumps({k: round(v['device_ms'], 5) for k, v in k5_letter.items()})} ms")
    cases[0]["letter"] = letter
    cases[0]["k5_letter_device_ms"] = {k: v["device_ms"] for k, v in k5_letter.items()}
    return cases[0], cases


def _binary_answer(hits):
    return [(c.document_id, c.score) for c in hits]


def binary_phase(torch, page_embs, queries, _kernels, smi):
    """Phase 18: the binary index on the card at a real size, through the
    store a user builds (`TorchMultiVectorStore(provider="binary")`): phase
    3b's 8 pages and BINARY_SYNTH seeded rows (256 MiB of resident bits,
    far inside the 4 GiB budget), phase 5's text queries and a self-query
    of each page, the same queries streamed in blocks, a filter and a
    delete; then a dual store over a new fde store and this one."""
    import asyncio

    import numpy as np

    from morphik_core_tpu_torch.models.schemas import DocumentChunk
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.vector_store.dual_multivector_store import DualMultiVectorStore
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

    t_phase = time.perf_counter()
    loop = asyncio.new_event_loop()  # one loop for every store call, as a server has
    run = loop.run_until_complete
    torch.cuda.reset_peak_memory_stats()  # the resident 3B model counts in the peak
    store = TorchMultiVectorStore(fde_config=FDEConfig(), provider="binary", device="cuda")

    def chunk(doc, mv):
        return DocumentChunk(document_id=doc, chunk_number=0, content=doc, embedding=mv, metadata={})

    pages = [np.asarray(e, np.float32) for e in page_embs]
    t0 = time.perf_counter()
    run(store.store_embeddings([chunk(f"page{i}", mv) for i, mv in enumerate(pages)]))
    rng = np.random.default_rng(SEED + 5)
    lengths = binary_row_lengths()
    for s in range(0, BINARY_SYNTH, BINARY_STORE_CHUNK):  # seeded sign patterns, generated and packed in chunks
        rows = []
        for i in range(s, min(s + BINARY_STORE_CHUNK, BINARY_SYNTH)):
            signs = np.unpackbits(rng.integers(0, 256, (int(lengths[i]), 16), dtype=np.uint8), axis=1)
            rows.append(chunk(f"synth{i}", signs.astype(np.float32) - 0.5))
        run(store.store_embeddings(rows))
    store_s = time.perf_counter() - t0
    index = store._ns(None)
    n_rows = BATCH + BINARY_SYNTH
    resident_mb = n_rows * index.token_bucket * (index.dim // 8) / 2**20
    if len(index) != n_rows:
        raise AssertionError(f"binary store holds {len(index)} rows, expected {n_rows}")

    def ask(q, **kw):
        return _binary_answer(run(store.query_similar(q, k=10, **kw)))

    texts = [np.asarray(q, np.float32) for q in queries[: len(QUERIES)]]
    _kernels.reset_launch_counts()
    lat, resident = [], []
    for rep in range(BINARY_REPEATS):
        for q in texts + pages:
            t0 = time.perf_counter()
            got = ask(q)
            lat.append((time.perf_counter() - t0) * 1e3)
            if rep == 0:
                resident.append(got)
            elif got != resident[len(lat) - 1 - rep * len(texts + pages)]:
                raise AssertionError("a repeated binary query changed its answer")
    launches_resident = _kernels.launch_counts["binary_maxsim"]
    if launches_resident != BINARY_REPEATS * (len(texts) + len(pages)) or index._device_count != n_rows:
        raise AssertionError(f"resident queries launched K4 {launches_resident} times "
                             f"(device rows {index._device_count})")
    for i, (mv, got) in enumerate(zip(pages, resident[len(texts):])):
        if got[0] != (f"page{i}", float(len(mv))):
            raise AssertionError(f"page {i} self-query: {got[:2]} (expected score {len(mv)} first)")
    # the same queries with the budget under the resident size: blocks of rows stream
    budget = index.device_budget_bytes
    index.device_budget_bytes = int(resident_mb * 2**20) // 2
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streamed = [ask(q) for q in texts + pages]
    streamed_ms = (time.perf_counter() - t0) * 1e3 / len(streamed)
    launches_streamed = _kernels.launch_counts["binary_maxsim"]
    index.device_budget_bytes = budget
    want_launches = len(streamed) * -(-n_rows // BINARY_BLOCK)
    if streamed != resident or launches_streamed != want_launches:
        raise AssertionError(f"streamed answers differ from resident ones, or K4 {launches_streamed} != "
                             f"{want_launches} launches")
    # a doc_ids filter and a delete
    allowed = ["page2", "page5", "synth7", "synth9000"]
    filtered = ask(pages[5], doc_ids=allowed)
    if filtered[0][0] != "page5" or {d for d, _ in filtered} - set(allowed):
        raise AssertionError(f"filtered query: {filtered}")
    run(store.delete_chunks_by_document_id("page3"))
    after = ask(pages[3])
    if "page3" in [d for d, _ in after] or len(index) != n_rows - 1:
        raise AssertionError(f"page3 survived its delete: {after[:3]}")
    store.save()  # a no-op for the binary index
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a dual store: a new fde store (primary) and this binary store take the same writes
    fde_store = TorchMultiVectorStore(fde_config=FDEConfig(), device="cuda")
    dual = DualMultiVectorStore(fde_store, store)
    run(dual.store_embeddings([chunk(f"dual{i}", mv) for i, mv in enumerate(pages)]))
    for i, q in enumerate(pages):
        a = run(dual.query_similar(q, k=5))
        b = run(fde_store.query_similar(q, k=5))
        if [(c.document_id, c.score) for c in a] != [(c.document_id, c.score) for c in b] or a[0].document_id != f"dual{i}":
            raise AssertionError(f"dual store read of page {i} differs from its primary's")
        top = ask(q)[:2]  # page{i} and dual{i} hold the same bits and tie (page3 is deleted)
        if top[0][1] != float(len(q)) or f"dual{i}" not in [d for d, _ in top]:
            raise AssertionError(f"the binary side of the dual store lacks page {i}: {top}")
    loop.close()
    out = {
        "rows": n_rows, "resident_mib": resident_mb, "store_s": store_s, "store_rows_per_s": n_rows / store_s,
        "query_ms": _percentiles(lat), "streamed_query_ms": streamed_ms,
        "launches": {"binary_maxsim": launches_resident + launches_streamed}, "launches_resident": launches_resident,
        "launches_streamed": launches_streamed, "page_tokens": [len(p) for p in pages],
        "text_top": [r[0] for r in resident[: len(texts)]], "peak_gb": peak_gb,
        "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"phase 18: binary index on the card ({smi}): {n_rows} rows ({resident_mb:.0f} MiB resident) stored in "
        f"{store_s:.3f} s ({out['store_rows_per_s']:.0f} rows/s); query p50 / p99 {out['query_ms']['p50_ms']:.3f} / "
        f"{out['query_ms']['p99_ms']:.3f} ms ({len(lat)} resident, K4 {launches_resident}), streamed "
        f"{streamed_ms:.3f} ms a query (K4 {launches_streamed} = {len(streamed)} x {-(-n_rows // BINARY_BLOCK)}), "
        f"the same ids and score bits; 8 self-queries first at their token counts; filter, delete, dual store ok; "
        f"peak {peak_gb:.2f} GB; phase {out['phase_s']:.3f} s")
    return out


def _scripts_config(tmp: Path, index_path: Path, fde=(20, 5, 16)) -> Path:
    """A deployment's toml: the 3B width, local storage and the database in
    `tmp`, the index at `index_path` with FDE (repetitions, SimHash
    projections, projection dimension)."""
    cfg = tmp / f"cfg_{index_path.name}_{'_'.join(map(str, fde))}.toml"
    cfg.write_text(f'[model]\nembedding_dim = 128\n[database]\npath = "{tmp / "morphik.db"}"\n'
                   f'[storage]\nprovider = "local"\nstorage_path = "{tmp / "storage"}"\n'
                   f'[vector_store]\nindex_path = "{index_path}"\nfde_num_repetitions = {fde[0]}\n'
                   f'fde_num_simhash_projections = {fde[1]}\nfde_projection_dimension = {fde[2]}\n')
    return cfg


def _script(main, *argv):
    """-> (exit code, standard output) of a twin's main on the card."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([*argv, "--device", "cuda"])
    return rc, buf.getvalue()


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def scripts_phase(torch, model, page_embs, _kernels, smi):
    """Phase 19: the operator scripts' port twins on the card, over a small
    deployment built from phase 18's pages through the port's services (a
    database, local storage with the page payloads, an fde index), then the
    soak on the 3B model."""
    import asyncio

    import numpy as np

    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
    from morphik_core_tpu_torch.index.multivector_index import MultiVectorIndex
    from morphik_core_tpu_torch.models.schemas import AuthContext, Document, DocumentChunk
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.scripts import (
        check_completeness, export_chunks_resumable, migrate_index_format, migrate_store_provider, purge_app,
        rebuild_fde, scrub_metadata, soak_serving,
    )
    from morphik_core_tpu_torch.services_init import build_storage
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.png import encode_png
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scripts_"))
    out = {"card": smi}
    try:
        index_root = tmp / "storage" / "index"
        cfg = _scripts_config(tmp, index_root)
        settings = load_settings(cfg)
        pages = [np.asarray(e, np.float32) for e in page_embs]
        pngs = [encode_png(p) for p in service_pages()[: len(pages)]]
        docs = [f"doc{i}" for i in range(len(pages) // 2)]  # two pages a document
        # the deployment: payloads, index rows and documents as ingest lays them out. The documents
        # belong to the developer "migration", the one migrate_store_provider lists (both packages)
        storage = build_storage(settings)
        store = TorchMultiVectorStore(storage=storage, fde_config=export_chunks_resumable.fde_config_from(settings),
                                      index_path=index_root, device="cuda")
        db = SQLiteDatabase(settings.database.path)
        auth = AuthContext(entity_id="migration", permissions={"read", "write"})

        async def build():
            await db.initialize()
            chunks = [DocumentChunk(document_id=docs[i // 2], chunk_number=i % 2, embedding=mv,
                                    content=bytes_to_data_uri(pngs[i], "image/png"),
                                    metadata={"is_image": True, "external_id": docs[i // 2], "secret": f"s{i}"})
                      for i, mv in enumerate(pages)]
            await store.store_embeddings(chunks)
            for j, doc in enumerate(docs):
                await storage.upload_file(pngs[2 * j], f"ingest/{doc}/page.png")
                d = Document(content_type="image/png", external_id=doc, filename="page.png",
                             metadata={"external_id": doc, "secret": f"s{j}", "title": f"Page {j}"},
                             storage_info={"bucket": "", "key": f"ingest/{doc}/page.png"},
                             chunk_ids=[f"{doc}-0", f"{doc}-1"])
                d.system_metadata["status"] = "completed"
                await db.store_document(d, auth)
        asyncio.run(build())
        store.save()
        db.close()
        del store

        # check_completeness: consistent; --gc-apply with an empty index root is refused
        rc_check, text = _script(check_completeness.main, "--config", str(cfg))
        rep = json.loads(text)
        if rc_check != 0 or not rep["consistent"] or rep["namespaces"] != {"default": {"index_rows": 8,
                                                                                     "index_docs": 4}}:
            raise AssertionError(f"check_completeness: rc {rc_check} {rep}")
        (tmp / "empty_index").mkdir()
        payloads = _tree(tmp / "storage" / "multivector-chunks")
        rc, text = _script(check_completeness.main, "--config", str(_scripts_config(tmp, tmp / "empty_index")),
                           "--gc-apply")
        refused = json.loads(text)
        if rc != 2 or "gc_refused" not in refused or len(refused["gc_plan"]["orphan_payload_objects"]) != 8 \
                or _tree(tmp / "storage" / "multivector-chunks") != payloads:
            raise AssertionError(f"--gc-apply on an empty index root was not refused: rc {rc} {refused}")
        out["check_completeness"] = {"rc": rc_check, "consistent": rep["consistent"], "gc_refused_rc": rc,
                                     "planned_payloads": len(refused["gc_plan"]["orphan_payload_objects"])}
        # scrub_metadata: a dry run, then apply
        keep = ["--keep", "external_id,title", "--batch", "2"]
        rc, text = _script(scrub_metadata.main, "--config", str(cfg), *keep, "--dry-run-index")
        dry = json.loads(text)
        rc2, text = _script(scrub_metadata.main, "--config", str(cfg), *keep, "--apply")
        applied = json.loads(text)
        if (rc, rc2) != (0, 0) or dry != {"documents_scrubbed": 4, "index_records_scrubbed": 8, "applied": False} \
                or applied != dict(dry, applied=True):
            raise AssertionError(f"scrub_metadata: {dry} then {applied}")
        out["scrub_metadata"] = applied
        # export: one run, and a run interrupted after its first shard, then resumed: the same bytes
        one, two = tmp / "export_one", tmp / "export_two"
        args = ["--config", str(cfg), "--batch", str(SCRIPTS_BATCH)]
        t0 = time.perf_counter()
        rc, text = _script(export_chunks_resumable.main, *args, "--out", str(one))
        export_s = time.perf_counter() - t0
        _script(export_chunks_resumable.main, *args, "--out", str(two))
        (two / "checkpoint.json").write_text(json.dumps({"default": SCRIPTS_BATCH}))
        for p in [*(two / "default").glob("shard_0000[1-9].*"), two / "default" / "manifest.json"]:
            p.unlink()
        rc2, _ = _script(export_chunks_resumable.main, *args, "--out", str(two))
        if (rc, rc2) != (0, 0) or json.loads(text)["exported"] != 8 or _tree(one) != _tree(two):
            raise AssertionError(f"export: rc {rc} / {rc2}, {text}; resumed bytes equal: {_tree(one) == _tree(two)}")
        out["export"] = {"rows": 8, "shards": len(list((one / "default").glob("*.npy"))), "s": export_s,
                         "resumed_identical": True}
        # rebuild_fde under another FDE config: the reopened index answers, a self-query first
        new_fde = (10, 4, 8)
        t0 = time.perf_counter()
        rc, _ = _script(rebuild_fde.main, "--index-path", str(index_root), "--dimension", "128",
                        "--num-repetitions", str(new_fde[0]), "--num-simhash-projections", str(new_fde[1]),
                        "--projection-dimension", str(new_fde[2]))
        rebuild_s = time.perf_counter() - t0
        new_cfg = FDEConfig(dimension=128, num_repetitions=new_fde[0], num_simhash_projections=new_fde[1],
                            projection_dimension=new_fde[2])
        idx = MultiVectorIndex(new_cfg, path=index_root / "default", device="cuda")
        top = idx.query(pages[5], k=3)[0][0]
        if rc != 0 or len(idx) != 8 or (top.document_id, top.chunk_number) != ("doc2", 1):
            raise AssertionError(f"rebuild_fde: rc {rc}, {len(idx)} rows, self-query top {top}")
        del idx
        cfg = _scripts_config(tmp, index_root, new_fde)  # the deployment's config follows its index
        out["rebuild_fde"] = {"rc": rc, "s": rebuild_s, "fde": new_fde}
        # migrate_index_format: a legacy snapshot of the pages
        legacy = index_root / "legacy"
        (legacy / "multivectors").mkdir(parents=True)
        recs = []
        for i, mv in enumerate(pages):
            np.save(legacy / "multivectors" / f"{i}.npy", mv.astype(np.float16))
            recs.append({"document_id": f"legacy{i}", "chunk_number": 0, "metadata": {}, "content_key": None,
                         "n_tokens": len(mv), "alive": True})
        np.save(legacy / "fde.npy", MultiVectorIndex(new_cfg, device="cuda").encode_documents(pages))
        (legacy / "meta.json").write_text(json.dumps({"count": len(pages), "fde": {}, "records": recs}))
        rc, text = _script(migrate_index_format.main, "--index-path", str(index_root), "--namespace", "legacy",
                           "--dimension", "128", "--num-repetitions", str(new_fde[0]), "--num-simhash-projections",
                           str(new_fde[1]), "--projection-dimension", str(new_fde[2]), "--query-smoke")
        if rc != 0 or "legacy: migrated 8 rows" not in text or (legacy / "meta.json").exists():
            raise AssertionError(f"migrate_index_format: rc {rc} {text}")
        out["migrate_index_format"] = {"rc": rc, "rows": 8}
        # migrate_store_provider fde -> fde keeps every row; --to binary is refused
        (index_root / "provider_fde").mkdir()
        (index_root / "default").rename(index_root / "provider_fde" / "default")
        before = MultiVectorIndex(new_cfg, path=index_root / "provider_fde" / "default", device="cpu")
        rows_before = {(r.document_id, r.chunk_number): before.get_multivector(r.document_id, r.chunk_number)
                       for r in before.records}
        rc, text = _script(migrate_store_provider.main, "--config", str(cfg), "--from", "fde", "--to", "fde",
                           "--checkpoint", str(tmp / "migration.json"))
        after = MultiVectorIndex(new_cfg, path=index_root / "provider_fde" / "default", device="cpu")
        same = len(after) == 8 and all(np.array_equal(after.get_multivector(*key), mv) for key, mv in rows_before.items())
        rc_b, _ = _script(migrate_store_provider.main, "--config", str(cfg), "--from", "fde", "--to", "binary",
                          "--checkpoint", str(tmp / "migration_binary.json"))
        if rc != 0 or "migrated=4 " not in text or not same or rc_b != 2 or (tmp / "migration_binary.json").exists():
            raise AssertionError(f"migrate_store_provider: rc {rc} {text!r} rows kept {same}; --to binary rc {rc_b}")
        out["migrate_store_provider"] = {"rc": rc, "documents": 4, "rows_kept": same, "to_binary_rc": rc_b}
        # purge_app: the default app everywhere
        rc, text = _script(purge_app.main, "--config", str(cfg), "--app-id", "default", "--yes")
        purged = _json_docs(text)[-1]["purged"]
        left = [k for k in _tree(tmp / "storage") if k.startswith(("multivector-chunks/default/", "ingest/"))]
        if rc != 0 or purged["db_rows"] != 4 or purged["payload_objects"] != 8 or left:
            raise AssertionError(f"purge_app: rc {rc} {purged}, left {left}")
        out["purge_app"] = purged
        # the soak on the 3B model: two ingesters, two queriers
        _kernels.reset_launch_counts()
        soak = asyncio.run(soak_serving.run_soak(SOAK_S, str(tmp / "soak"), device="cuda",
                                                 settings=service_settings(tmp / "soak"), colqwen_model=model))
        soak["launches"] = dict(_kernels.launch_counts)
        if not soak_serving.passed(soak) or soak["ingest"] <= 0 or soak["query"] <= 0:
            raise AssertionError(f"soak failed its rule: {soak}")
        out["soak"] = dict(soak, seconds=SOAK_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: the operator scripts on the card ({smi}): check_completeness consistent, --gc-apply on an "
        f"empty index root refused (rc 2, nothing deleted); scrub {out['scrub_metadata']}; export "
        f"{out['export']['shards']} shards in {out['export']['s']:.3f} s, resumed byte-identical; rebuild_fde "
        f"{out['rebuild_fde']['s']:.3f} s; legacy migrated; fde -> fde kept 8 rows, --to binary refused; purge "
        f"{out['purge_app']}; soak {SOAK_S} s: {json.dumps(out['soak'])}; phase {out['phase_s']:.3f} s")
    return out


EVALS_COLPALI = ["--small"]  # phase 20: 5 docs x 4 pages, 8 probes, the three-rung ladder


def evals_phase(torch, _kernels, smi):
    """Phase 20: the evaluation harnesses and the measuring twins on the
    card at their small sizes: the fidelity gate's Part A at the 3B width
    with the small counts (24 pages, 8 queries; K3 in the tower, K1 in the
    rerank and the score matrix) and Part B at 100,000 rows, colpali_eval
    `--small` on the trained fixture, the offline RAG eval's builtin
    corpus, profile_int8's matmul families at the 3B shapes and
    bench_ingest `--small`. A harness that raises fails the run; the
    gate's verdict is reported, not checked."""
    import asyncio
    import math

    from morphik_core_tpu_torch.evaluations import colpali_eval, fidelity_eval, run_offline_eval
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.scripts import bench_ingest, profile_int8

    t_phase = time.perf_counter()
    out = {"card": smi}
    _kernels.reset_launch_counts()  # phase 20 starts here
    t0 = time.perf_counter()
    part_a = fidelity_eval.part_a_ranking_agreement(False, "cuda", counts=(24, 8))
    part_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    part_b = fidelity_eval.part_b_fde_recall_at_scale(False, "cuda")
    part_b_s = time.perf_counter() - t0
    report = {"part_a_ranking_agreement": part_a, "part_b_fde_recall_at_scale": part_b}
    metrics = [part_a[k] for k in ("top1_match", "score_pearson", "top10_margin_agreement", "jaccard_at_10")]
    if part_a["geometry"] != "3b" or part_a["n_pages"] != 24 or part_b["n_docs"] != 100_000 \
            or not all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in metrics):
        raise AssertionError(f"fidelity_eval: {report}")
    out["fidelity"] = dict(report, gate={"thresholds": fidelity_eval.GATE,
                                         "int8_default_approved": fidelity_eval.gate_verdict(report)},
                           part_a_s=part_a_s, part_b_s=part_b_s, launches=dict(_kernels.launch_counts))
    t0 = time.perf_counter()
    colpali = asyncio.run(colpali_eval.run_eval(colpali_eval.parse_args(EVALS_COLPALI), device="cuda"))
    if colpali["visual_ladder"]["identity"]["recall_at_10"] != 1.0 or colpali["corpus"]["total_pages"] != 20:
        raise AssertionError(f"colpali_eval: {colpali}")
    out["colpali_eval"] = dict(colpali, s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as corpus:
        for name, text in run_offline_eval.BUILTIN_CORPUS.items():
            (Path(corpus) / name).write_text(text)
        offline = asyncio.run(run_offline_eval.run_eval(Path(corpus), run_offline_eval.BUILTIN_QUESTIONS, False,
                                                        device="cuda"))
    if offline["recall_at_4"] != 1.0 or offline["n_questions"] != 3:
        raise AssertionError(f"run_offline_eval: {offline}")
    out["offline_eval"] = dict(offline, s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfg = ColQwenConfig()
    methods = {}
    fam = profile_int8.matmul_families(torch, torch.device("cuda"), cfg, 8 * 20 * 28 * cfg.vision.merge_unit,
                                       8 * (20 * 28 + 5), methods)
    out["profile_families"] = {"families": fam, "timing": sorted(set(methods.values())),
                               "dyn_quant_cost_ms": sum(f["step_q8_ms"] - f["step_q8_prequant_ms"]
                                                        for f in fam.values()),
                               "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ingest = bench_ingest.run_bench(3, 4, True, device="cuda")
    if ingest["pages"] != 12 or not ingest["value"] > 0:
        raise AssertionError(f"bench_ingest: {ingest}")
    out["bench_ingest"] = dict(ingest, s=time.perf_counter() - t0)
    out["launches"] = dict(_kernels.launch_counts)  # and ends here
    if out["launches"]["maxsim_q8"] <= 0 or out["launches"]["window_attention"] <= 0:
        raise AssertionError(f"phase 20 did not launch K1 and K3: {out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: the evals and the measuring twins on the card ({smi}): fidelity gate "
        f"{out['fidelity']['gate']['int8_default_approved']} (part A {part_a_s:.1f} s: top1 {part_a['top1_match']}, "
        f"pearson {part_a['score_pearson']:.4f}, margin {part_a['top10_margin_agreement']}; part B {part_b_s:.1f} s: "
        f"delta {part_b['int8_recall_delta_at_75']}); colpali ladder {json.dumps(colpali['visual_ladder'])}; "
        f"offline {offline}; dyn quant cost {out['profile_families']['dyn_quant_cost_ms']:.2f} ms; ingest "
        f"{ingest['value']} pages/s; launches {out['launches']}; phase {out['phase_s']:.3f} s")
    return out


def mesh_rows(torch, n: int, seed: int = SEED + 7):
    """n unit f16 rows of MESH_SYNTH_TOKENS tokens, drawn on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens = torch.randint(*MESH_SYNTH_TOKENS, (n,), generator=gen, device="cuda").tolist()
    out = []
    for n_tok in lens:
        x = torch.randn((n_tok, 128), generator=gen, device="cuda")
        out.append((x / x.norm(dim=1, keepdim=True)).half().cpu().numpy())
    return out


def _peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def mesh_phase(torch, model, page_embs, rows, page_fdes, queries5, phase8_answers, phase8_scales, _kernels, smi):
    """Phase 21: the mesh paths on a virtual (data 2, model 2) mesh of this
    card, on phase 3b's int8 model (put on the mesh in place; the run ends
    here). Nothing falls back to the single-device path: each step raises."""
    import numpy as np

    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.parallel.mesh import make_mesh, shard_colqwen_params
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    out = {"card": smi, "mesh_shape": dict(zip(("data", "model"), MESH_SHAPE)),
           "note": "a virtual mesh of one card runs its shards one after another: no figure is a multi-card speed"}

    # (a) auto_mesh with one visible card: single-device serving
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        settings = service_settings(tmp / "a")
        settings.tpu.auto_mesh = True
        t0 = time.perf_counter()
        services = build_services(settings, colqwen_model=model)
        out["auto_mesh"] = {"visible_cards": torch.cuda.device_count(), "mesh_shape": settings.tpu.mesh_shape,
                            "store_mesh": services.colpali_vector_store.mesh is not None,
                            "model_mesh": model.mesh is not None, "boot_s": time.perf_counter() - t0}
        if services.colpali_vector_store.mesh is not None or model.mesh is not None:
            raise AssertionError(f"auto_mesh on one card built a mesh: {out['auto_mesh']}")
        del services
        log(f"phase 21a: tpu.auto_mesh = true, mesh_shape {settings.tpu.mesh_shape}, "
            f"{torch.cuda.device_count()} visible card: serves single-device (no mesh), boot "
            f"{out['auto_mesh']['boot_s']:.3f} s")

        # (b) the model on the mesh
        patches = np.stack([p for p, _ in _pages(model.cfg)])
        half = BATCH // MESH_SHAPE[0]
        single_b8 = model.embed_image_batch(patches, *GRID)
        single_shards = np.concatenate([model.embed_image_batch(patches[i : i + half], *GRID)
                                        for i in range(0, BATCH, half)])
        single_q = model.embed_queries(QUERIES)
        single_tokens = [model.query_token_ids(t) for t in QUERIES]
        mesh = make_mesh(MESH_SHAPE, devices=["cuda:0"] * int(np.prod(MESH_SHAPE)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shard_colqwen_params(model, mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        _kernels.reset_launch_counts()  # the mesh embed starts here
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            mesh_pages = model.embed_image_batch(patches, *GRID)
            times.append(time.perf_counter() - t0)
        embed_launches = dict(_kernels.launch_counts)
        t0 = time.perf_counter()
        mesh_q = model.embed_queries(QUERIES)
        query_s = time.perf_counter() - t0
        k3_per_forward = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        shard_forwards = 2 * MESH_SHAPE[0]
        cos = (mesh_pages * single_b8).sum(-1)
        stats = {
            "shard_s": shard_s, "embed_s": times, "pages_per_s_second": BATCH / times[1], "query_s": query_s,
            "max_abs_diff_per_shard_batches": float(np.abs(mesh_pages - single_shards).max()),
            "max_abs_diff_batch8": float(np.abs(mesh_pages - single_b8).max()),
            "mean_cosine_batch8": float(cos.mean()), "min_cosine_batch8": float(cos.min()),
            "phase3b_max_abs_diff": float(max(np.abs(a - b).max() for a, b in zip(single_b8, page_embs))),
            "query_max_abs_diff": float(max(np.abs(a - b).max() for a, b in zip(mesh_q, single_q))),
            "k3_launches": embed_launches["window_attention"], "k3_per_shard_forward": k3_per_forward,
            "peak_gb": _peak_gb(torch),
        }
        out["model"] = stats
        _check_embeddings(model, list(mesh_pages), [None] * BATCH)
        _check_queries(model, mesh_q, "mesh")
        if stats["max_abs_diff_per_shard_batches"] != 0.0:
            raise AssertionError(f"the mesh pages differ from the single-device pages of the same batches: {stats}")
        if not stats["mean_cosine_batch8"] >= MESH_MIN_PAGE_COSINE:
            raise AssertionError(f"the mesh pages drift from the single-device batch of 8: {stats}")
        if [q.shape[0] for q in mesh_q] != [len(t) for t in single_tokens] or stats["query_max_abs_diff"] != 0.0:
            raise AssertionError(f"the mesh queries differ from the single-device encode: {stats}")
        if embed_launches["window_attention"] != k3_per_forward * shard_forwards:
            raise AssertionError(f"K3 launched {embed_launches['window_attention']} times for {shard_forwards} "
                                 f"shard forwards of {k3_per_forward}")
        log(f"phase 21b: the 3B int8 model on a {out['mesh_shape']} mesh of one card (in place, {shard_s:.3f} s): "
            f"{BATCH} pages in {times} s (two data shards of {half}); pages equal the single-device ones of the "
            f"same batches bit for bit; max abs diff to the batch of 8 {stats['max_abs_diff_batch8']:.3e} (mean "
            f"cosine {stats['mean_cosine_batch8']:.7f}); queries equal (tokens and embeddings) in {query_s:.3f} s; K3 {embed_launches['window_attention']} = "
            f"{k3_per_forward} x {shard_forwards} shard forwards; peak {stats['peak_gb']:.2f} GB")

        # (c) the mesh index beside a single-device one over the same rows
        t0 = time.perf_counter()
        extra = mesh_rows(torch, MESH_SYNTH)
        all_rows = list(rows) + extra
        recs = [f"page{i}" if i < BATCH else f"synth{i - BATCH}" for i in range(len(all_rows))]
        gen_s = time.perf_counter() - t0
        single = MultiVectorIndex(FDEConfig(), device="cuda", device_block_rows=BLOCK_ROWS, **SHIPPED)
        meshed = MultiVectorIndex(FDEConfig(), mesh=mesh, device_block_rows=BLOCK_ROWS, **SHIPPED)
        t0 = time.perf_counter()
        single.store(all_rows[:BATCH], [IndexRecord(r, 0) for r in recs[:BATCH]], fde_vectors=np.stack(page_fdes))
        single.store(all_rows[BATCH:], [IndexRecord(r, 0) for r in recs[BATCH:]])
        fdes = single._fde_rows(0, single.count_rows)
        store_s = time.perf_counter() - t0
        n0 = len(all_rows) - MESH_TAIL
        meshed.store(all_rows[:n0], [IndexRecord(r, 0) for r in recs[:n0]], fde_vectors=fdes[:n0])
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()  # the mesh index path starts here
        uploads = []
        for q in queries5[:2]:
            t0 = time.perf_counter()
            meshed.query(q, k=10)
            uploads.append((meshed.last_mesh_upload_rows, time.perf_counter() - t0))
        meshed.store(all_rows[n0:], [IndexRecord(r, 0) for r in recs[n0:]], fde_vectors=fdes[n0:])
        lat_m, got = [], []
        for i, q in enumerate(queries5):
            t0 = time.perf_counter()
            got.append(meshed.query(q, k=10, return_timing=True))
            lat_m.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                uploads.append((meshed.last_mesh_upload_rows, lat_m[-1] / 1e3))
            if not meshed.last_timing["pooled_tier"]:
                raise AssertionError("the mesh index did not serve through the pooled tier")
        allowed = [f"page{i}" for i in range(0, BATCH, 2)] + [f"synth{i}" for i in range(0, MESH_SYNTH, 3)]
        filtered = meshed.query(queries5[0], k=10, doc_ids=allowed)
        index_launches = dict(_kernels.launch_counts)  # the mesh index path ends here
        lat_s, diffs = [], []
        for i, (q, rm) in enumerate(zip(queries5, got)):
            t0 = time.perf_counter()
            rs = single.query(q, k=10)
            lat_s.append((time.perf_counter() - t0) * 1e3)
            if [r.document_id for r, _ in rm] != [r.document_id for r, _ in rs] or len(rm) != 10:
                raise AssertionError(f"query {i}: mesh ids {[r.document_id for r, _ in rm]} vs single "
                                     f"{[r.document_id for r, _ in rs]}")
            diffs.append(max(abs(a - b) for (_, a), (_, b) in zip(rm, rs)))
        if max(diffs) > MESH_SCORE_ATOL:
            raise AssertionError(f"mesh scores differ from the single-device ones by {max(diffs)}")
        if got[-1][0][0].document_id != f"synth{123}":
            raise AssertionError("the mesh self-query top-1 is not its row")
        if not filtered or any(r.document_id not in set(allowed) for r, _ in filtered) or [
                r.document_id for r, _ in filtered] != [r.document_id for r, _ in single.query(queries5[0], k=10,
                                                                                               doc_ids=allowed)]:
            raise AssertionError(f"the filtered mesh query left the gate: {[r.document_id for r, _ in filtered]}")
        top1 = [(single.query(a, k=1)[0][0].document_id, single.query(b, k=1)[0][0].document_id)
                for a, b in zip(mesh_q, single_q)]
        if any(a != b for a, b in top1):
            raise AssertionError(f"mesh-encoded queries change the top-1: {top1}")
        n = len(all_rows)
        if uploads[0][0] != n0 or uploads[1][0] != 0 or not 0 < uploads[2][0] <= BLOCK_ROWS:
            raise AssertionError(f"last_mesh_upload_rows cold / warm / after a store: {uploads}")
        if index_launches["maxsim_q8"] <= 0:
            raise AssertionError(f"the mesh index never launched K1: {index_launches}")
        out["index"] = {
            "rows": n, "blocks": len(meshed._dev_blocks), "rows_per_shard_block": BLOCK_ROWS // MESH_SHAPE[0],
            "synth_s": gen_s, "single_store_s": store_s, "upload_rows_cold_warm_after_store": [u[0] for u in uploads],
            "query_s_cold_warm_after_store": [u[1] for u in uploads], "mesh_query_ms": lat_m,
            "single_query_ms": lat_s, "max_score_diff": max(diffs), "launches": index_launches,
            "peak_gb": _peak_gb(torch), "top1_mesh_vs_single_queries": top1,
        }
        log(f"phase 21c: mesh index of {n} rows ({out['index']['blocks']} blocks of {BLOCK_ROWS}, "
            f"{BLOCK_ROWS // MESH_SHAPE[0]} rows a data shard): phase 5's queries give the single-device ids, max "
            f"score diff {max(diffs):.3e}, pooled tier; mesh query ms {[round(x, 3) for x in lat_m]} vs single "
            f"{[round(x, 3) for x in lat_s]}; uploads cold / warm / after {MESH_TAIL} rows "
            f"{[u[0] for u in uploads]}; filtered query in the gate; launches {index_launches}")
        del single, meshed, extra, all_rows

        # (d) the HTTP server on the mesh, serving phase 8's static scales (a boot would recalibrate
        # from the scales in place and serve slightly other ones)
        settings = service_settings(tmp / "d")
        settings.model.static_act_scales = False
        restore_vision_scales(model, phase8_scales)
        t0 = time.perf_counter()
        services = build_services(settings, colqwen_model=model, mesh=mesh)
        server = ServerThread(services)
        boot_s = time.perf_counter() - t0
        client = Client(f"http://127.0.0.1:{server.server.port}")
        try:
            if services.colpali_vector_store.mesh is not mesh:
                raise AssertionError("the server's store is not on the mesh")
            pngs = [encode_png(p) for p in service_pages()]
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()  # the mesh server's path starts here
            t0 = time.perf_counter()
            docs = [client.upload(f"page{i}.png", data)["external_id"] for i, data in enumerate(pngs)]
            ingest_s = _wait_completed(client, docs) - t0
            worst, lat = 0.0, []
            for text in QUERIES:
                t0 = time.perf_counter()
                res = client.call("POST", "/retrieve/chunks", {"query": text, "k": 4})
                lat.append((time.perf_counter() - t0) * 1e3)
                want = phase8_answers[text]
                if [r["filename"] for r in res] != [f for f, _ in want]:
                    raise AssertionError(f"{text!r}: mesh server {[r['filename'] for r in res]} vs phase 8 "
                                         f"{[f for f, _ in want]}")
                for r, (_, score) in zip(res, want):
                    rel = abs(r["score"] - score) / max(1.0, abs(score))
                    worst = max(worst, rel)
                    if rel > MESH_REL_SCORE:
                        raise AssertionError(f"{text!r}: score {r['score']} vs phase 8's {score}")
            server_launches = dict(_kernels.launch_counts)
            if server_launches["window_attention"] <= 0 or server_launches["maxsim_q8"] <= 0:
                raise AssertionError(f"the mesh server did not launch K3 and K1: {server_launches}")
            blocks = services.colpali_vector_store._indexes["default"]._dev_blocks
            if not blocks or len(blocks[0][0]) != MESH_SHAPE[0]:
                raise AssertionError("the mesh server's index holds no sharded blocks")
        finally:
            server.stop()
        out["server"] = {"boot_s": boot_s, "pages": len(pngs), "ingest_s": ingest_s, "retrieve_ms": lat,
                         "max_rel_score_diff_vs_phase8": worst, "launches": server_launches,
                         "peak_gb": _peak_gb(torch)}
        log(f"phase 21d: HTTP server on the mesh, up in {boot_s:.3f} s: {len(pngs)} PNG pages in {ingest_s:.3f} s; "
            f"/retrieve/chunks gives phase 8's filenames in order, max relative score diff {worst:.3e}; retrieve ms "
            f"{[round(x, 3) for x in lat]}; launches {server_launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: embed_launches[k] + index_launches[k] + server_launches[k] for k in embed_launches}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21: the mesh paths on one card ({smi}; {out['note']}): launches {out['launches']}, "
        f"phase {out['phase_s']:.3f} s")
    return out


def _json_docs(text: str) -> list:
    """The JSON documents printed one after another in `text`."""
    dec, docs, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        doc, i = dec.raw_decode(text, i)
        docs.append(doc)
    return docs


def main() -> None:
    torch, smi = setup()
    import numpy as np

    from morphik_core_tpu_torch.ops import _kernels

    t_all = time.perf_counter()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    sass = build_kernels()
    main_k1, main_k2, main_k3, doc_k3, f32_k3, rerank_k2, all_cases = kernel_checks(torch)
    main_k4, k4_cases = binary_kernel_checks(torch)
    all_cases += k4_cases
    main_k5, k5_cases = j2k_t1_kernel_checks(torch)
    all_cases += k5_cases
    main_k6, k6_cases = j2k_ht_kernel_checks(torch, main_k5["letter"])
    all_cases += k6_cases
    model, bf16_embs, bf16_queries, bf16_stats = ingest_bf16(torch, _kernels)
    ckpt, ckpt_written = write_checkpoint_phase(torch, model)  # before phase 3b quantizes in place
    try:
        _kernels.reset_launch_counts()  # the main path starts here
        emb, page_embs, page_fdes, int8_stats = ingest_int8(torch, model, bf16_embs)
        rows = [e.astype(np.float16) for e in page_embs] + synthetic_rows((600, 661), N_SYNTH)
        index_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_index_"))
        try:
            index, store_s = make_index(torch, rows, np.stack(page_fdes), path=index_dir / "default")
            log(f"phase 4: stored {len(rows)} rows (device FDE + pooling + host copy) in {store_s:.3f} s")
            log("phase 5: queries, shipped retrieval config (int8 rerank), int8 text tower")
            int8_stats["query_mean_cosine"] = compare_queries(emb, bf16_queries)
            queries5, answers5 = run_queries(torch, emb, index, rows, "int8 rerank")
            n_blocks = len(index._dev_blocks)
            if n_blocks < 2:
                raise AssertionError(f"index spans {n_blocks} device block(s), expected >= 2")
            if brute_force_top1(torch, rows, queries5[-1]) != BATCH + 123:
                raise AssertionError("exact f32 MaxSim over all rows disagrees on the self-query top-1")
            log("phase 6: queries, rerank_dtype='bf16'")
            fdes = index._fde_rows(0, index.count_rows)
            index_bf16, _ = make_index(torch, rows, fdes[:BATCH], fdes[BATCH:], rerank_dtype="bf16")
            queries6, answers6 = run_queries(torch, emb, index_bf16, rows, "bf16 rerank")
            answers6 += run_encoded_queries(index_bf16, bf16_queries, "bf16 rerank, queries of the bf16 text tower")
            counts = dict(_kernels.launch_counts)
            log(f"phase 7: launch counts over the main path (phases 3b-6): {counts}")
            if min(counts[k] for k in ("maxsim_q8", "maxsim", "window_attention")) <= 0:  # K4 is phase 18's
                raise AssertionError(f"a kernel of the path was never launched: {counts}")
            log(f"ingest summary: {json.dumps({'bf16': bf16_stats, 'int8_static': int8_stats})}")
            del index_bf16
            _kernels.reset_launch_counts()  # the persistence path starts here
            persistence = persistence_phase(torch, index, index_dir / "default", list(zip(queries5, answers5)),
                                            list(zip(queries6 + bf16_queries, answers6)), smi)
            persistence["launches"] = dict(_kernels.launch_counts)  # and ends here
            if persistence["launches"]["maxsim_q8"] <= 0 or persistence["launches"]["maxsim"] <= 0:
                raise AssertionError(f"phase 9 did not launch K1 and K2: {persistence['launches']}")
            log(f"  phase 9 launches: {persistence['launches']}")
            del index
        finally:
            shutil.rmtree(index_dir, ignore_errors=True)
        service, phase8_scales = service_path(torch, model, _kernels, smi)
        documents = documents_phase(torch, model, _kernels, smi)
        checkpoint = checkpoint_phase(torch, model, ckpt, ckpt_written, _kernels, smi)
        f32 = f32_phase(torch, ckpt, bf16_embs, _kernels, smi)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    llm = llm_phase(torch, model, _kernels, smi)
    remote = remote_phase(torch, model, _kernels, smi)
    connectors = connectors_phase(torch, model, _kernels, smi)
    text_index = text_index_phase(torch, smi)
    binary = binary_phase(torch, page_embs, queries5, _kernels, smi)
    scripts = scripts_phase(torch, model, page_embs, _kernels, smi)
    evals = evals_phase(torch, _kernels, smi)
    formats = formats_phase(torch, model, _kernels, smi)  # before phase 21 puts the model on its mesh
    text_pages = text_pages_phase(torch, model, _kernels, smi)
    mesh = mesh_phase(torch, model, page_embs, rows, page_fdes, queries5, service["retrieve_answers"], phase8_scales,
                      _kernels, smi)
    csrc = "morphik_core_tpu_torch/csrc/"
    kernels = [  # library_ms: no single PyTorch call computes MaxSim
        dict(name=name, route="cuda", source=csrc + src, replaces=replaces, launches=counts[name],
             service_launches=service["launches"][name], persistence_launches=persistence["launches"][name],
             max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
             bound_ms=case["bound_us"] / 1e3, bound_by=case["bound_by"], library_ms=case.get("library_ms"),
             device_ms=case["device_ms"], plain_device_ms=case["plain_device_ms"],
             library_device_ms=case.get("library_device_ms"), library_call=case.get("library_call"),
             shape=case["case"],
             text_launches=service["rerank_launches"][name] + service["colpali_text_launches"][name],
             documents_launches=documents["launches"]["ingest"][name] + (
                 sum(documents["launches"]["retrieve_k1"]) if name == "maxsim_q8" else 0),
             corpus_launches=documents["corpus"]["launches"][name],
             checkpoint_launches=checkpoint["launches"][name], llm_launches=llm["launches"][name],
             remote_launches=sum(remote["launches"][part][name] for part in ("ingest", "retrieve", "relay")),
             connectors_launches=connectors["launches"][name], f32_launches=f32["launches"][name],
             evals_launches=evals["launches"][name], mesh_launches=mesh["launches"][name],
             formats_launches=formats["launches"][name], text_pages_launches=text_pages["launches"][name])
        for name, src, replaces, case in (
            ("maxsim_q8", "maxsim.cu", "morphik_core_tpu/ops/maxsim.py:248", main_k1),
            ("maxsim", "maxsim.cu", "morphik_core_tpu/ops/maxsim.py:111", main_k2),
            ("window_attention", "window_attention.cu", "morphik_core_tpu/ops/window_attention.py:57", main_k3),
        )
    ]
    kernels[1]["reranker_case"] = {k: rerank_k2[k] for k in (
        "case", "max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_us", "bound_by")}
    kernels[2]["documents_case"] = {k: doc_k3[k] for k in (
        "case", "max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_us", "bound_by",
        "library_call", "library_ms", "library_device_ms")}
    kernels[2]["f32_case"] = dict({k: f32_k3[k] for k in (
        "case", "max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_us", "bound_by",
        "library_call", "library_ms", "library_device_ms", "occupancy")},
        bound_ms=f32_k3["bound_us"] / 1e3, launches=f32["launches"]["window_attention"], sass=next(ops for name, ops in sass.items() if K3_F32_SASS.fullmatch(name)),
        source=csrc + "window_attention.cu::window_attention_tf32_kernel")
    kernels.append(dict(  # K4 replaces no Pallas kernel: the reference's binary MaxSim is one XLA program
        name="binary_maxsim", route="cuda", source=csrc + "binary_maxsim.cu",
        replaces="morphik_core_tpu/ops/binary.py:65", launches=binary["launches"]["binary_maxsim"],
        max_abs_err=main_k4["max_abs_err"], ms=main_k4["ms"], plain_ms=main_k4["plain_ms"],
        bound_ms=main_k4["bound_us"] / 1e3, bound_by=main_k4["bound_by"], library_ms=None,
        library_call="none (no popcount op)", device_ms=main_k4["device_ms"], plain_device_ms=main_k4["plain_device_ms"],
        shape=main_k4["case"], launches_resident=binary["launches_resident"],
        evals_launches=evals["launches"]["binary_maxsim"], mesh_launches=mesh["launches"]["binary_maxsim"],
        launches_streamed=binary["launches_streamed"],
        other_cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms",
                                        "bound_us", "bound_by")} for c in k4_cases[1:]]))
    kernels.append(dict(  # K5 replaces no Pallas kernel: the reference's tier-1 is OpenJPEG's host C under Pillow
        name="j2k_t1", route="cuda", source=csrc + "j2k_t1.cu",
        replaces="OpenJPEG 2.5.4 src/lib/openjp2/t1.c:opj_t1_decode_cblks (through Pillow libImaging/Jpeg2KDecode.c)",
        launches=formats["launches"]["j2k_t1"], max_abs_err=main_k5["max_abs_err"], ms=main_k5["ms"],
        plain_ms=main_k5["plain_ms"], bound_ms=main_k5["bound_us"] / 1e3, bound_by=main_k5["bound_by"],
        library_ms=None, library_call="none (no PyTorch op decodes EBCOT)", device_ms=main_k5["device_ms"],
        plain_device_ms=None, shape=main_k5["case"], code_blocks=main_k5["code_blocks"],
        sm_share=main_k5["sm_share"], occupancy=main_k5["occupancy"], longest_chain=main_k5["longest_chain"],
        letter=main_k5["letter"], formats_ingest_launches=formats["jp2"]["ingest_launches"]["j2k_t1"],
        formats_query_launches=formats["jp2"]["queries"]["k5"],
        other_cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "device_ms", "bound_us",
                                        "bound_by", "code_blocks", "longest_chain")} for c in k5_cases[1:]]))
    if kernels[-1]["launches"] <= 0:
        raise AssertionError("K5 was never launched on phase 22's JPEG 2000 path")
    kernels.append(dict(  # K6 replaces no Pallas kernel: the reference's HT decoder is OpenJPEG's host C under Pillow
        name="j2k_ht", route="cuda", source=csrc + "j2k_ht.cu",
        replaces="OpenJPEG 2.5.4 src/lib/openjp2/ht_dec.c:opj_t1_ht_decode_cblk (through Pillow libImaging/Jpeg2KDecode.c)",
        launches=formats["launches"]["j2k_ht"], max_abs_err=main_k6["max_abs_err"], ms=main_k6["ms"],
        plain_ms=main_k6["plain_ms"], bound_ms=main_k6["bound_us"] / 1e3, bound_by=main_k6["bound_by"],
        library_ms=None, library_call="none (no PyTorch op decodes HTJ2K)", device_ms=main_k6["device_ms"],
        plain_device_ms=None, shape=main_k6["case"], code_blocks=main_k6["code_blocks"],
        sm_share=main_k6["sm_share"], occupancy=main_k6["occupancy"], longest_chain=main_k6["longest_chain"],
        letter=main_k6["letter"], k5_letter_device_ms=main_k6["k5_letter_device_ms"],
        formats_ingest_launches=formats["ht"]["ingest_launches"]["j2k_ht"],
        formats_query_launches=formats["ht"]["queries"]["k6"],
        other_cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "device_ms", "bound_us",
                                        "bound_by", "code_blocks", "blocks_by_passes", "longest_chain")}
                     for c in k6_cases[1:]]))
    if kernels[-1]["launches"] != HT_K6_PREDICTED:
        raise AssertionError(f"K6 launched {kernels[-1]['launches']} times on phase 22's path, predicted "
                             f"{HT_K6_PREDICTED}")
    log(f"total wall s {time.perf_counter() - t_all:.3f}")
    log(json.dumps({"cases": all_cases}))
    print(smi)
    print(json.dumps({"service": service}))
    print(json.dumps({"persistence": persistence}))
    corpus = documents.pop("corpus")
    print(json.dumps({"documents": documents}))
    print(json.dumps({"corpus": corpus}))
    print(json.dumps({"text_index": text_index}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"llm": llm}))
    print(json.dumps({"remote": remote}))
    print(json.dumps({"connectors": connectors}))
    print(json.dumps({"f32": f32}))
    print(json.dumps({"binary": binary}))
    print(json.dumps({"scripts": scripts}))
    print(json.dumps({"evals": evals}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"formats": formats}))
    print(json.dumps({"text_pages": text_pages}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
