"""The index from every public name of the JAX package to its counterpart
in the port and the test that holds the two together.

``COUNTERPARTS`` has one entry for each public top-level function and
class of every module under ``youtube_vln_tpu/``, of ``scripts/*.py`` and of
the root ``train.py``, ``pretrain.py``, ``test.py``, ``bench.py`` and
``__graft_entry__.py``.  An entry is either

* a counterpart, ``(target, test)`` or ``(target, test, via)``:
  ``target`` is ``"module.py:Name"`` or ``"module.py:Class.method"`` under
  ``youtube_vln_tpu_torch/``; ``test`` is ``"test_torch_x.py::test_name"``,
  which calls the JAX function, or one that reaches it, and the port's
  counterpart on the same seeded inputs.  ``via`` names the JAX file whose
  function the test calls in the key's place: one that reaches the key, or,
  for a script's ``main``, the function that the script wraps;
* or no counterpart: the reason, saying what takes the function's place in
  the port (ROADMAP's "No counterpart" list).

The checks read the sources with ``ast`` alone, importing neither package,
one case per JAX file: the keys are exactly the file's public names, every
target resolves in the port, every named test exists, and its file reaches
the key's JAX file or ``via`` (imports the module, or, for a script or root
entry, which tests load by path, names the file in a string).

Run the map and the parity files it leans on with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_counterparts.py
tests/test_torch_parity_*.py``."""
import ast
import functools
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "youtube_vln_tpu"
PORT = REPO / "youtube_vln_tpu_torch"
TESTS = REPO / "tests"
ROOT_ENTRIES = ("train.py", "pretrain.py", "test.py", "bench.py", "__graft_entry__.py")

# reasons for the names without a counterpart
PARTITION = ('GSPMD partitioning rules for pallas_call; a CUDA kernel launches on its '
    "rank's rows or head shard (parallel/tensor.py)")
VALIDATE = ("compile-only checks of the sharded JAX step; the port's DP and TP steps "
    'run under torch.distributed (tests/test_torch_distributed*.py, '
    'test_torch_tensor_parallel*.py, chip_smoke.py phases 14-15)')
TORCH_IO = ('a torch-checkpoint reader and writer without torch; the port has torch: '
    'torch.load / torch.save with the key map of models/weights.py')
ORBAX = ("orbax's format; the port saves torch.distributed.checkpoint directories "
    '(training/checkpoint.py:save_dcp, read by load_checkpoint)')
SHARDINGS = ('a jax.sharding layout; each rank of the port holds its own rows (DDP '
    'over the data group) and weight shards (parallel/mesh.py:param_spec)')
JIT = ("jax.jit with donated state; the port's step runs eagerly "
    '(parallel/train_step.py:build_train_step)')
XLA_CACHE = ('the XLA compilation cache; --compilation_cache_dir moves the CUDA '
    "kernels' build directory instead (ops/_build.py:set_build_dir)")
RBG = ('the JAX RBG dropout key; every dropout site of the port draws Philox or '
    'torch bits (ops/philox.py, models/layers.py:DropoutRng)')


def _benchmark(what, cells, metrics):
    """The reason of a JAX timing script whose place the port's benchmark
    (``BENCHMARK.json``, ``python3 benchmark/run.py``) takes: the cells and
    metrics that stand for it, which ``test_benchmark_reasons_name_cells``
    holds to the file."""
    return (f"{what}; the port's speed is the benchmark's: cells {', '.join(cells)}; "
            f"metrics {', '.join(metrics)}")


# root bench.py and scripts/bench_serving.py time one staged batch
BENCH_TRAIN = _benchmark("MRT trajectories/s and MFU of one staged batch",
                         ("pretrain.mrt_ytb", "finetune.30rs"),
                         ("train_traj_per_s", "mfu.train"))
BENCH_RERANK = _benchmark("beams/s of staged re-ranking dispatches",
                          ("rerank.r2r_val_bs1",),
                          ("rerank_beams_per_s", "rerank_p95_ms"))
BENCHMARK_FILES = ("bench.py", "scripts/bench_serving.py")

DRYRUN = ("a multi-chip compile dry run of the JAX step; the port's DP and TP paths "
    'run in tests/test_torch_distributed*.py, test_torch_tensor_parallel*.py '
    'and chip_smoke.py phases 14-15')
GRAFT = ("the JAX harness's jittable forward hook; on the card the port is run "
    'by chip_smoke.py')
PARAM_COUNT = ("the size of a parameter tree; a module's is sum(p.numel() for p in "
    'model.parameters()) (training/engine.py logs it)')
DEVICE_MASKING = ('on-device masking that no JAX path calls (the data pipelines mask on the '
    'host); the port keeps the host functions of ops/masking.py')


COUNTERPARTS = {
    "youtube_vln_tpu/config.py": {
        "LilyConfig": ("config.py:LilyConfig",
                       "test_torch_cli.py::test_run_config_and_model_config_equal_jax",
                       "youtube_vln_tpu/utils/entry.py"),
        "lily_base_config": ("config.py:lily_base_config",
                             "test_torch_model.py::test_flagship_widths_all_heads_match_jax"),
        "tiny_config": ("config.py:tiny_config",
                        "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "RunConfig": ("config.py:RunConfig",
                      "test_torch_train_step.py::test_run_config_copies_the_jax_fields"),
    },
    "youtube_vln_tpu/data/datasets.py": {
        "load_trajectories": ("data/datasets.py:load_trajectories",
                              "test_torch_data.py::test_dataset_items_equal"),
        "PretrainDataset": ("data/datasets.py:PretrainDataset",
                            "test_torch_data.py::test_dataset_items_equal"),
        "YTbDataset": ("data/datasets.py:YTbDataset",
                       "test_torch_data.py::test_dataset_items_equal"),
        "BnBDataset": ("data/datasets.py:BnBDataset",
                       "test_torch_data.py::test_dataset_items_equal"),
        "BeamDataset": ("data/datasets.py:BeamDataset",
                        "test_torch_beam_dataset.py::test_eval_items_equal"),
    },
    "youtube_vln_tpu/data/features_reader.py": {
        "FeaturesReader": (
            "data/features_reader.py:FeaturesReader",
            "test_torch_parity_host.py::test_fixture_vocab_and_reader_bases_match_jax"),
        "RegionFeaturesReader": (
            "data/features_reader.py:RegionFeaturesReader",
            "test_torch_parity_host.py::test_fixture_vocab_and_reader_bases_match_jax"),
        "YTbFeaturesReader": ("data/features_reader.py:YTbFeaturesReader",
                              "test_torch_data.py::test_store_and_readers_return_equal_arrays"),
        "BnBFeaturesReader": (
            "data/features_reader.py:BnBFeaturesReader",
            "test_torch_parity_host.py::test_fixture_vocab_and_reader_bases_match_jax"),
        "PanoFeaturesReader": ("data/features_reader.py:PanoFeaturesReader",
                               "test_torch_beam_dataset.py::test_eval_items_equal"),
    },
    "youtube_vln_tpu/data/fixtures.py": {
        "fixture_vocab": (
            "data/fixtures.py:fixture_vocab",
            "test_torch_parity_host.py::test_fixture_vocab_and_reader_bases_match_jax"),
        "write_fixture_vocab": ("data/fixtures.py:write_fixture_vocab",
                                "test_torch_data.py::test_fixtures_write_identical_files"),
        "write_store": ("data/fixtures.py:write_store",
                        "test_torch_tools_host.py::test_convert_lmdb_matches_jax"),
        "build_ytb_fixture": ("data/fixtures.py:build_ytb_fixture",
                              "test_torch_data.py::test_fixtures_write_identical_files"),
        "build_full_fixture": ("data/fixtures.py:build_full_fixture",
                               "test_torch_data.py::test_fixtures_write_identical_files"),
        "build_r2r_fixture": ("data/fixtures.py:build_r2r_fixture",
                              "test_torch_data.py::test_fixtures_write_identical_files"),
        "build_bnb_fixture": ("data/fixtures.py:build_bnb_fixture",
                              "test_torch_data.py::test_fixtures_write_identical_files"),
    },
    "youtube_vln_tpu/data/instructions.py": {
        "load_json": (
            "data/instructions.py:load_json",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "save_json": (
            "data/instructions.py:save_json",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "frame_tokens": (
            "data/instructions.py:frame_tokens",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "highlight_mask": (
            "data/instructions.py:highlight_mask",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "tokenize_dataset": (
            "data/instructions.py:tokenize_dataset",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "load_tokens": (
            "data/instructions.py:load_tokens",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "ytb_load_tokens": (
            "data/instructions.py:ytb_load_tokens",
            "test_torch_parity_host.py::test_framing_highlights_and_token_caches_match_jax"),
        "index_templates": ("data/instructions.py:index_templates",
                            "test_torch_parity_host.py::test_fill_template_matches_jax"),
        "fill_template": ("data/instructions.py:fill_template",
                          "test_torch_parity_host.py::test_fill_template_matches_jax"),
        "InstructionGenerator": (
            "data/instructions.py:InstructionGenerator",
            "test_torch_parity_host.py::test_instruction_generators_match_jax"),
        "ConcatenateInstructionGenerator": (
            "data/instructions.py:ConcatenateInstructionGenerator",
            "test_torch_parity_host.py::test_instruction_generators_match_jax"),
        "RephraseInstructionGenerator": (
            "data/instructions.py:RephraseInstructionGenerator",
            "test_torch_parity_host.py::test_instruction_generators_match_jax"),
        "YTBRephraseInstructionGenerator": (
            "data/instructions.py:YTBRephraseInstructionGenerator",
            "test_torch_parity_host.py::test_instruction_generators_match_jax"),
    },
    "youtube_vln_tpu/data/loader.py": {
        "shard_indices": ("data/loader.py:shard_indices",
                          "test_torch_data.py::test_collate_and_shard_indices_equal"),
        "collate": ("data/loader.py:collate",
                    "test_torch_data.py::test_collate_and_shard_indices_equal"),
        "Loader": ("data/loader.py:Loader", "test_torch_data.py::test_loader_batches_equal"),
        "device_prefetch": (
            "device.py:prefetch_to_device",
            "test_torch_parity_host.py::test_host_prefetch_yields_the_jax_batches"),
        "microbatch_reshape": ("data/loader.py:microbatch_reshape",
                               "test_torch_engine.py::test_train_epoch_losses_match_jax",
                               "youtube_vln_tpu/training/engine.py"),
    },
    "youtube_vln_tpu/data/nav_graph.py": {
        "load_nav_graphs": ("data/nav_graph.py:load_nav_graphs",
                            "test_torch_nav_graph.py::test_get_viewpoints_equal"),
        "load_distances": ("data/nav_graph.py:load_distances",
                           "test_torch_nav_graph.py::test_distances_equal_and_json_bytes_equal"),
        "compute_distances": (
            "data/nav_graph.py:compute_distances",
            "test_torch_nav_graph.py::test_distances_equal_and_json_bytes_equal"),
        "get_viewpoints": ("data/nav_graph.py:get_viewpoints",
                           "test_torch_nav_graph.py::test_get_viewpoints_equal"),
        "get_headings": ("data/nav_graph.py:get_headings",
                         "test_torch_nav_graph.py::test_headings_bit_equal"),
    },
    "youtube_vln_tpu/data/sampling.py": {
        "shuffle_different": ("data/sampling.py:shuffle_different",
                              "test_torch_parity_host.py::test_shufflers_match_jax"),
        "shuffle_two": ("data/sampling.py:shuffle_two",
                        "test_torch_parity_host.py::test_shufflers_match_jax"),
        "shuffle_non_adjacent": ("data/sampling.py:shuffle_non_adjacent",
                                 "test_torch_parity_host.py::test_shufflers_match_jax"),
        "load_shuffler": ("data/sampling.py:load_shuffler",
                          "test_torch_parity_host.py::test_shufflers_match_jax"),
        "random_fill": ("data/sampling.py:random_fill",
                        "test_torch_parity_host.py::test_sampling_helpers_match_jax"),
        "random_caption_image": ("data/sampling.py:random_caption_image",
                                 "test_torch_parity_host.py::test_sampling_helpers_match_jax"),
        "random_captionless_image": ("data/sampling.py:random_captionless_image",
                                     "test_torch_parity_host.py::test_sampling_helpers_match_jax"),
        "random_image": ("data/sampling.py:random_image",
                         "test_torch_parity_host.py::test_sampling_helpers_match_jax"),
        "is_captionless": ("data/sampling.py:is_captionless",
                           "test_torch_parity_host.py::test_sampling_pure_helpers_match_jax"),
        "merge_images": ("data/sampling.py:merge_images",
                         "test_torch_parity_host.py::test_sampling_pure_helpers_match_jax"),
        "merge_frames": ("data/sampling.py:merge_frames",
                         "test_torch_parity_host.py::test_sampling_pure_helpers_match_jax"),
        "ytb_key": ("data/sampling.py:ytb_key",
                    "test_torch_parity_host.py::test_sampling_pure_helpers_match_jax"),
        "drop_small_listings": ("data/sampling.py:drop_small_listings",
                                "test_torch_parity_host.py::test_sampling_pure_helpers_match_jax"),
        "ytb_trajectory": ("data/sampling.py:ytb_trajectory",
                           "test_torch_parity_host.py::test_trajectory_samplers_match_jax"),
        "bnb_trajectory_in_listing": (
            "data/sampling.py:bnb_trajectory_in_listing",
            "test_torch_parity_host.py::test_trajectory_samplers_match_jax"),
        "bnb_trajectory_out_listing": (
            "data/sampling.py:bnb_trajectory_out_listing",
            "test_torch_parity_host.py::test_trajectory_samplers_match_jax"),
        "generate_negatives": ("data/sampling.py:generate_negatives",
                               "test_torch_parity_host.py::test_generate_negatives_match_jax"),
    },
    "youtube_vln_tpu/data/store.py": {
        "StoreRecord": ("data/store.py:StoreRecord",
                        "test_torch_parity_host.py::test_store_writer_writes_the_jax_bytes"),
        "StoreWriter": ("data/store.py:StoreWriter",
                        "test_torch_parity_host.py::test_store_writer_writes_the_jax_bytes"),
        "get_native": ("data/store.py:get_native",
                       "test_torch_data.py::test_store_and_readers_return_equal_arrays"),
        "Store": ("data/store.py:Store",
                  "test_torch_data.py::test_store_and_readers_return_equal_arrays"),
        "merge_stores": (
            "data/store.py:merge_stores",
            "test_torch_tools_host.py::test_merge_stores_matches_jax_and_restores_native_path"),
        "convert_lmdb": ("data/store.py:convert_lmdb",
                         "test_torch_tools_host.py::test_convert_lmdb_matches_jax"),
    },
    "youtube_vln_tpu/data/tokenizer.py": {
        "WordPieceTokenizer": ("data/tokenizer.py:WordPieceTokenizer",
                               "test_torch_parity_host.py::test_wordpiece_tokenizer_matches_jax"),
        "load_tokenizer": ("data/tokenizer.py:load_tokenizer",
                           "test_torch_data.py::test_tokenizers_agree"),
        "write_vocab": ("data/tokenizer.py:write_vocab",
                        "test_torch_parity_host.py::test_wordpiece_tokenizer_matches_jax"),
    },
    "youtube_vln_tpu/evaluation/beam_eval.py": {
        "build_score_step": ("evaluation/beam_eval.py:build_score_step",
                             "test_torch_beam_eval.py::test_eval_epoch_matches_jax"),
        "eval_epoch": ("evaluation/beam_eval.py:eval_epoch",
                       "test_torch_beam_eval.py::test_eval_epoch_matches_jax"),
        "convert_scores": ("evaluation/beam_eval.py:convert_scores",
                           "test_torch_beam_eval.py::test_convert_scores_matches_jax"),
    },
    "youtube_vln_tpu/evaluation/metrics.py": {
        "load_task_splits": ("evaluation/metrics.py:load_task_splits",
                             "test_torch_metrics.py::test_score_file_and_splits_equal"),
        "Evaluation": ("evaluation/metrics.py:Evaluation",
                       "test_torch_metrics.py::test_score_items_equal"),
    },
    "youtube_vln_tpu/models/layers.py": {
        "init_linear": ("models/layers.py:Linear",
                        "test_torch_model.py::test_tiny_all_heads_match_jax",
                        "youtube_vln_tpu/models/vilbert.py"),
        "init_embedding": ("models/vilbert.py:VocabEmbedding",
                           "test_torch_model.py::test_tiny_all_heads_match_jax",
                           "youtube_vln_tpu/models/vilbert.py"),
        "init_layer_norm": ("models/layers.py:LayerNorm",
                            "test_torch_model.py::test_tiny_all_heads_match_jax",
                            "youtube_vln_tpu/models/vilbert.py"),
        "gelu": ("models/layers.py:gelu",
                 "test_torch_model.py::test_tiny_all_heads_match_jax",
                 "youtube_vln_tpu/models/vilbert.py"),
        "layer_norm": ("models/layers.py:LayerNorm.forward",
                       "test_torch_epilogue.py::test_reference_is_the_layer_norm_path_at_rate_0"),
        "linear": ("models/layers.py:Linear.forward",
                   "test_torch_model.py::test_tiny_all_heads_match_jax",
                   "youtube_vln_tpu/models/vilbert.py"),
        "dropout": ("models/layers.py:dropout",
                    "test_torch_model.py::test_xla_path_dropout_quantises_the_keep_rate",
                    "youtube_vln_tpu/models/vilbert.py"),
        "dropout_add_ln": (
            "models/layers.py:dropout_add_ln",
            "test_torch_epilogue.py::test_reference_is_the_layer_norm_path_at_rate_0"),
        "split_heads": ("models/layers.py:split_heads",
                        "test_torch_model.py::test_tiny_all_heads_match_jax",
                        "youtube_vln_tpu/models/vilbert.py"),
        "merge_heads": ("models/layers.py:merge_heads",
                        "test_torch_model.py::test_tiny_all_heads_match_jax",
                        "youtube_vln_tpu/models/vilbert.py"),
        "attention_core": ("models/layers.py:attention_core",
                           "test_torch_model.py::test_tiny_all_heads_match_jax",
                           "youtube_vln_tpu/models/vilbert.py"),
        "init_self_attention": ("models/layers.py:SelfAttention",
                                "test_torch_model.py::test_tiny_all_heads_match_jax",
                                "youtube_vln_tpu/models/vilbert.py"),
        "init_ffn": ("models/layers.py:Intermediate",
                     "test_torch_model.py::test_tiny_all_heads_match_jax",
                     "youtube_vln_tpu/models/vilbert.py"),
        "init_transformer_layer": ("models/layers.py:TransformerLayer",
                                   "test_torch_model.py::test_tiny_all_heads_match_jax",
                                   "youtube_vln_tpu/models/vilbert.py"),
        "self_attention_block": ("models/layers.py:SelfAttention.forward",
                                 "test_torch_model.py::test_tiny_all_heads_match_jax",
                                 "youtube_vln_tpu/models/vilbert.py"),
        "ffn_block": ("models/layers.py:ffn",
                      "test_torch_model.py::test_tiny_all_heads_match_jax",
                      "youtube_vln_tpu/models/vilbert.py"),
        "transformer_layer": ("models/layers.py:TransformerLayer.forward",
                              "test_torch_model.py::test_tiny_all_heads_match_jax",
                              "youtube_vln_tpu/models/vilbert.py"),
    },
    "youtube_vln_tpu/models/legacy.py": {
        "init_weight_norm_linear": ("models/legacy.py:WeightNormLinear",
                                    "test_torch_legacy.py::test_eval_outputs_match_jax"),
        "weight_norm_linear": ("models/legacy.py:WeightNormLinear.forward",
                               "test_torch_legacy.py::test_eval_outputs_match_jax"),
        "init_simple_classifier": ("models/legacy.py:SimpleClassifier",
                                   "test_torch_legacy.py::test_eval_outputs_match_jax"),
        "simple_classifier": ("models/legacy.py:SimpleClassifier.forward",
                              "test_torch_legacy.py::test_eval_outputs_match_jax"),
        "multimodal_pretraining_forward": ("models/legacy.py:BertForMultiModalPreTraining.forward",
                                           "test_torch_legacy.py::test_eval_outputs_match_jax"),
        "vl_tasks_forward": ("models/legacy.py:VILBertForVLTasks.forward",
                             "test_torch_legacy.py::test_eval_outputs_match_jax"),
    },
    "youtube_vln_tpu/models/torch_io.py": {
        "normalize_state_dict": ("models/weights.py:normalize_state_dict",
                                 "test_torch_model.py::test_normalize_adds_missing_bert_prefix"),
        "state_dict_to_params": (
            "training/checkpoint.py:load_checkpoint",
            "test_torch_checkpoint.py::test_jax_checkpoint_loads_into_equal_tensors"),
        "params_to_state_dict": ("models/weights.py:state_dict_from_jax_params",
                                 "test_torch_checkpoint.py::test_saved_keys_equal_the_jax_save"),
        "load_torch_checkpoint": TORCH_IO,
        "save_torch_checkpoint": TORCH_IO,
    },
    "youtube_vln_tpu/models/torch_serialization.py": {
        "load": TORCH_IO,
        "save": TORCH_IO,
    },
    "youtube_vln_tpu/models/vilbert.py": {
        "init_lily_params": ("models/vilbert.py:Lily",
                             "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "param_count": PARAM_COUNT,
        "text_embeddings": ("models/vilbert.py:TextEmbeddings.forward",
                            "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "vision_embeddings": ("models/vilbert.py:VisionEmbeddings.forward",
                              "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "bi_attention": ("models/vilbert.py:BiAttention.forward",
                         "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "connection_layer": ("models/vilbert.py:ConnectionLayer.forward",
                             "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "encoder": ("models/vilbert.py:Encoder.forward",
                    "test_torch_model.py::test_encoder_modes_match_jax"),
        "pooler": ("models/vilbert.py:Pooler.forward",
                   "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "mlm_head": ("models/vilbert.py:LMPredictionHead.forward",
                     "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "image_head": ("models/vilbert.py:ImagePredictionHead.forward",
                       "test_torch_model.py::test_tiny_all_heads_match_jax"),
        "fuse_pooled": ("models/vilbert.py:fuse_pooled",
                        "test_torch_model.py::test_fusion_and_activation_options_match_jax"),
        "bert_model": ("models/vilbert.py:BertModel.forward",
                       "test_torch_model.py::test_encoder_modes_match_jax"),
        "lily_forward": ("models/vilbert.py:Lily.forward",
                         "test_torch_model.py::test_flagship_widths_all_heads_match_jax"),
    },
    "youtube_vln_tpu/ops/attention.py": {
        "pallas_attention_core": ("ops/attention.py:fused_attention",
                                  "test_torch_attention.py::test_b1_plain_matches_pallas"),
        "pallas_bi_attention": ("ops/attention.py:fused_bi_attention",
                                "test_torch_attention.py::test_b2_plain_matches_pallas"),
        "select_bi_attention_fn": (
            "ops/attention.py:use_kernel_for",
            "test_torch_attention.py::test_dispatch_matches_pallas_heuristic"),
        "use_pallas_for": ("ops/attention.py:use_kernel_for",
                           "test_torch_attention.py::test_dispatch_matches_pallas_heuristic"),
        "select_attention_fn": ("ops/attention.py:use_kernel_for",
                                "test_torch_attention.py::test_dispatch_matches_pallas_heuristic"),
    },
    "youtube_vln_tpu/ops/epilogue.py": {
        "pallas_dropout_add_ln": ("ops/epilogue.py:fused_dropout_add_ln",
                                  "test_torch_epilogue.py::test_function_gradients_match_pallas"),
        "select_epilogue_fn": (
            "ops/epilogue.py:use_epilogue_kernel_for",
            "test_torch_epilogue.py::test_site_rule_matches_select_epilogue_fn"),
    },
    "youtube_vln_tpu/ops/masking.py": {
        "randomize_tokens_np": ("ops/masking.py:randomize_tokens_np",
                                "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
        "randomize_regions_np": ("ops/masking.py:randomize_regions_np",
                                 "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
        "unmasked_region_targets": (
            "ops/masking.py:unmasked_region_targets",
            "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
        "randomize_tokens_jax": DEVICE_MASKING,
        "randomize_regions_jax": DEVICE_MASKING,
        "max_masked_regions": ("ops/masking.py:max_masked_regions",
                               "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
        "randomize_regions_sparse_dedup_np": (
            "ops/masking.py:randomize_regions_sparse_dedup_np",
            "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
        "randomize_regions_sparse_np": (
            "ops/masking.py:randomize_regions_sparse_np",
            "test_torch_data.py::test_masking_functions_draw_the_same_masks"),
    },
    "youtube_vln_tpu/ops/partition.py": {
        "sharded_lead_call": PARTITION,
        "sharded_batch_call": PARTITION,
    },
    "youtube_vln_tpu/parallel/distributed.py": {
        "initialize": ("parallel/distributed.py:initialize",
                       "test_torch_parity_host.py::test_single_process_collectives_match_jax"),
        "is_main_process": (
            "parallel/distributed.py:is_main_process",
            "test_torch_parity_host.py::test_single_process_collectives_match_jax"),
        "world_size": ("parallel/distributed.py:world_size",
                       "test_torch_parity_host.py::test_single_process_collectives_match_jax"),
        "all_reduce_mean_host": (
            "parallel/distributed.py:all_reduce_mean_host",
            "test_torch_parity_host.py::test_single_process_collectives_match_jax"),
        "broadcast_host": ("parallel/distributed.py:broadcast_host",
                           "test_torch_parity_host.py::test_single_process_collectives_match_jax"),
    },
    "youtube_vln_tpu/parallel/mesh.py": {
        "make_mesh": (
            "parallel/distributed.py:init_mesh",
            "test_torch_tensor_parallel.py::test_param_spec_matches_jax_param_shardings"),
        "batch_sharding": SHARDINGS,
        "replicated": SHARDINGS,
        "param_shardings": (
            "parallel/mesh.py:param_spec",
            "test_torch_tensor_parallel.py::test_param_spec_matches_jax_param_shardings"),
        "shard_params": (
            "models/weights.py:shard_state_dict",
            "test_torch_tensor_parallel.py::test_param_spec_matches_jax_param_shardings"),
    },
    "youtube_vln_tpu/parallel/train_step.py": {
        "TrainState": ("parallel/train_step.py:create_train_state",
                       "test_torch_train_step.py::test_five_step_loss_trajectory_matches_jax"),
        "create_train_state": (
            "parallel/train_step.py:create_train_state",
            "test_torch_train_step.py::test_five_step_loss_trajectory_matches_jax"),
        "expand_beam_steps": ("parallel/train_step.py:expand_beam_steps",
                              "test_torch_beam_eval.py::test_dedup_transport_scores_like_dense",
                              "youtube_vln_tpu/evaluation/beam_eval.py"),
        "fast_dropout_key": RBG,
        "loss_fn": ("parallel/train_step.py:loss_fn",
                    "test_torch_train_step.py::test_loss_fn_gradients_match_jax"),
        "build_train_step": (
            "parallel/train_step.py:build_train_step",
            "test_torch_train_step.py::test_five_step_loss_trajectory_matches_jax"),
        "build_eval_step": ("parallel/train_step.py:build_eval_step",
                            "test_torch_train_step.py::test_eval_step_matches_jax"),
        "jit_train_step": JIT,
        "make_batch_shardings": SHARDINGS,
        "make_accum_batch_shardings": SHARDINGS,
    },
    "youtube_vln_tpu/parallel/validate.py": {
        "forced_attention_fn": VALIDATE,
        "flagship_geometry_compile": VALIDATE,
    },
    "youtube_vln_tpu/pipeline/assets.py": {
        "connectivity_manifest": (
            "pipeline/assets.py:connectivity_manifest",
            "test_torch_tools_host.py::test_asset_manifest_and_offline_fetch_match_jax"),
        "fetch": ("pipeline/assets.py:fetch",
                  "test_torch_tools_host.py::test_asset_manifest_and_offline_fetch_match_jax"),
        "fetch_all": ("pipeline/assets.py:fetch_all",
                      "test_torch_tools_host.py::test_asset_manifest_and_offline_fetch_match_jax"),
        "generate_distances": (
            "pipeline/assets.py:generate_distances",
            "test_torch_tools_host.py::test_generate_distances_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/build_dataset.py": {
        "assemble_records": (
            "pipeline/build_dataset.py:assemble_records",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "load_frames_tsv": (
            "pipeline/build_dataset.py:load_frames_tsv",
            "test_torch_parity_pipeline.py::test_dataset_files_and_split_match_jax"),
        "preprocess_records": (
            "pipeline/build_dataset.py:preprocess_records",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "write_preprocessed": (
            "pipeline/build_dataset.py:write_preprocessed",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "split_train_test": (
            "pipeline/build_dataset.py:split_train_test",
            "test_torch_parity_pipeline.py::test_dataset_files_and_split_match_jax"),
        "write_dataset": ("pipeline/build_dataset.py:write_dataset",
                          "test_torch_parity_pipeline.py::test_dataset_files_and_split_match_jax"),
        "freeze_testset": (
            "pipeline/build_dataset.py:freeze_testset",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/clip_captions.py": {
        "zero_shot_captions": ("pipeline/clip_captions.py:zero_shot_captions",
                               "test_torch_parity_pipeline.py::test_zero_shot_captions_match_jax"),
        "caption_video_frames": (
            "pipeline/clip_captions.py:caption_video_frames",
            "test_torch_parity_pipeline.py::test_zero_shot_captions_match_jax"),
        "write_captions": ("pipeline/clip_captions.py:write_captions",
                           "test_torch_parity_pipeline.py::test_zero_shot_captions_match_jax"),
        "run": ("pipeline/clip_captions.py:run",
                "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/clip_model.py": {
        "ClipConfig": (
            "pipeline/clip_model.py:ClipConfig",
            "test_torch_clip.py::test_features_match_jax_and_the_carrier_inverts_the_importer"),
        "init_clip_params": (
            "pipeline/clip_model.py:ClipModel.init_weights",
            "test_torch_parity_pipeline.py::test_initialisers_give_the_port_layout"),
        "quick_gelu": ("pipeline/clip_model.py:quick_gelu",
                       "test_torch_clip.py::test_hf_state_dict_loads_strictly_and_matches_jax"),
        "clip_image_features": (
            "pipeline/clip_model.py:clip_image_features",
            "test_torch_clip.py::test_features_match_jax_and_the_carrier_inverts_the_importer"),
        "clip_text_features": (
            "pipeline/clip_model.py:clip_text_features",
            "test_torch_clip.py::test_features_match_jax_and_the_carrier_inverts_the_importer"),
        "params_from_hf_state_dict": (
            "models/weights.py:clip_state_dict_from_jax_params",
            "test_torch_clip.py::test_features_match_jax_and_the_carrier_inverts_the_importer"),
        "load_clip_params": (
            "pipeline/clip_model.py:load_clip_params",
            "test_torch_parity_pipeline.py::test_clip_checkpoint_and_frame_encoding_match_jax"),
        "preprocess_images": ("pipeline/clip_model.py:preprocess_images",
                              "test_torch_clip.py::test_bicubic_preprocessor_matches_jax"),
        "tokenize_prompts": (
            "pipeline/clip_model.py:tokenize_prompts",
            "test_torch_parity_pipeline.py::test_prompt_tokenization_matches_jax"),
        "read_clip_tsv": ("pipeline/clip_model.py:read_clip_tsv",
                          "test_torch_clip.py::test_clip_tsv_build_and_resume"),
        "build_clip_tsv": ("pipeline/clip_model.py:build_clip_tsv",
                           "test_torch_clip.py::test_clip_tsv_build_and_resume"),
        "encode_video_frames": (
            "pipeline/clip_model.py:encode_video_frames",
            "test_torch_parity_pipeline.py::test_clip_checkpoint_and_frame_encoding_match_jax"),
    },
    "youtube_vln_tpu/pipeline/detector.py": {
        "RegionFeatureExtractor": (
            "pipeline/detector.py:RegionFeatureExtractor",
            "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "RandomProposalExtractor": (
            "pipeline/detector.py:RandomProposalExtractor",
            "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "frame_key": ("pipeline/detector.py:frame_key",
                      "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "extract_to_store": (
            "pipeline/detector.py:extract_to_store",
            "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "convert_tsv_to_store": (
            "pipeline/detector.py:convert_tsv_to_store",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/extraction.py": {
        "load_all_photo_paths": (
            "pipeline/extraction.py:load_all_photo_paths",
            "test_torch_parity_pipeline.py::test_photo_path_caches_match_jax"),
        "load_finished_photo_paths": (
            "pipeline/extraction.py:load_finished_photo_paths",
            "test_torch_parity_pipeline.py::test_photo_path_caches_match_jax"),
        "load_pending_photo_paths": (
            "pipeline/extraction.py:load_pending_photo_paths",
            "test_torch_parity_pipeline.py::test_photo_path_caches_match_jax"),
        "compute_box_orientation": (
            "pipeline/extraction.py:compute_box_orientation",
            "test_torch_parity_pipeline.py::test_box_orientation_and_redundancy_filter_match_jax"),
        "redundancy_filter": (
            "pipeline/extraction.py:redundancy_filter",
            "test_torch_parity_pipeline.py::test_box_orientation_and_redundancy_filter_match_jax"),
        "make_record": ("pipeline/extraction.py:make_record",
                        "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "build_shard": ("pipeline/extraction.py:build_shard",
                        "test_torch_parity_pipeline.py::test_records_shards_and_stores_match_jax"),
        "run_extraction": (
            "pipeline/extraction.py:run_extraction",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/filters.py": {
        "indoor_filter": ("pipeline/filters.py:indoor_filter",
                          "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
        "person_filter": ("pipeline/filters.py:person_filter",
                          "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
        "indoor_probability": ("pipeline/filters.py:indoor_probability",
                               "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
        "gaussian_smooth_round": ("pipeline/filters.py:gaussian_smooth_round",
                                  "test_torch_parity_pipeline.py::test_smoothing_matches_jax"),
        "smooth_window_round": ("pipeline/filters.py:smooth_window_round",
                                "test_torch_parity_pipeline.py::test_smoothing_matches_jax"),
        "filter_frames": (
            "pipeline/filters.py:filter_frames",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "places365_indoor_probs": ("pipeline/filters.py:places365_indoor_probs",
                                   "test_torch_places365.py::test_scorers_and_votes_equal"),
        "write_indoor_tsv": (
            "pipeline/filters.py:write_indoor_tsv",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "write_indoor_order_tsv": (
            "pipeline/filters.py:write_indoor_order_tsv",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
        "run_indoor_filter": (
            "pipeline/filters.py:run_indoor_filter",
            "test_torch_places365.py::test_run_indoor_filter_artifacts_byte_equal"),
        "run_maskrcnn_filter": (
            "pipeline/filters.py:run_maskrcnn_filter",
            "test_torch_maskrcnn.py::test_run_maskrcnn_filter_json_byte_equal"),
        "write_maskrcnn_filters": ("pipeline/filters.py:write_maskrcnn_filters",
                                   "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
        "load_maskrcnn_filters": ("pipeline/filters.py:load_maskrcnn_filters",
                                  "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
        "frame_passes": ("pipeline/filters.py:frame_passes",
                         "test_torch_parity_pipeline.py::test_frame_filters_match_jax"),
    },
    "youtube_vln_tpu/pipeline/frames.py": {
        "load_video_ids": ("pipeline/frames.py:load_video_ids",
                           "test_torch_parity_pipeline.py::test_video_lists_match_jax"),
        "build_ydl_opts": ("pipeline/frames.py:build_ydl_opts",
                           "test_torch_tools_host.py::test_download_recipe_matches_jax"),
        "remaining_video_ids": ("pipeline/frames.py:remaining_video_ids",
                                "test_torch_parity_pipeline.py::test_video_lists_match_jax"),
        "RetryableDownloadError": ("pipeline/frames.py:RetryableDownloadError",
                                   "test_torch_tools_host.py::test_download_recipe_matches_jax"),
        "download_videos": ("pipeline/frames.py:download_videos",
                            "test_torch_tools_host.py::test_download_recipe_matches_jax"),
        "extract_frames": ("pipeline/frames.py:extract_frames",
                           "test_torch_tools_host.py::test_frame_extraction_matches_jax"),
        "extract_all": ("pipeline/frames.py:extract_all",
                        "test_torch_tools_host.py::test_frame_extraction_matches_jax"),
    },
    "youtube_vln_tpu/pipeline/inverse_action.py": {
        "init_inverse_params": (
            "pipeline/inverse_action.py:InverseActionHead.init_weights",
            "test_torch_parity_pipeline.py::test_initialisers_give_the_port_layout"),
        "inverse_forward": ("pipeline/inverse_action.py:InverseActionHead.forward",
                            "test_torch_inverse_action.py::test_forward_matches_jax"),
        "train_inverse_model": ("pipeline/inverse_action.py:train_inverse_model",
                                "test_torch_inverse_action.py::test_adam_steps_match_optax"),
        "encode_frames": (
            "pipeline/inverse_action.py:encode_frames",
            "test_torch_inverse_action.py::test_encode_frames_and_predict_actions_match_jax"),
        "image_pair_batches": (
            "pipeline/inverse_action.py:image_pair_batches",
            "test_torch_parity_pipeline.py::test_image_pairs_and_their_training_feed_match_jax"),
        "train_inverse_model_from_images": (
            "pipeline/inverse_action.py:train_inverse_model_from_images",
            "test_torch_parity_pipeline.py::test_image_pairs_and_their_training_feed_match_jax"),
        "predict_actions": (
            "pipeline/inverse_action.py:predict_actions",
            "test_torch_inverse_action.py::test_encode_frames_and_predict_actions_match_jax"),
        "write_action_profiles": ("pipeline/inverse_action.py:write_action_profiles",
                                  "test_torch_inverse_action.py::test_action_profiles_byte_equal"),
    },
    "youtube_vln_tpu/pipeline/maskrcnn.py": {
        "init_maskrcnn_params": (
            "pipeline/maskrcnn.py:MaskRCNN.init_weights",
            "test_torch_parity_pipeline.py::test_initialisers_give_the_port_layout"),
        "params_from_torch_state_dict": (
            "models/weights.py:maskrcnn_state_dict_from_jax_params",
            "test_torch_maskrcnn.py::test_state_dict_layouts_and_jax_carrier"),
        "backbone_fpn": ("pipeline/maskrcnn.py:backbone_fpn",
                         "test_torch_maskrcnn.py::test_backbone_fpn_rpn_boxhead_match_jax"),
        "rpn_head": ("pipeline/maskrcnn.py:rpn_head",
                     "test_torch_maskrcnn.py::test_backbone_fpn_rpn_boxhead_match_jax"),
        "box_head": ("pipeline/maskrcnn.py:box_head",
                     "test_torch_maskrcnn.py::test_backbone_fpn_rpn_boxhead_match_jax"),
        "roi_align": ("pipeline/maskrcnn.py:roi_align",
                      "test_torch_maskrcnn.py::test_roi_align_matches_jax"),
        "cell_anchors": ("pipeline/maskrcnn.py:cell_anchors",
                         "test_torch_parity_pipeline.py::test_anchors_and_box_coding_match_jax"),
        "grid_anchors": ("pipeline/maskrcnn.py:grid_anchors",
                         "test_torch_parity_pipeline.py::test_anchors_and_box_coding_match_jax"),
        "decode_boxes": ("pipeline/maskrcnn.py:decode_boxes",
                         "test_torch_parity_pipeline.py::test_anchors_and_box_coding_match_jax"),
        "clip_boxes": ("pipeline/maskrcnn.py:clip_boxes",
                       "test_torch_parity_pipeline.py::test_anchors_and_box_coding_match_jax"),
        "nms": ("pipeline/maskrcnn.py:nms",
                "test_torch_parity_pipeline.py::test_nms_keeps_the_jax_order"),
        "batched_nms": ("pipeline/maskrcnn.py:batched_nms",
                        "test_torch_parity_pipeline.py::test_nms_keeps_the_jax_order"),
        "MaskRCNNDetector": ("pipeline/maskrcnn.py:MaskRCNNDetector",
                             "test_torch_maskrcnn.py::test_detect_matches_jax"),
        "person_flags_for_frames": ("pipeline/maskrcnn.py:person_flags_for_frames",
                                    "test_torch_maskrcnn.py::test_detect_matches_jax"),
    },
    "youtube_vln_tpu/pipeline/merge_photos.py": {
        "merge_video_frames": ("pipeline/merge_photos.py:merge_video_frames",
                               "test_torch_parity_pipeline.py::test_merge_methods_match_jax"),
        "merge_dataset": (
            "pipeline/merge_photos.py:merge_dataset",
            "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax"),
    },
    "youtube_vln_tpu/pipeline/places365.py": {
        "init_places_params": (
            "pipeline/places365.py:WideResNet18.init_weights",
            "test_torch_parity_pipeline.py::test_initialisers_give_the_port_layout"),
        "params_from_torch_state_dict": (
            "models/weights.py:places_state_dict_from_jax_params",
            "test_torch_places365.py::test_jax_tree_carriers_give_back_the_state_dict"),
        "places_forward": ("pipeline/places365.py:places_forward",
                           "test_torch_places365.py::test_wideresnet18_matches_jax"),
        "resnet18_backbone_forward": (
            "pipeline/places365.py:resnet18_backbone_forward",
            "test_torch_places365.py::test_resnet18_backbone_matches_jax"),
        "preprocess_images": ("pipeline/places365.py:preprocess_images",
                              "test_torch_places365.py::test_preprocessors_match_jax_resize"),
        "init_alexnet_params": (
            "pipeline/places365.py:AlexNet.init_weights",
            "test_torch_parity_pipeline.py::test_initialisers_give_the_port_layout"),
        "alexnet_params_from_torch_state_dict": (
            "models/weights.py:alexnet_state_dict_from_jax_params",
            "test_torch_places365.py::test_jax_tree_carriers_give_back_the_state_dict"),
        "alexnet_forward": ("pipeline/places365.py:AlexNet.forward",
                            "test_torch_places365.py::test_alexnet_matches_jax"),
        "preprocess_images_crop": ("pipeline/places365.py:preprocess_images_crop",
                                   "test_torch_places365.py::test_preprocessors_match_jax_resize"),
        "alexnet_indoor_probs": ("pipeline/places365.py:alexnet_indoor_probs",
                                 "test_torch_places365.py::test_alexnet_indoor_probs_equal"),
        "is_indoor": ("pipeline/places365.py:is_indoor",
                      "test_torch_places365.py::test_alexnet_indoor_probs_equal"),
        "score_batch": ("pipeline/places365.py:score_batch",
                        "test_torch_places365.py::test_scorers_and_votes_equal"),
        "indoor_scores": ("pipeline/places365.py:indoor_scores",
                          "test_torch_places365.py::test_scorers_and_votes_equal"),
    },
    "youtube_vln_tpu/training/checkpoint.py": {
        "checkpoint_path": ("training/checkpoint.py:checkpoint_path",
                            "test_torch_checkpoint.py::test_checkpoint_paths_and_delete"),
        "save_checkpoint": (
            "training/checkpoint.py:save_checkpoint",
            "test_torch_checkpoint.py::test_jax_load_checkpoint_reads_the_port_file"),
        "resolve_pretrained": (
            "training/checkpoint.py:resolve_pretrained",
            "test_torch_checkpoint.py::test_jax_load_checkpoint_reads_the_port_file"),
        "load_checkpoint": (
            "training/checkpoint.py:load_checkpoint",
            "test_torch_checkpoint.py::test_jax_checkpoint_loads_into_equal_tensors"),
        "delete_checkpoint": ("training/checkpoint.py:delete_checkpoint",
                              "test_torch_checkpoint.py::test_checkpoint_paths_and_delete"),
        "is_orbax_checkpoint": ("training/checkpoint.py:is_orbax_checkpoint",
                                "test_torch_parity_host.py::test_is_orbax_checkpoint_matches_jax"),
        "save_orbax": ORBAX,
        "orbax_entries": ORBAX,
        "load_orbax": ORBAX,
    },
    "youtube_vln_tpu/training/engine.py": {
        "Subset": ("training/engine.py:Subset",
                   "test_torch_engine.py::test_subset_hides_only_its_own_fields"),
        "resolve_tokenizer": ("training/engine.py:resolve_tokenizer",
                              "test_torch_engine.py::test_train_epoch_losses_match_jax"),
        "pretrain_caption_path": ("training/engine.py:pretrain_caption_path",
                                  "test_torch_engine.py::test_dataset_paths_match_jax"),
        "testset_paths": ("training/engine.py:testset_paths",
                          "test_torch_engine.py::test_dataset_paths_match_jax"),
        "load_pretrain_datasets": ("training/engine.py:load_pretrain_datasets",
                                   "test_torch_engine.py::test_train_epoch_losses_match_jax"),
        "load_beam_dataset": ("training/engine.py:load_beam_dataset",
                              "test_torch_engine.py::test_evaluate_matches_jax"),
        "maybe_enable_compilation_cache": XLA_CACHE,
        "Engine": ("training/engine.py:Engine",
                   "test_torch_engine.py::test_train_epoch_losses_match_jax"),
    },
    "youtube_vln_tpu/training/losses.py": {
        "pad_packed": ("training/losses.py:pad_packed",
                       "test_torch_losses.py::test_pad_packed_masks_padded_candidates"),
        "masked_vision_loss": ("training/losses.py:masked_vision_loss",
                               "test_torch_losses.py::test_masked_vision_loss"),
        "masked_language_loss": ("training/losses.py:masked_language_loss",
                                 "test_torch_losses.py::test_masked_language_loss"),
        "ranking_loss_train": ("training/losses.py:ranking_loss_train",
                               "test_torch_losses.py::test_ranking_loss_train"),
        "ranking_loss_eval": ("training/losses.py:ranking_loss_eval",
                              "test_torch_losses.py::test_ranking_loss_eval"),
        "traj_judge_targets": ("training/losses.py:traj_judge_targets",
                               "test_torch_losses.py::test_traj_judge_targets"),
        "traj_judge_loss": ("training/losses.py:traj_judge_loss",
                            "test_torch_losses.py::test_traj_judge_loss"),
        "compute_task_losses": ("training/losses.py:compute_task_losses",
                                "test_torch_losses.py::test_compute_task_losses"),
        "masked_vision_loss_sparse": ("training/losses.py:masked_vision_loss_sparse",
                                      "test_torch_losses.py::test_masked_vision_loss_sparse"),
    },
    "youtube_vln_tpu/training/optimization.py": {
        "constant_schedule": (
            "training/optimization.py:constant_schedule",
            "test_torch_optimization.py::test_schedules_match_jax_over_50_steps"),
        "warmup_linear_schedule": (
            "training/optimization.py:warmup_linear_schedule",
            "test_torch_optimization.py::test_schedules_match_jax_over_50_steps"),
        "warmup_constant_schedule": (
            "training/optimization.py:warmup_constant_schedule",
            "test_torch_optimization.py::test_schedules_match_jax_over_50_steps"),
        "warmup_cosine_schedule": (
            "training/optimization.py:warmup_cosine_schedule",
            "test_torch_parity_host.py::test_cosine_schedules_over_other_cycle_counts_match_jax"),
        "warmup_cosine_hard_restarts_schedule": (
            "training/optimization.py:warmup_cosine_hard_restarts_schedule",
            "test_torch_parity_host.py::test_cosine_schedules_over_other_cycle_counts_match_jax"),
        "make_schedule": ("training/optimization.py:make_schedule",
                          "test_torch_optimization.py::test_make_schedule_matches_jax"),
        "AdamWRefState": (
            "training/checkpoint.py:AdamWRefState",
            "test_torch_checkpoint.py::test_jax_optimizer_state_resumes_in_the_port"),
        "no_decay_mask": ("training/optimization.py:is_no_decay",
                          "test_torch_optimization.py::test_no_decay_set_matches_the_jax_mask"),
        "FusedGradientTransformation": (
            "training/optimization.py:AdamWRef",
            "test_torch_optimization.py::test_adamw_ref_matches_jax_apply"),
        "adamw_ref": ("training/optimization.py:AdamWRef.step",
                      "test_torch_optimization.py::test_adamw_ref_matches_jax_apply"),
        "make_optimizer": ("parallel/train_step.py:create_train_state",
                           "test_torch_engine.py::test_train_epoch_losses_match_jax",
                           "youtube_vln_tpu/training/engine.py"),
    },
    "youtube_vln_tpu/utils/cli.py": {
        "boolean_string": ("utils/cli.py:boolean_string",
                           "test_torch_cli.py::test_flag_set_and_defaults_equal_the_jax_parser"),
        "get_parser": ("utils/cli.py:get_parser",
                       "test_torch_cli.py::test_flag_set_and_defaults_equal_the_jax_parser"),
        "args_to_run_config": ("utils/cli.py:args_to_run_config",
                               "test_torch_parity_host.py::test_args_to_run_config_matches_jax"),
        "parse_run_config": ("utils/cli.py:parse_run_config",
                             "test_torch_cli.py::test_run_config_and_model_config_equal_jax"),
    },
    "youtube_vln_tpu/utils/entry.py": {
        "build_model_config": ("utils/entry.py:build_model_config",
                               "test_torch_cli.py::test_run_config_and_model_config_equal_jax"),
    },
    "youtube_vln_tpu/utils/file_cache.py": {
        "url_to_filename": (
            "utils/file_cache.py:url_to_filename",
            "test_torch_tools_host.py::test_url_from_pretrained_resolves_through_the_cache"),
        "filename_to_url": ("utils/file_cache.py:filename_to_url",
                            "test_torch_tools_host.py::test_file_cache_lookup_matches_jax"),
        "split_s3_path": ("utils/file_cache.py:split_s3_path",
                          "test_torch_tools_host.py::test_file_cache_lookup_matches_jax"),
        "get_from_cache": ("utils/file_cache.py:get_from_cache",
                           "test_torch_tools_host.py::test_file_cache_lookup_matches_jax"),
        "cached_path": ("utils/file_cache.py:cached_path",
                        "test_torch_tools_host.py::test_file_cache_lookup_matches_jax"),
    },
    "youtube_vln_tpu/utils/misc.py": {
        "get_logger": ("utils/misc.py:get_logger",
                       "test_torch_parity_host.py::test_misc_helpers_match_jax"),
        "NoneLogger": ("utils/misc.py:NoneLogger",
                       "test_torch_cli.py::test_code_snapshot_equals_jax"),
        "set_seed": ("utils/misc.py:set_seed",
                     "test_torch_parity_host.py::test_misc_helpers_match_jax"),
        "increment_path": ("utils/misc.py:increment_path",
                           "test_torch_cli.py::test_increment_path_and_dump_config_agree"),
        "get_output_dir": ("utils/misc.py:get_output_dir",
                           "test_torch_parity_host.py::test_misc_helpers_match_jax"),
        "git_revision": ("utils/misc.py:git_revision",
                         "test_torch_parity_host.py::test_misc_helpers_match_jax"),
        "save_code_snapshot": ("utils/misc.py:save_code_snapshot",
                               "test_torch_cli.py::test_code_snapshot_equals_jax"),
        "dump_config": ("utils/misc.py:dump_config",
                        "test_torch_cli.py::test_increment_path_and_dump_config_agree"),
    },
    "scripts/bench_e2e.py": {
        "batch_nbytes": ("entries/bench_e2e.py:batch_nbytes",
                         "test_torch_tools.py::test_bench_e2e_line"),
        "main": ("entries/bench_e2e.py:main", "test_torch_tools.py::test_bench_e2e_line"),
    },
    "scripts/bench_loader.py": {
        "bench_eval": ("entries/bench_loader.py:bench_eval",
                       "test_torch_tools.py::test_bench_loader_eval_bytes_match_jax"),
        "main": ("entries/bench_loader.py:main",
                 "test_torch_tools.py::test_bench_loader_eval_bytes_match_jax"),
    },
    "scripts/bench_serving.py": {
        "build_eval_batch": BENCH_RERANK,
        "build_dedup_eval_batch": BENCH_RERANK,
        "make_jitter": BENCH_RERANK,
        "time_dispatch_windows": BENCH_RERANK,
        "main": BENCH_RERANK,
    },
    "scripts/build_testset.py": {
        "main": ("entries/build_testset.py:main",
                 "test_torch_pipeline_chain.py::test_port_chain_artifacts_byte_equal_to_jax",
                 "youtube_vln_tpu/pipeline/build_dataset.py"),
    },
    "scripts/calculate_metrics.py": {
        "main": ("entries/calculate_metrics.py:main",
                 "test_torch_test_entry.py::test_calculate_metrics_matches_the_script"),
    },
    "scripts/check_kernels_tpu.py": {
        "main": ("entries/check_kernels.py:main",
                 "test_torch_tools.py::test_check_kernels_passes_on_the_plain_twins"),
        "bwd_probe_attribution": (
            "entries/check_kernels.py:bwd_probe_attribution",
            "test_torch_tools.py::test_check_kernels_attribution_on_a_small_model"),
        "multichip_dropout_check": (
            "entries/check_kernels.py:multichip_dropout_check",
            "test_torch_tools.py::test_check_kernels_passes_on_the_plain_twins"),
    },
    "scripts/clip_features.py": {
        "main": ("entries/clip_features.py:main",
                 "test_torch_clip.py::test_clip_tsv_build_and_resume",
                 "youtube_vln_tpu/pipeline/clip_model.py"),
    },
    "scripts/convert_lmdb.py": {
        "main": ("entries/convert_lmdb.py:main",
                 "test_torch_tools_host.py::test_convert_lmdb_matches_jax",
                 "youtube_vln_tpu/data/store.py"),
    },
    "scripts/convert_tsv.py": {
        "main": ("entries/convert_tsv.py:main",
                 "test_torch_pipeline_chain.py::test_entries_write_what_the_scripts_write"),
    },
    "scripts/extract_features.py": {
        "main": ("entries/extract_features.py:main",
                 "test_torch_pipeline_chain.py::test_entries_write_what_the_scripts_write"),
    },
    "scripts/extract_frames.py": {
        "main": ("entries/extract_frames.py:main",
                 "test_torch_tools_host.py::test_frame_extraction_matches_jax",
                 "youtube_vln_tpu/pipeline/frames.py"),
    },
    "scripts/merge_photos.py": {
        "main": ("entries/merge_photos.py:main",
                 "test_torch_pipeline_chain.py::test_entries_write_what_the_scripts_write"),
    },
    "scripts/merge_stores.py": {
        "main": (
            "entries/merge_stores.py:main",
            "test_torch_tools_host.py::test_merge_stores_matches_jax_and_restores_native_path",
            "youtube_vln_tpu/data/store.py"),
    },
    "scripts/northstar.py": {
        "ensure_store": ("entries/northstar.py:ensure_store",
                         "test_torch_tools.py::test_northstar_pass_and_fail"),
        "main": ("entries/northstar.py:main", "test_torch_tools.py::test_northstar_pass_and_fail"),
    },
    "scripts/profile_step.py": {
        "build_batch": ("utils/measure.py:pretrain_batch",
                        "test_torch_tools.py::test_profile_step_variants"),
        "time_fn": ("entries/profile_step.py:Profiler.time",
                    "test_torch_tools.py::test_profile_step_variants"),
        "main": ("entries/profile_step.py:main",
                 "test_torch_tools.py::test_profile_step_variants"),
    },
    "train.py": {
        "main": ("entries/train.py:main",
                 "test_torch_train_entry.py::test_entry_matches_the_jax_entry"),
    },
    "pretrain.py": {
        "main": ("entries/pretrain.py:main",
                 "test_torch_train_entry.py::test_entry_matches_the_jax_entry"),
    },
    "test.py": {
        "main": ("entries/test.py:main",
                 "test_torch_test_entry.py::test_entry_matches_jax_test_py"),
    },
    "bench.py": {
        "main": BENCH_TRAIN,
        "bench_eval_path": BENCH_RERANK,
    },
    "__graft_entry__.py": {
        "entry": GRAFT,
        "dryrun_multichip": DRYRUN,
    },
}


def _jax_files():
    """The JAX package's files, ``scripts/*.py`` and the root entries, as
    repository paths."""
    files = [p.relative_to(REPO) for p in sorted(JAX.rglob("*.py"))]
    files += [p.relative_to(REPO) for p in sorted((REPO / "scripts").glob("*.py"))]
    return [str(p) for p in files] + list(ROOT_ENTRIES)


@functools.lru_cache(maxsize=None)
def _tree(path):
    return ast.parse((REPO / path).read_text())


def _public_names(path):
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _defines(path, dotted):
    """Whether ``path`` defines ``Name`` at its top level or ``Class.method``."""
    body = _tree(path).body
    for part in dotted.split("."):
        found = [n for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 and n.name == part]
        if not found:
            return False
        body = found[0].body if isinstance(found[0], ast.ClassDef) else []
    return True


def _package_exports(module):
    """{name: submodule} that a JAX package's ``__init__.py`` imports from
    its own modules."""
    init = REPO / Path(*module.split(".")) / "__init__.py"
    out = {}
    if init.is_file():
        for n in ast.parse(init.read_text()).body:
            if isinstance(n, ast.ImportFrom) and n.level == 1:
                for a in n.names:
                    out[a.name] = f"{module}.{n.module}" if n.module else f"{module}.{a.name}"
    return out


@functools.lru_cache(maxsize=None)
def _reached(test_file):
    """The JAX modules that a test file imports (re-exports resolved) and the
    string constants it holds (the scripts it loads by path)."""
    modules, strings = set(), set()
    for n in ast.walk(_tree(f"tests/{test_file}")):
        if isinstance(n, ast.Import):
            modules.update(a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            modules.add(n.module)
            exports = _package_exports(n.module)
            for a in n.names:
                modules.add(exports.get(a.name, f"{n.module}.{a.name}"))
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            strings.add(n.value)
    return frozenset(modules), frozenset(strings)


def _reaches(test_file, jax_file):
    modules, strings = _reached(test_file)
    if jax_file.startswith("youtube_vln_tpu/"):
        return jax_file[:-3].replace("/", ".") in modules
    name = Path(jax_file).name
    return bool({name, name[:-3], jax_file} & strings)


@functools.lru_cache(maxsize=None)
def _test_functions(test_file):
    return {n.name for n in _tree(f"tests/{test_file}").body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}


def test_counterpart_map_lists_every_jax_file():
    """A file with a public name has its entry, and no entry is stale."""
    assert set(COUNTERPARTS) == {f for f in _jax_files() if _public_names(f)}


@pytest.mark.parametrize("jax_file", sorted(COUNTERPARTS))
def test_counterpart_map_holds_for_the_file(jax_file):
    entries = COUNTERPARTS[jax_file]
    assert set(entries) == _public_names(jax_file), "missing or stale keys"
    for name, value in entries.items():
        where = f"{jax_file}:{name}"
        if isinstance(value, str):
            assert value.strip() and "\n" not in value, where
            continue
        target, test, *via = value
        module, dotted = target.split(":")
        assert (PORT / module).is_file() and _defines(
            f"youtube_vln_tpu_torch/{module}", dotted), f"{where}: no {target}"
        test_file, test_name = test.split("::")
        assert test_file.startswith("test_torch_") and (TESTS / test_file).is_file(), where
        assert test_name in _test_functions(test_file), f"{where}: no {test}"
        assert not via or via[0] in COUNTERPARTS, f"{where}: via {via}"
        assert _reaches(test_file, via[0] if via else jax_file), (
            f"{where}: {test_file} reaches neither the file nor a caller of it")


@pytest.mark.parametrize("jax_file", BENCHMARK_FILES)
def test_benchmark_reasons_name_cells(jax_file):
    """Each name of a timing script that the benchmark replaced names
    workloads of ``BENCHMARK.json`` and metrics that those workloads
    report, so renaming a cell or a metric there breaks the map here."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    workloads = {w["name"] for w in bench["workloads"]}
    metrics = {m["name"]: set(m.get("workloads") or workloads)
               for m in bench["end_to_end"] + bench["per_layer"]}
    for name, reason in COUNTERPARTS[jax_file].items():
        match = re.search(r"cells ([\w.]+(?:, [\w.]+)*); metrics ([\w.]+(?:, [\w.]+)*)$",
                          reason if isinstance(reason, str) else "")
        assert match, f"{jax_file}:{name} names no benchmark cell: {reason}"
        cells, named = (g.split(", ") for g in match.groups())
        assert set(cells) <= workloads, f"{jax_file}:{name}: {cells}"
        for metric in named:
            assert metric in metrics and set(cells) <= metrics[metric], (
                f"{jax_file}:{name}: {metric} is not a metric of {cells}")
