"""Beam re-ranking evaluation entry point (the counterpart of the repo's
``test.py``, reference ``test.py``).

    python -m youtube_vln_tpu_torch.entries.test --split val_unseen \\
        --from_pretrained best_unseen.bin [--device cpu] ...

Forces num_beams=1 (disables beam-count filtering), batch_size=1,
ranking=True (reference test.py:46-49); scores ALL ranked paths per
instruction on the CUDA device (``--device cpu`` runs on the CPU instead);
writes ``{r2r_prefix}_scores_{split}.json`` and
``{r2r_prefix}_results_{split}.json`` under
``{output_dir}/{save_name}/test_{split}{N}_{time}_{note}_``.
"""
import json
from datetime import datetime
from pathlib import Path

from ..data.features_reader import PanoFeaturesReader
from ..data.loader import Loader
from ..device import resolve_device
from ..evaluation.beam_eval import convert_scores, eval_epoch
from ..models import Lily
from ..ops._build import set_build_dir
from ..training.checkpoint import load_checkpoint
from ..training.engine import load_beam_dataset, resolve_tokenizer
from ..utils.cli import args_to_run_config, get_parser
from ..utils.entry import build_model_config
from ..utils.misc import dump_config, get_logger, increment_path, set_seed


def main(argv=None) -> str:
    """Runs the evaluation; returns the path of the results file."""
    parser = get_parser()
    parser.add_argument("--split", required=True,
                        choices=["train", "val_seen", "val_unseen", "test"])
    parser.add_argument("--random_testing", default=False,
                        action="store_true")
    ns = parser.parse_args(argv)

    # forced arguments (reference test.py:46-49)
    ns.num_beams = 1
    ns.batch_size = 1
    ns.gradient_accumulation_steps = 1
    ns.ranking = True
    args = args_to_run_config(ns)
    device = resolve_device(ns.device)
    set_build_dir(args.compilation_cache_dir)

    set_seed(args.seed)

    save_folder = increment_path(
        Path(args.output_dir) / args.save_name,
        sep=f"/test_{ns.split}", note=args.note).resolve()
    save_folder.mkdir(parents=True, exist_ok=True)
    logger = get_logger(__name__, str(save_folder / "test.log"))
    logger.info(f"Test folder: {save_folder}")

    cfg = build_model_config(args)
    cfg.ranking = True
    cfg.masked_language = False
    cfg.masked_vision = False
    dump_config(save_folder, ns, cfg)

    tokenizer = resolve_tokenizer(args)
    reader = PanoFeaturesReader(args.img_feature)
    dataset = load_beam_dataset(ns.split, args, tokenizer, reader,
                                training=False)
    loader = Loader(dataset, batch_size=1, shuffle=False, drop_last=False,
                    num_candidates=dataset.max_beam_count(),
                    with_instr_id=True, prefetch=args.host_prefetch)

    model = Lily(cfg, device=device).init_weights(args.seed)
    if args.from_pretrained and args.from_pretrained != "bert-base-uncased":
        load_checkpoint(args.from_pretrained, model)
    logger.info(f'{datetime.now():%Y-%m-%d %H:%M} begin evaluation')

    all_scores = eval_epoch(model, cfg, loader, device=device,
                            random_testing=ns.random_testing,
                            seed=args.seed, prefetch=args.host_prefetch)

    scores_path = save_folder / f"{args.r2r_prefix}_scores_{ns.split}.json"
    with open(scores_path, "w") as f:
        json.dump(all_scores, f)
    logger.info(f"saving scores: {scores_path}")

    beam_path = (f"{args.data_dir}/beamsearch/{args.beam_prefix}"
                 f"beams_{ns.split}.json")
    all_results = convert_scores(all_scores, beam_path)
    results_path = save_folder / f"{args.r2r_prefix}_results_{ns.split}.json"
    with open(results_path, "w") as f:
        json.dump(all_results, f)
    logger.info(f"saving results: {results_path}")
    reader.close()
    return str(results_path)


if __name__ == "__main__":
    main()
