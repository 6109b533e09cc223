"""Freeze eval negatives into a testset JSON (pipeline step 9; the
counterpart of ``scripts/build_testset.py``, reference
scripts/build_dataset/build_testset.py).

    python -m youtube_vln_tpu_torch.entries.build_testset --pre_dataset ytb \\
        --prefix merge+ --out testset.json ...

The flags are the training entries' (``utils/cli.py``) plus ``--out``
(default: the ranking testset path the pretrain entry reads).
"""
from ..pipeline.build_dataset import freeze_testset
from ..training.engine import load_pretrain_datasets, resolve_tokenizer, testset_paths
from ..utils.cli import args_to_run_config, get_parser


def main(argv=None) -> str:
    parser = get_parser()
    parser.add_argument("--out", default="", type=str)
    ns = parser.parse_args(argv)
    ns.ranking = True
    args = args_to_run_config(ns)
    tokenizer = resolve_tokenizer(args)
    train_ds, _, reader = load_pretrain_datasets(args, tokenizer)
    out = ns.out or testset_paths(args)["ranking"]
    path = freeze_testset(train_ds, out)
    reader.close()
    print(f"testset -> {path}")
    return str(path)


if __name__ == "__main__":
    main()
