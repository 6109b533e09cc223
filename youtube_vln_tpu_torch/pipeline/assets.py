"""External asset manifest + offline fetch (a copy of
``youtube_vln_tpu/pipeline/assets.py``, reference ``scripts/download.py``;
host code, no torch).

Full coverage of the reference's download recipe: beam-search files (beams
AND upstream scores), the model-topology config, speaker-augmented data,
the R2R task JSONs, the 90-scan Matterport connectivity file list, and
distance-table generation from the downloaded graphs
(``scripts/download.py:14-309``), on the port's ``data/nav_graph.py``.

:func:`fetch` resolves local files and entries of the offline file cache
(``utils/file_cache.py:cached_path``) and otherwise reports exactly what to
place where; this package downloads nothing.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.file_cache import cached_path

logger = logging.getLogger(__name__)

# target path -> source URL.  Categories mirror the reference's link lists
# (download.py:14-79,176-195).
BEAMSEARCH_ASSETS: Dict[str, str] = {
    "data/beamsearch/beams_test.json":
        "https://dl.dropboxusercontent.com/s/gpnm54l903fms63/beams_test.json",
    "data/beamsearch/beams_train.json":
        "https://dl.dropboxusercontent.com/s/ci47p5ybitahnqx/beams_train.json",
    "data/beamsearch/beams_val_seen.json":
        "https://dl.dropboxusercontent.com/s/1o6xmjjv74mq8f8/beams_val_seen.json",
    "data/beamsearch/beams_val_unseen.json":
        "https://dl.dropboxusercontent.com/s/5m5by9ralaim5nb/beams_val_unseen.json",
    "data/beamsearch/scores_test.json":
        "https://dl.dropboxusercontent.com/s/49u8vp01sbh9nfl/scores_test.json",
    "data/beamsearch/scores_val_seen.json":
        "https://dl.dropboxusercontent.com/s/fx4o7ob23h4ei9k/scores_val_seen.json",
    "data/beamsearch/scores_val_unseen.json":
        "https://dl.dropboxusercontent.com/s/aggdqj19ruttkci/scores_val_unseen.json",
}

CONFIG_ASSETS: Dict[str, str] = {
    "data/config/bert_base_6_layer_6_connect.json":
        "https://drive.google.com/uc?id=17mL0qCWnIjqL2GNku8A7CKAi6A8Scogh",
}

SPEAKER_ASSETS: Dict[str, str] = {
    "data/task/aug+R2R_train.json":
        "https://drive.google.com/uc?id=1cA2GRF_EGB8cw_XIxk8b6TXSEaWZEDk7",
    "data/beamsearch/aug_beams_train.json":
        "https://drive.google.com/uc?id=1ukpTRI6LelEl0_gk10azW_Td95XANL2e",
}

TASK_ASSETS: Dict[str, str] = {
    "data/task/R2R_test.json":
        "https://dl.dropboxusercontent.com/s/w4pnbwqamwzdwd1/R2R_test.json",
    "data/task/R2R_train.json":
        "https://dl.dropboxusercontent.com/s/hh5qec8o5urcztn/R2R_train.json",
    "data/task/R2R_val_seen.json":
        "https://dl.dropboxusercontent.com/s/8ye4gqce7v8yzdm/R2R_val_seen.json",
    "data/task/R2R_val_unseen.json":
        "https://dl.dropboxusercontent.com/s/p6hlckr70a07wka/R2R_val_unseen.json",
}

# model weights the reference's pipeline scripts wget at first run
# (filter_outdoor_resnet_place365.py:52-56, filter_outdoor_maskrcnn_coco.py:
# 53-58 + torchvision's pretrained=True download); import paths:
# places365.params_from_torch_state_dict / alexnet_params_from_torch_
# state_dict / maskrcnn.params_from_torch_state_dict
MODEL_WEIGHT_ASSETS: Dict[str, str] = {
    "data/YouTube-VLN/model4youtube/wideresnet18_places365.pth.tar":
        "http://places2.csail.mit.edu/models_places365/"
        "wideresnet18_places365.pth.tar",
    "data/YouTube-VLN/model4youtube/alexnet_places365.pth.tar":
        "http://places2.csail.mit.edu/models_places365/"
        "alexnet_places365.pth.tar",
    "data/YouTube-VLN/model4youtube/categories_places365.txt":
        "https://raw.githubusercontent.com/csailvision/places365/master/"
        "categories_places365.txt",
    "data/YouTube-VLN/model4youtube/maskrcnn_resnet50_fpn_coco.pth":
        "https://download.pytorch.org/models/"
        "maskrcnn_resnet50_fpn_coco-bf2d0c1e.pth",
}

ASSETS: Dict[str, str] = {**BEAMSEARCH_ASSETS, **CONFIG_ASSETS,
                          **SPEAKER_ASSETS, **TASK_ASSETS,
                          **MODEL_WEIGHT_ASSETS}

CONNECTIVITY_ROOT_URL = ("https://raw.githubusercontent.com/peteanderson80/"
                         "Matterport3DSimulator/master/connectivity")

# the 90 Matterport scans + README/scans.txt (download.py:81-174)
MATTERPORT_SCANS: List[str] = [
    "17DRP5sb8fy", "1LXtFkjw3qL", "1pXnuDYAj8r", "29hnd4uzFmX",
    "2azQ1b91cZZ", "2n8kARJN3HM", "2t7WUuJeko7", "5LpN3gDmAk7",
    "5q7pvUzZiYa", "5ZKStnWn8Zo", "759xd9YjKW5", "7y3sRwLe3Va",
    "8194nk5LbLH", "82sE5b5pLXE", "8WUmhLawc2A", "aayBHfsNo7d",
    "ac26ZMwG7aT", "ARNzJeq3xxb", "B6ByNegPMKs", "b8cTxDM8gDG",
    "cV4RVeZvu5T", "D7G3Y4RVNrH", "D7N2EKCX4Sj", "dhjEzFoUFzH",
    "E9uDoFAP3SH", "e9zR4mvMWw7", "EDJbREhghzL", "EU6Fwq7SyZv",
    "fzynW3qQPVF", "GdvgFV5R1Z5", "gTV8FGcVJC9", "gxdoqLR6rwA",
    "gYvKGZ5eRqb", "gZ6f7yhEvPG", "HxpKQynjfin", "i5noydFURQK",
    "JeFG25nYj2p", "JF19kD82Mey", "jh4fc5c5qoQ", "JmbYfDe2QKZ",
    "jtcxE69GiFV", "kEZ7cmS4wCh", "mJXqzFtmKg4", "oLBMNvg9in8",
    "p5wJjkQkbXX", "pa4otMbVnkk", "pLe4wQe7qrG", "Pm6F8kyY3z2",
    "pRbA3pwrgk9", "PuKPg4mmafe", "PX4nDJXEHrG", "q9vSo1VnCiC",
    "qoiz87JEwZ2", "QUCTc6BB5sX", "r1Q1Z4BcV1o", "r47D5H71a5s",
    "rPc6DW4iMge", "RPmz2sHmrrY", "rqfALeAoiTq", "s8pcmisQ38h",
    "S9hNv5qa7GM", "sKLMLpTHeUy", "SN83YJsR3w2", "sT4fr6TAbpF",
    "TbHJrupSAjP", "ULsKaCPVFJR", "uNb9QFRL6hY", "ur6pFq6Qu1A",
    "UwV83HsGsw3", "Uxmj2M2itWa", "V2XKFyX4ASd", "VFuaQ6m2Qom",
    "VLzqgDo317F", "Vt2qJdWjCF2", "VVfe2KiqLaN", "Vvot9Ly1tCj",
    "vyrNrziPKCB", "VzqfbhrpDEA", "wc2JMjhGNzB", "WYY7iVyf5p8",
    "X7HyMhZNoso", "x8F5xyUWy9e", "XcA2TqTSSAj", "YFuZgdQ5vWj",
    "YmJkqBEsHnH", "yqstnuAEVhm", "YVUC4YcDtcY", "Z6MFQCViBuw",
    "ZMojNkEp431", "zsNo4HB9uLZ",
]

CONNECTIVITY_FILES: List[str] = (
    [f"{scan}_connectivity.json" for scan in MATTERPORT_SCANS]
    + ["README.md", "scans.txt"])


def connectivity_manifest() -> Dict[str, str]:
    """target path -> URL for every connectivity file."""
    return {f"data/connectivity/{f}": f"{CONNECTIVITY_ROOT_URL}/{f}"
            for f in CONNECTIVITY_FILES}


def fetch(target: str, data_dir: str = "data",
          allow_download: bool = False) -> Optional[Path]:
    """Resolve one asset; returns the local path or None with guidance
    (``allow_download`` reaches ``cached_path``, which downloads
    nothing)."""
    try:
        rel = Path(target).relative_to("data")
    except ValueError:
        # every known asset lives under data/; a non-data path would
        # otherwise crash here before reaching the unknown-asset branch
        logger.warning("unknown asset %s", target)
        return None
    local = Path(data_dir) / rel
    if local.exists():
        return local
    url = ASSETS.get(target) or connectivity_manifest().get(target)
    if url is None:
        logger.warning("unknown asset %s", target)
        return None
    try:
        return cached_path(url, allow_download=allow_download)
    except FileNotFoundError:
        logger.warning("asset %s unavailable offline; download %s to %s",
                       target, url, local)
        return None


def fetch_all(data_dir: str = "data", allow_download: bool = False,
              include_connectivity: bool = False) -> List[str]:
    """Returns the list of assets that could NOT be resolved."""
    targets = list(ASSETS)
    if include_connectivity:
        targets += list(connectivity_manifest())
    return [t for t in targets
            if fetch(t, data_dir, allow_download) is None]


def generate_distances(data_dir: str = "data",
                       scans: Optional[List[str]] = None) -> List[Path]:
    """All-pairs shortest-path tables from the connectivity graphs
    (reference download.py:216-299): data/connectivity/*.json ->
    data/distances/{scan}_distances.json."""
    from ..data.nav_graph import compute_distances, load_nav_graphs

    data_dir = Path(data_dir)
    if scans is None:
        scans_file = data_dir / "connectivity" / "scans.txt"
        if scans_file.exists():
            scans = scans_file.read_text().splitlines()
        else:
            scans = [p.name.replace("_connectivity.json", "")
                     for p in sorted((data_dir / "connectivity")
                                     .glob("*_connectivity.json"))]
    out_dir = data_dir / "distances"
    out_dir.mkdir(parents=True, exist_ok=True)
    graphs = load_nav_graphs(scans, data_dir)
    written = []
    for scan in scans:
        path = out_dir / f"{scan}_distances.json"
        with open(path, "w") as fid:
            json.dump(compute_distances(graphs[scan]), fid)
        written.append(path)
    return written
