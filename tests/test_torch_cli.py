"""The port's command line and run management (``youtube_vln_tpu_torch/
utils/cli.py``, ``entry.py``, ``misc.py``) against the JAX package's: the
same options with the same defaults, types, choices and actions (this pins
the flag set without the reference repository), apart from ``--device``;
no TPU-only flag left to refuse, a ``data`` x ``model`` mesh parsed and
refused against a process group of another size, and ``--remat`` /
``--profile_dir`` / ``--mesh_axes`` / ``--orbax_checkpoints`` /
``--compilation_cache_dir`` (the kernels' build directory) parsed; ``args_to_run_config`` and
``build_model_config`` equal field for field; ``increment_path``,
``dump_config`` and ``save_code_snapshot`` write the same folders and
files."""
import dataclasses
import pathlib
import re

import pytest

from youtube_vln_tpu.utils import cli as jcli
from youtube_vln_tpu.utils import entry as jentry
from youtube_vln_tpu.utils import misc as jmisc
from youtube_vln_tpu_torch.parallel import mesh as pmesh
from youtube_vln_tpu_torch.utils import cli as pcli
from youtube_vln_tpu_torch.utils import entry as pentry
from youtube_vln_tpu_torch.utils import misc as pmisc


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def _signature(action):
    # each package has its own boolean_string: compare types by name
    return (tuple(action.option_strings), action.default,
            getattr(action.type, "__name__", action.type),
            action.choices, action.nargs, action.const, type(action).__name__,
            action.required)


def test_flag_set_and_defaults_equal_the_jax_parser():
    jax_actions, port_actions = _actions(jcli.get_parser()), _actions(pcli.get_parser())
    # the same flags in the same order, so Namespaces and config dumps agree
    assert list(port_actions) == list(jax_actions)
    jax_opts = sorted(o for a in jcli.get_parser()._actions for o in a.option_strings)
    port_opts = sorted(o for a in pcli.get_parser()._actions for o in a.option_strings)
    assert port_opts == jax_opts
    for dest, action in jax_actions.items():
        if dest == "device":
            continue
        assert _signature(port_actions[dest]) == _signature(action), dest
    device = port_actions["device"]
    assert device.default == "cuda" and device.choices == ["cuda", "cpu"]
    assert pcli.parse_run_config(["--device", "cpu"])[0].device == "cpu"
    with pytest.raises(SystemExit):
        pcli.get_parser().parse_args(["--device", "tpu"])


FLAGS = {"mesh_shape": ["--mesh_shape", "2", "4"],
         "mesh_axes": ["--mesh_axes", "data"],
         "remat": ["--remat"],
         "profile_dir": ["--profile_dir", "traces"],
         "compilation_cache_dir": ["--compilation_cache_dir", "cache"],
         "orbax_checkpoints": ["--orbax_checkpoints"]}
PORTED = {"remat": True, "profile_dir": "traces", "mesh_axes": ("data",),
          "orbax_checkpoints": True, "mesh_shape": (2, 4),
          "compilation_cache_dir": "cache"}
REFUSED_VALUES = set()


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_tpu_only_flags_refused_unless_default(flag, monkeypatch):
    """The JAX package's TPU-only flags: those not ported yet are refused at
    any value but their default, naming the ROADMAP item that ports them;
    the ported ones (--remat, --profile_dir, --mesh_axes,
    --orbax_checkpoints, --compilation_cache_dir, and --mesh_shape with a
    model axis above 1, tensor parallelism) parse into RunConfig as they do
    in the JAX package; a mesh is refused against a process group of
    another size; the compilation cache directory is where the kernels are
    built."""
    pcli.parse_run_config([])     # every default is accepted
    assert set(pcli.TPU_ONLY) == set(FLAGS) - set(PORTED) - REFUSED_VALUES
    if flag in PORTED:
        _, args = pcli.parse_run_config(FLAGS[flag])
        assert getattr(args, flag) == PORTED[flag]
        _, jargs = jcli.parse_run_config(FLAGS[flag])
        assert getattr(jargs, flag) == PORTED[flag]
        if flag == "compilation_cache_dir":
            from youtube_vln_tpu_torch.ops import _build
            monkeypatch.setattr(_build, "_build_dir", _build.BUILD_DIR)
            _build.set_build_dir(args.compilation_cache_dir)
            for name in _build.SOURCES:
                path = _build.library_path(name)
                assert path.parent == pathlib.Path("cache") and path.name.startswith(f"lib{name}_")
            _build.set_build_dir("")
            assert _build.library_path("epilogue").parent == _build.BUILD_DIR
        if flag == "mesh_shape":
            assert pmesh.mesh_extents(args.mesh_shape, args.mesh_axes, 8) == {
                "data": 2, "model": 4}
            with pytest.raises(ValueError, match=r"\(\(2, 4\), 4\).*process group"):
                pmesh.mesh_extents(args.mesh_shape, args.mesh_axes, 4)
        return
    with pytest.raises(ValueError, match=rf"--{flag} .*ROADMAP.md Queue A item A\d+"):
        pcli.parse_run_config(FLAGS[flag])
    # the default spelled out is still accepted
    if flag == "mesh_axes":
        pcli.parse_run_config(["--mesh_axes", "data", "model"])


DATA_MESHES = [(["--mesh_shape", "4", "--mesh_axes", "data"], {"data": 4}),
               (["--mesh_shape", "2", "1"], {"data": 2, "model": 1}),
               (["--mesh_shape", "2"], {"data": 2}),
               (["--orbax_checkpoints", "--mesh_shape", "8", "1"],
                {"data": 8, "model": 1})]


@pytest.mark.parametrize("argv,extents", DATA_MESHES, ids=range(len(DATA_MESHES)))
def test_data_axis_mesh_flags_accepted(argv, extents):
    """A mesh on the data axis parses as in the JAX package and resolves
    against a process group of its data extent, and of no other size."""
    _, args = pcli.parse_run_config(argv)
    _, jargs = jcli.parse_run_config(argv)
    assert (args.mesh_shape, args.mesh_axes, args.orbax_checkpoints) == (
        jargs.mesh_shape, jargs.mesh_axes, jargs.orbax_checkpoints)
    assert pmesh.mesh_extents(args.mesh_shape, args.mesh_axes,
                              extents["data"]) == extents
    with pytest.raises(ValueError, match="process group holds"):
        pmesh.mesh_extents(args.mesh_shape, args.mesh_axes, extents["data"] + 1)


@pytest.mark.parametrize("argv,world,match", [
    (["--mesh_shape", "1", "2"], 1, r"\(\(1, 2\), 1\).*process group holds 1"),
    (["--mesh_shape", "2", "2", "--mesh_axes", "model", "data"], 8,
     r"\(\(2, 2\), 8\)"),
    (["--mesh_shape", "2", "--mesh_axes", "model"], None, "no 'data' axis"),
    (["--mesh_shape", "2", "1", "--mesh_axes", "data", "pipe"], None, "unknown axis"),
    (["--mesh_shape", "2", "1", "--mesh_axes", "data"], None, "distinct"),
], ids=range(5))
def test_mesh_beyond_the_data_axis_refused(argv, world, match):
    """A mesh that names no ``data`` axis, an unknown axis or too few names
    is refused as it parses; a data x model mesh parses (tensor
    parallelism) and is refused against a process group of another size,
    with the JAX ``make_mesh`` wording, (shape, world)."""
    with pytest.raises(ValueError, match=match):
        _, args = pcli.parse_run_config(argv)
        assert world is not None
        pmesh.mesh_extents(args.mesh_shape, args.mesh_axes, world)


def test_default_mesh_is_the_world_on_the_data_axis():
    """``make_mesh``'s default: every process on ``data``, ``model`` 1."""
    _, args = pcli.parse_run_config([])
    assert pmesh.mesh_extents(args.mesh_shape, args.mesh_axes, 3) == {
        "data": 3, "model": 1}
    assert pmesh.mesh_extents((), ("data",), 2) == {"data": 2}


RECIPES = [
    [],
    ["--ranking", "--shuffle_visual_features", "--batch_size", "16",
     "--num_beams_train", "4", "--no_dedup_beam_steps", "--from_pretrained",
     "x.bin", "--data_dir", "d", "--img_feature", "f.vlnstore"],
    ["--pre_dataset", "ytb", "--masked_vision", "--masked_language",
     "--ranking", "--traj_judge", "--ytb_feature", "a", "b",
     "--no_sparse_vision_targets", "--io_dtype", "float32", "--no_pallas",
     "--dense_task_heads", "--compute_dtype", "float32", "--host_prefetch", "3"],
    ["--dedup_candidates", "--save_name", "run", "--note", "n", "--mini",
     "--resume", "--save_epochs", "2", "--ground_truth_trajectory", "true"],
    ["--ranking", "--remat", "--profile_dir", "traces", "--gradient_accumulation_steps",
     "2", "--lr_schedule", "warmup_cosine"],
]


@pytest.mark.parametrize("argv", RECIPES, ids=range(len(RECIPES)))
def test_run_config_and_model_config_equal_jax(argv, tmp_path):
    _, jargs = jcli.parse_run_config(argv)
    ns, pargs = pcli.parse_run_config(argv)
    jfields = dataclasses.asdict(jargs)
    pfields = dataclasses.asdict(pargs)
    assert pfields.pop("use_attention_kernels") == jfields["use_pallas_attention"]
    for name, value in pfields.items():
        assert value == jfields[name], name
    # the field the port leaves out is renamed (use_attention_kernels)
    assert set(jfields) - set(pfields) == {"use_pallas_attention"}

    for config_file in (str(tmp_path / "absent.json"), "configs/bert_base_6_layer_6_connect.json"):
        jargs.config_file = pargs.config_file = config_file
        jcfg, pcfg = jentry.build_model_config(jargs), pentry.build_model_config(pargs)
        jd, pd_ = dataclasses.asdict(jcfg), dataclasses.asdict(pcfg)
        assert pd_.pop("use_attention_kernels") == jd["use_pallas_attention"]
        for name, value in pd_.items():
            if name in jd:
                assert value == jd[name], name


def test_increment_path_and_dump_config_agree(tmp_path):
    for mod, root in ((jmisc, tmp_path / "jax"), (pmisc, tmp_path / "port")):
        base = root / "result" / "model.v2"
        first = mod.increment_path(base, sep="/test_val_unseen", note="x")
        first.mkdir(parents=True)
        second = mod.increment_path(base, sep="/test_val_unseen", note="x")
        assert re.search(r"/test_val_unseen1_[\d-]+_[\d:]+_x_$", str(first))
        assert re.search(r"/test_val_unseen2_[\d-]+_[\d:]+_x_$", str(second))
    ns, args = pcli.parse_run_config(["--ranking"])
    jns, jargs = jcli.parse_run_config(["--ranking"])
    for mod, folder, a, cfg in ((jmisc, tmp_path / "dj", jns, jentry.build_model_config(jargs)),
                                (pmisc, tmp_path / "dp", ns, pentry.build_model_config(args))):
        mod.dump_config(folder, a)
        assert (folder / "config.txt").exists()
    j_txt = (tmp_path / "dj" / "config.txt").read_text()
    p_txt = (tmp_path / "dp" / "config.txt").read_text()
    # the same layout; the values differ only where the flags do (--device)
    drop = lambda t: [l for l in t.splitlines() if "'device'" not in l]
    assert drop(p_txt) == drop(j_txt)
    assert "  'device': cuda" in p_txt
    assert pcli.boolean_string("true") and not pcli.boolean_string("0")
    with pytest.raises(ValueError):
        pcli.boolean_string("yes")


def test_code_snapshot_equals_jax(tmp_path, monkeypatch):
    """The same .py files zipped, the ignored directories pruned, and the
    same rerun script; NoneLogger takes and drops what a logger takes."""
    import zipfile
    tree = tmp_path / "tree"
    for rel in ("a.py", "pkg/b.py", "pkg/notes.txt", "data/c.py",
                "result/d.py", "pkg/__pycache__/e.py"):
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(rel)
    monkeypatch.chdir(tree)
    listings = []
    for mod, out in ((jmisc, tmp_path / "j"), (pmisc, tmp_path / "p")):
        zip_path = mod.save_code_snapshot(out)
        with zipfile.ZipFile(zip_path) as zf:
            listings.append(sorted(zf.namelist()))
        listings.append((out / "sh_n_codes" / "rerun.sh").read_text())
    assert listings[0] == listings[2] == ["a.py", "pkg/b.py"]
    assert listings[1] == listings[3]
    for logger in (pmisc.NoneLogger(), jmisc.NoneLogger()):
        assert logger.info("x", 1, k=2) is None and logger.warning("y") is None
