"""deepfactors_tpu_torch/config.py against deepfactors_tpu/config.py: the
flag-line grammar, flag files with ``--flagfile`` composition (the
repository's data/flags, read where they are), CLI overrides, the typed
configs built from them, the JSON network configs and the run-flags
provenance file.

What must agree: every field of the ``SystemConfig`` and of its
``MapperConfig`` (the port's configs have the JAX package's fields, with
the same names), compared by name and value, exactly; the flag dicts and
the network configs exactly; the provenance files byte for byte. The
configs' own defaults are not what a flag file falls back to
(``use_schur`` is False there and True in ``MapperConfig``), so each config
is held against the JAX package's ``build_system_config``, not against the
port's defaults."""
import os

import pytest

from deepfactors_tpu import config as jcfg
from deepfactors_tpu_torch import config as tcfg

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGS = os.path.join(ROOT, "data", "flags")
NETS = os.path.join(ROOT, "data", "nets")


def _fields(cfg) -> dict:
    out = cfg._asdict()
    out["mapper"] = out["mapper"]._asdict()
    return out


def assert_configs_equal(t, j):
    """Every field of the JAX config in the port's, equal; and no field the
    JAX config lacks."""
    ft, fj = _fields(t), _fields(j)
    assert ft["mapper"] == fj["mapper"]
    assert set(ft) == set(fj), set(ft) ^ set(fj)
    for k in fj:
        assert ft[k] == fj[k], k


@pytest.mark.parametrize("line", [
    "", "   ", "# a comment", "--pho_iters=15,15,30", "--use_geometric",
    "--nouse_schur", "  --key = value with spaces  ", "--a=b=c", "--no"])
def test_parse_flag_line_matches_jax(line):
    assert tcfg.parse_flag_line(line) == jcfg.parse_flag_line(line)


def test_parse_flag_line_rejects_what_jax_rejects():
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError):
            mod.parse_flag_line("pho_iters=1,2")


@pytest.mark.parametrize("name", ["common", "alg_odom", "alg_refine",
                                  "dataset_odom"])
def test_flagfiles_load_as_jax_loads_them(name):
    path = os.path.join(FLAGS, f"{name}.flags")
    flags = tcfg.load_flagfile(path)
    assert flags == jcfg.load_flagfile(path)
    assert flags["code_size"] == "32"               # from common.flags


@pytest.mark.parametrize("name,hw", [("alg_refine", (192, 256)),
                                     ("dataset_odom", (192, 256)),
                                     ("alg_refine", (48, 64)),
                                     ("common", (96, 128))])
def test_system_config_from_flagfile_matches_jax(name, hw):
    path = os.path.join(FLAGS, f"{name}.flags")
    t = tcfg.build_system_config(tcfg.load_flagfile(path), *hw)
    j = jcfg.build_system_config(jcfg.load_flagfile(path), *hw)
    assert_configs_equal(t, j)
    if name == "alg_refine":
        m = t.mapper
        assert m.use_geometric and m.use_reprojection and not m.use_schur
        assert m.pho_iters == (15, 15, 30) and m.connection_mode == "LASTN"
        assert m.max_back_connections == 4 and t.loop_closure


ARGV = [
    ["seq_dir", "--flagfile", os.path.join(FLAGS, "alg_refine.flags"),
     "--tracking_dist_threshold=5.0", "--connection_mode", "full",
     "--pyramid_levels=4", "--pho_iters=4,8", "--geo_stochastic",
     "--use_schur=1", "--loop_sigma=0.05"],
    [f"--flagfile={os.path.join(FLAGS, 'dataset_odom.flags')}",
     "--pyramid_levels=2", "--tracking_iterations=5,5,10",
     "--keyframe_mode=auto_combined", "--use_reprojection=off"],
    ["--code_size=8", "--geo_npoints", "64", "--max_keyframes=6",
     "--relinearize_threshold=0.01", "--rep_nfeatures=256"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_cli_overrides_match_jax(argv):
    ft, fj = tcfg.parse_args(list(argv)), jcfg.parse_args(list(argv))
    assert ft == fj
    assert_configs_equal(tcfg.build_system_config(ft, 48, 64),
                         jcfg.build_system_config(fj, 48, 64))


def test_cli_overrides_take_effect():
    ft = tcfg.parse_args(list(ARGV[0]))
    c = tcfg.build_system_config(ft, 48, 64)
    assert ft["__positional__"] == ["seq_dir"]
    assert c.tracking_dist_threshold == 5.0 and c.mapper.use_schur
    assert c.mapper.connection_mode == "FULL" and c.mapper.geo_stochastic
    # pho_iters padded to the pyramid with its last entry
    assert c.mapper.pyramid_levels == 4 and c.mapper.pho_iters == (4, 8, 8, 8)
    assert c.tracking_iterations == (10, 5, 4, 4)


@pytest.mark.parametrize("flag", ["--connection_mode=SOME",
                                  "--keyframe_mode=ALWAYS",
                                  "--tracking_mode=NEAREST"])
def test_invalid_enum_raises_in_both(flag):
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError):
            mod.build_system_config(mod.parse_args([flag]), 48, 64)


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(NETS) if f.endswith(".json")))
def test_network_config_matches_jax(name):
    path = os.path.join(NETS, f"{name}.json")
    t, j = tcfg.load_network_config(path), jcfg.load_network_config(path)
    assert t._asdict() == j._asdict()


def test_save_run_flags_matches_jax(tmp_path):
    flags = tcfg.parse_args(list(ARGV[0]))
    tcfg.save_run_flags(str(tmp_path / "t"), flags)
    jcfg.save_run_flags(str(tmp_path / "j"), dict(flags))
    a = (tmp_path / "t" / "flags.txt").read_bytes()
    assert a == (tmp_path / "j" / "flags.txt").read_bytes()
    assert b"__positional__" not in a
    back = tcfg.load_flagfile(str(tmp_path / "t" / "flags.txt"))
    assert back == {k: v for k, v in flags.items() if k != "__positional__"}
