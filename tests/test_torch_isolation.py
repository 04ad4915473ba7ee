"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its own copies of the mode object, the EN 300 744 tables,
the TS helpers, the apps' CLI plumbing, the Annex B echo tables, the
host resampler, the sample sources, the SoapySDR binding (but for its
repaired read), the native ring buffer's source and the TPS field maps
equal the JAX package's originals, and the validation tools' mode grid,
BER points and BER curves equal the lists of the repo's tools/ scripts."""

import ast
import dataclasses
import importlib.util
import inspect
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

from dvbt_tpu import mode as j_mode
from dvbt_tpu import tables as j_tables
from dvbt_tpu.apps import common as j_common
from dvbt_tpu.io import ts as j_ts
from dvbt_tpu.models import auto as j_auto
from dvbt_tpu.models import channel as j_channel
from dvbt_tpu_torch import mode as t_mode
from dvbt_tpu_torch import tables as t_tables
from dvbt_tpu_torch.apps import common as t_common
from dvbt_tpu_torch.io import ts as t_ts
from dvbt_tpu_torch.models import auto as t_auto
from dvbt_tpu_torch.models import channel as t_channel
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")
GUARDS = ("1/32", "1/16", "1/8", "1/4")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dvbt_tpu_torch\n"
        "for m in pkgutil.walk_packages(dvbt_tpu_torch.__path__,\n"
        "                               'dvbt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'dvbt_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules\n"
        "               if k.startswith('dvbt_tpu_torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert len(loaded) >= 35                       # every module imported
    assert {f"dvbt_tpu_torch.parallel.{m}" for m in
            ("multihost", "ring", "sharding", "time_sharding")} <= loaded
    assert {"dvbt_tpu_torch.apps.ber_sweep", "dvbt_tpu_torch.apps.common",
            "dvbt_tpu_torch.models.channel"} <= loaded
    assert {f"dvbt_tpu_torch.{m}" for m in (
        "native", "models.loopback", "models.auto", "utils.checkpoint",
        "utils.sanitize", "io.source", "io.soapy", "apps.tx", "apps.rx",
        "apps.loopback", "apps.device")} <= loaded
    assert {f"dvbt_tpu_torch.tools.{m}" for m in (
        "mode_grid_hw", "ber_hw", "ber_curves")} <= loaded


# the mode grid of tests/test_mode_grid.py in both transmission modes, and
# the hierarchical constellations with both LP rates of the grid's corners
GRID = [
    (tx, c, r, GUARDS[i % 4], 0, "1/2")
    for tx in ("2k", "8k")
    for i, (c, r) in enumerate(itertools.product(
        ("qpsk", "16qam", "64qam"), RATES))
] + [
    (tx, c, "2/3", "1/8", a, lp)
    for tx in ("2k", "8k") for c in ("16qam", "64qam") for a in (1, 2, 4)
    for lp in ("1/2", "7/8")
]

_PROPS = ("fft_len", "n_carriers", "kmax", "n_payload", "v", "guard_len",
          "symbol_len", "hierarchical", "alpha_eff", "bits_per_symbol",
          "streams", "info_bits_per_symbol", "frames_per_block",
          "packets_per_frame", "packets_per_block", "symbols_per_block",
          "samples_per_block", "sample_rate", "useful_bitrate")
_TABLES = ("constellation_table", "bit_interleaver_table",
           "symbol_interleaver_perm", "puncture_order", "continual_pilots",
           "tps_carriers", "wk")


@pytest.mark.parametrize("tx,const,rate,guard,alpha,rate_lp", GRID)
def test_mode_matches_jax(tx, const, rate, guard, alpha, rate_lp):
    jm = j_mode.DvbtMode(tx, const, rate, guard, alpha, rate_lp)
    tm = port_mode(jm)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for p in _PROPS:
        assert getattr(tm, p) == getattr(jm, p), p
    for s in jm.streams:
        for fn in ("stream_coded_bits_per_symbol", "stream_rate",
                   "stream_info_bits_per_symbol", "stream_packets_per_block"):
            assert getattr(tm, fn)(s) == getattr(jm, fn)(s), (fn, s)
    for fn in _TABLES:
        assert np.array_equal(getattr(tm, fn)(), getattr(jm, fn)()), fn
    for f in range(4):
        assert np.array_equal(tm.tps_bits(f), jm.tps_bits(f)), f


def test_mode_constants_match_jax():
    for name in ("CONSTELLATION_BITS", "CODE_RATES", "GUARDS",
                 "SYMBOLS_PER_FRAME", "FRAMES_PER_SUPERFRAME", "TS_PACKET",
                 "RS_PACKET", "OUTER_I", "OUTER_M"):
        assert getattr(t_mode, name) == getattr(j_mode, name), name
    for name in ("MODE_2K_QPSK", "MODE_8K_UK"):
        assert dataclasses.asdict(getattr(t_mode, name)) == \
            dataclasses.asdict(getattr(j_mode, name)), name


def _tps(t):
    return [t.tps_frame_bits(f, v, a, r, lp, g, m, cid, on)
            for f in range(4) for v, a in ((2, 0), (4, 1), (6, 4))
            for r, lp in (("1/2", "7/8"), ("5/6", "2/3"))
            for g in GUARDS for m in ("2k", "8k")
            for cid, on in ((0, False), (0x2A5, True))]


# every table of the port's copy: name -> the values it yields, computed
# the same way from either module
TABLES = {
    "dispersal_prbs_bits": lambda t: [t.dispersal_prbs_bits(),
                                      t.dispersal_prbs_bits(4000)],
    "dispersal_pattern": lambda t: [t.dispersal_pattern()],
    "gf_tables": lambda t: list(t.gf_tables()),
    "gf_mul": lambda t: [t.gf_mul(np.arange(256)[:, None],
                                  np.arange(256)[None, :])],
    "rs_generator_poly": lambda t: [t.rs_generator_poly()],
    "rs_constants": lambda t: [np.array([t.GF_POLY, t.RS_N, t.RS_K, t.RS_T,
                                         t.RS_2T, t.G1_OCT, t.G2_OCT])],
    "PUNCTURE": lambda t: [a for r in RATES for a in t.PUNCTURE[r]],
    "puncture_serial_order": lambda t: [t.puncture_serial_order(r)
                                        for r in RATES],
    "bit_interleaver_indices": lambda t: [
        t.bit_interleaver_indices(v, h)
        for v, h in ((2, False), (4, False), (6, False), (4, True),
                     (6, True))],
    "bit_interleaver_constants": lambda t: [
        np.array(t.HE_OFFSETS), np.array([t.BIT_ILV_BLOCK])]
        + [np.array(t.DEMUX[k]) for k in sorted(t.DEMUX)],
    "symbol_interleaver_perm": lambda t: [t.symbol_interleaver_perm(m)
                                          for m in ("2k", "8k")],
    "symbol_interleaver_constants": lambda t: [
        np.array(t.SYM_BIT_PERM[m]) for m in ("2k", "8k")]
        + [np.array(t.SYM_LFSR_TAPS[m]) for m in ("2k", "8k")],
    "constellation": lambda t: [
        t.constellation(v, a, n) for v, a in sorted(t.NORMALIZATION)
        for n in (True, False)],
    "NORMALIZATION": lambda t: [np.array([t.NORMALIZATION[k]
                                          for k in sorted(t.NORMALIZATION)])],
    "continual_pilots": lambda t: [t.continual_pilots(m)
                                   for m in ("2k", "8k")],
    "tps_carriers": lambda t: [t.tps_carriers(m) for m in ("2k", "8k")],
    "pilot_constants": lambda t: [np.array(t.CONTINUAL_PILOTS_2K),
                                  np.array(t.TPS_PILOTS_2K)],
    "wk_sequence": lambda t: [t.wk_sequence(n) for n in (1705, 6817)],
    "scattered_pilot_carriers": lambda t: [
        t.scattered_pilot_carriers(l, k) for l in range(4)
        for k in (1704, 6816)],
    "TPS_SYNC": lambda t: [np.array(t.TPS_SYNC), np.array([t.TPS_BCH_POLY])],
    "tps_field_bits": lambda t: [
        np.array(d[k]) for d in (t.TPS_CONSTELLATION_BITS,
                                 t.TPS_HIERARCHY_BITS, t.TPS_CODE_RATE_BITS,
                                 t.TPS_GUARD_BITS, t.TPS_MODE_BITS)
        for k in sorted(d)],
    "tps_frame_bits": _tps,
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_matches_jax(name):
    got, want = TABLES[name](t_tables), TABLES[name](j_tables)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        assert np.array_equal(g, w), name


def test_every_port_table_is_checked():
    """A table added to the port's copy needs a case in TABLES."""
    covered = {"dispersal_prbs_bits", "dispersal_pattern", "gf_tables",
               "gf_mul", "rs_generator_poly", "puncture_serial_order",
               "bit_interleaver_indices", "symbol_interleaver_perm",
               "constellation", "continual_pilots", "tps_carriers",
               "wk_sequence", "scattered_pilot_carriers", "tps_frame_bits",
               "_gray_decode", "_bch_67_53_parity"}
    funcs = {n for n, v in vars(t_tables).items()
             if callable(v) and getattr(v, "__module__", "") ==
             t_tables.__name__}
    funcs |= {n for n, v in vars(t_tables).items()
              if hasattr(v, "cache_info")}
    assert funcs <= covered, funcs - covered
    assert set(TABLES) >= covered - {"_gray_decode", "_bch_67_53_parity"}


def test_ts_helpers_match_jax(tmp_path):
    pk = t_ts.make_ts_packets(40, seed=5)
    assert np.array_equal(pk, j_ts.make_ts_packets(40, seed=5))
    junk = np.random.default_rng(6).integers(0, 256, 77, dtype=np.uint8)
    junk[junk == 0x47] = 0x11
    junk[junk == 0xB8] = 0x11
    path = str(tmp_path / "s.ts")
    np.concatenate([junk, pk.reshape(-1), junk[:50]]).tofile(path)
    got = t_ts.read_ts_file(path)
    assert np.array_equal(got, j_ts.read_ts_file(path))
    assert np.array_equal(got, pk)
    t_ts.write_ts_file(str(tmp_path / "o.ts"), got)
    assert np.array_equal(t_ts.read_ts_file(str(tmp_path / "o.ts")), pk)
    assert t_ts.find_sync(junk) == -1


def _functions(module) -> dict:
    return {n: v for n, v in vars(module).items()
            if inspect.isfunction(v) and v.__module__ == module.__name__}


def test_apps_common_is_a_whole_copy():
    """apps/common.py: the same functions, each with the same source."""
    got, want = _functions(t_common), _functions(j_common)
    assert set(got) == set(want)
    for name in want:
        assert inspect.getsource(got[name]) == inspect.getsource(want[name])


@pytest.mark.parametrize("name", ["_ANNEX_B_RHO", "_ANNEX_B_THETA",
                                  "_ANNEX_B_TAU_US"])
def test_annex_b_tables_equal_the_originals(name):
    got, want = getattr(t_channel, name), getattr(j_channel, name)
    assert type(got) is tuple and got == want


def test_resample_ppm_is_a_whole_copy():
    assert inspect.getsource(t_channel.resample_ppm) == \
        inspect.getsource(j_channel.resample_ppm)


def _code(path, drop=()) -> str:
    """The module's AST without docstrings, and without the functions
    named in ``drop`` ("Class.method")."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())

    def strip(body, prefix):
        out = []
        for node in body:
            if (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                continue                              # a docstring
            name = getattr(node, "name", None)
            if name is not None and f"{prefix}{name}" in drop:
                continue
            if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                node.body = strip(node.body, f"{name}.")
            out.append(node)
        return out

    tree.body = strip(tree.body, "")
    return ast.dump(tree)


def test_io_source_is_a_whole_copy():
    assert _code("dvbt_tpu_torch/io/source.py") == \
        _code("dvbt_tpu/io/source.py")


def test_io_soapy_is_a_whole_copy_but_the_repaired_read():
    drop = {"_CtypesDevice.read"}
    assert _code("dvbt_tpu_torch/io/soapy.py", drop) == \
        _code("dvbt_tpu/io/soapy.py", drop)
    assert _code("dvbt_tpu_torch/io/soapy.py") != \
        _code("dvbt_tpu/io/soapy.py")


def test_native_ring_source_is_byte_equal():
    with open(os.path.join(REPO, "dvbt_tpu/native/ringbuffer.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "dvbt_tpu_torch/native/ringbuffer.cc"),
              "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", ["_TPS_CONSTELLATION", "_TPS_ALPHA",
                                  "_TPS_RATE", "_TPS_GUARD", "_TPS_MODE"])
def test_tps_field_maps_equal_the_originals(name):
    assert getattr(t_auto, name) == getattr(j_auto, name)


def test_parse_tps_is_a_copy():
    assert inspect.getsource(t_auto._parse_tps) == \
        inspect.getsource(j_auto._parse_tps)


def jax_tool(name: str):
    """tools/<name>.py (no package: loaded by path), with the environment
    it sets restored."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return module


def _jax_mode_grid() -> list:
    """The grid tools/mode_grid_hw.py builds inside main(): its statements
    that assign or append to ``grid``, read with ast and run."""
    tree = ast.parse(open(os.path.join(REPO, "tools/mode_grid_hw.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")

    def builds(stmt):
        return any((isinstance(n, ast.Name) and n.id == "grid"
                    and isinstance(n.ctx, ast.Store))
                   or (isinstance(n, ast.Attribute) and n.attr == "append"
                       and getattr(n.value, "id", None) == "grid")
                   for n in ast.walk(stmt))

    body = ast.Module(body=[n for n in main.body if builds(n)],
                      type_ignores=[])
    ns = {"DvbtMode": j_mode.DvbtMode}
    exec(compile(body, "tools/mode_grid_hw.py", "exec"), ns)
    return ns["grid"]


def test_mode_grid_equals_the_jax_tools():
    from dvbt_tpu_torch.tools import mode_grid_hw

    want = _jax_mode_grid()
    assert len(want) == 25
    assert [(n, dataclasses.asdict(m)) for n, m in mode_grid_hw.GRID] == \
        [(n, dataclasses.asdict(m)) for n, m in want]


def test_ber_hw_points_equal_the_jax_tools():
    from dvbt_tpu_torch.tools import ber_hw

    assert ber_hw.POINTS == jax_tool("ber_hw").POINTS


def _curves(curves) -> list:
    return [(stem, dataclasses.asdict(mode), *rest)
            for stem, mode, *rest in curves]


@pytest.mark.parametrize("name,part", [("ber_r4", slice(4, 17)),
                                       ("ber_r5", slice(17, 20))])
def test_ber_curves_equal_the_jax_tools(name, part):
    """ber_curves.CURVES: the round-3 curves of docs/BER.md, then
    tools/ber_r4.py's CURVES, then tools/ber_r5.py's, each entry equal."""
    from dvbt_tpu_torch.tools import ber_curves

    assert len(ber_curves.CURVES) == 20
    assert _curves(ber_curves.CURVES[part]) == \
        _curves(jax_tool(name).CURVES)
