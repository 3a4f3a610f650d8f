"""Every field of ``Config`` and ``LimiterConfig``, held to the JAX package.

``tests/test_torch_jax_forms.py`` walks the public functions; this file
walks the configuration space.  Each field of the two dataclasses has
exactly one entry:

* ``CASES``: non-default values chosen to change the graph.  Each runs the
  port's ``stages.master`` against the JAX package's ``stages.master`` at
  float64 on the CPU on a 2 s / 2.5 s pair made from a seed (>= 200 dB on
  every rendered variant), over ``BASE``: ``fft_size=2048`` and a 1 s
  ``max_piece_size`` keep the host operators and the JAX compile small
  (one compile per case).  A field the limiter reads (``threshold``,
  ``internal_sample_rate``, the ``LimiterConfig`` fields) renders all
  three variants; any other renders the two without the limiter, which
  is all it reaches, and costs half the compile.  Where the JAX package's
  ``master`` is off the reference (:func:`jax_smooths_twice`: its folded
  LOWESS keeps every grid point as an anchor, so it reads its own folded
  operators as the plain ones and smooths twice), the case holds the port
  to the JAX plain-operator path, ``master_graph(..., interp_ops=
  interpolation_operator_arrays(...))``, which smooths once, as the
  reference's ``__smooth_exponentially`` does;
* ``HELD``: a test of another file that already holds the field at a
  non-default value;
* ``HOST``: a host-only field with no graph value, and the test of the
  checker, host shell or preview that holds it.

Then the smoothing forms on the two configurations that broke and on
``Config()``: ``master_graph`` with every ``interp_ops`` form, the farm's
graphs and ``master_sharded`` on four CPU shards against the port's own
``master``, and ``smooth_exponentially`` with each pair against none; and
the JAX package's fault itself, pinned.
"""

import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from scipy import signal

import matchering_tpu as mj
from matchering_tpu import core as jcore
from matchering_tpu import stages as jstages
from matchering_tpu.ops import lowess as jlowess
from matchering_tpu.ops import smoothing as jsm
import matchering_tpu_torch as mt
from matchering_tpu_torch import core, state
from matchering_tpu_torch.io import wav
from matchering_tpu_torch.ops import smoothing
from matchering_tpu_torch.parallel import batch, mesh, timeshard

TESTS = pathlib.Path(__file__).resolve().parent
SR = 44100
GATE_DB = 200.0
SMOOTH_TOL = 1e-12
BASE = dict(dtype="float64", fft_size=2048, max_piece_size=1.0)
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
LIMITED = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)
UNLIMITED = dict(need_default=False, need_no_limiter=True, need_no_limiter_normalized=True)
# the fields the limiter reads (matchering_tpu/limiter.py): their cases render the limited result
LIMITER_READS = ("threshold", "internal_sample_rate")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch and one for the BLAS behind numpy and
    scipy: the tier-1 run's six workers' pools of every core spin against
    each other.  The host operator builds here (scipy's spline over an
    identity, the folded LOWESS products) took 13 times their serial time
    under the suite with the BLAS pool at every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def make_pair(seed=14):
    """A 2 s target and a 2.5 s reference under slow envelopes.  The
    target is low-passed noise over a -60 dB white floor, so its upper
    bins sit near 1e-2 and a large ``min_value`` bites; the loud reference
    clips, so the RMS correction steps and the limiter have work."""
    rng = np.random.RandomState(seed)
    n, m = 2 * SR, 5 * SR // 2
    env_t = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    env_r = 0.5 + 0.5 * np.sin(np.arange(m) / SR * 1.1)[:, None]
    low = signal.lfilter(*signal.butter(4, 1000, fs=SR), rng.randn(n, 2), axis=0)
    target = np.clip((low / np.max(np.abs(low)) + 1e-3 * rng.randn(n, 2)) * 0.4 * env_t, -1, 1)
    reference = np.clip(0.9 * rng.randn(m, 2) * env_r, -1, 1)
    return target, reference


def tone_pair(seed=5):
    """``bench.py``'s workload at the walk's shapes: a two-tone target and
    a square-wave reference under the envelopes, with noise.  Their peaked
    spectra show a second LOWESS plainly (18-23 dB where the noise pair
    shows 38-40)."""
    rng = np.random.RandomState(seed)
    n, m = 2 * SR, 5 * SR // 2
    t, r = np.arange(n) / SR, np.arange(m) / SR
    env_t = 0.5 + 0.5 * np.sin(t * 1.3)[:, None]
    env_r = 0.5 + 0.5 * np.sin(r * 1.1)[:, None]
    target = np.stack([0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n),
                       0.38 * np.sin(2 * np.pi * 221 * t) + 0.05 * rng.randn(n)], axis=1) * env_t
    square = 0.7 * np.sign(np.sin(2 * np.pi * 110 * r))
    reference = np.stack([square + 0.05 * rng.randn(m), square + 0.05 * rng.randn(m)], axis=1) * env_r
    return target, reference


PAIRS = {"walk": make_pair(), "tones": tone_pair()}
PAIR = PAIRS["walk"]


# ---------------------------------------------------------------------------
# The entries

# (dataclass, field) -> the cases: Config keyword arguments over BASE, the
# LimiterConfig's under "limiter"
CASES = {
    ("Config", "internal_sample_rate"): [dict(internal_sample_rate=22050), dict(internal_sample_rate=48000)],
    ("Config", "max_piece_size"): [dict(max_piece_size=0.5)],
    ("Config", "threshold"): [dict(threshold=0.7)],
    ("Config", "min_value"): [dict(min_value=0.09)],
    # fft_size=8192 keeps lin_log_oversampling=1: at the default 4 its
    # 16,385-point log grid's operators take ~30 s to build on the host, once
    # in each package
    ("Config", "fft_size"): [dict(fft_size=1024), dict(fft_size=8192, lin_log_oversampling=1)],
    # 1 at fft_size 2048 is the first config that broke (a 1025-point grid,
    # every point an anchor)
    ("Config", "lin_log_oversampling"): [
        dict(lin_log_oversampling=1), dict(lin_log_oversampling=2), dict(lin_log_oversampling=3),
    ],
    ("Config", "rms_correction_steps"): [dict(rms_correction_steps=0), dict(rms_correction_steps=1)],
    ("Config", "lowess_frac"): [dict(lowess_frac=0.1)],
    # 1e-4 at the default fft_size is the second config that broke (an
    # 8193-point grid, every point an anchor)
    ("Config", "lowess_delta"): [dict(lowess_delta=5e-3), dict(lowess_delta=1e-4, fft_size=4096)],
    ("Config", "lowess_exact"): [dict(lowess_exact=True)],
    ("LimiterConfig", "attack"): [dict(limiter=dict(attack=3.0))],
    ("LimiterConfig", "hold"): [dict(limiter=dict(hold=5.0))],
    ("LimiterConfig", "release"): [dict(limiter=dict(release=1000.0))],
    ("LimiterConfig", "attack_filter_coefficient"): [dict(limiter=dict(attack_filter_coefficient=-1.0))],
    ("LimiterConfig", "hold_filter_coefficient"): [dict(limiter=dict(hold_filter_coefficient=20.0))],
    ("LimiterConfig", "release_filter_coefficient"): [dict(limiter=dict(release_filter_coefficient=400.0))],
}

# (dataclass, field) -> (test file, test function) holding it at a non-default value
HELD = {
    ("Config", "lowess_it"): ("test_torch_configs_chain.py", "test_master_float64_matches_jax"),
    ("Config", "dtype"): ("test_torch_configs_chain.py", "test_master_float32_above_jax_gate"),
    ("Config", "length_bucketing"): ("test_torch_batch.py", "test_stages_main_length_bucketing"),
    ("Config", "limiter"): ("test_torch_config_walk.py", "test_master_matches_jax"),
    ("LimiterConfig", "hold_filter_order"): ("test_torch_configs_chain.py", "test_limit_matches_a_sosfilt_release_stage"),
    ("LimiterConfig", "release_filter_order"): (
        "test_torch_configs_chain.py", "test_limit_matches_a_sosfilt_release_stage",
    ),
}

_CHECKER = "the checker's, on the host: no graph value"
_PREVIEW = "sizes the preview window on the host: no graph value"
# (dataclass, field) -> (why it has no graph value, the test that holds it)
HOST = {
    ("Config", "max_length"): (_CHECKER, ("test_torch_config_walk.py", "test_checker_fields_match_jax")),
    ("Config", "clipping_samples_threshold"): (
        _CHECKER, ("test_torch_config_walk.py", "test_checker_fields_match_jax"),
    ),
    ("Config", "limited_samples_threshold"): (
        _CHECKER, ("test_torch_config_walk.py", "test_checker_fields_match_jax"),
    ),
    ("Config", "allow_equality"): (
        "process()'s equality check on the host shell: no graph value",
        ("test_torch_config_walk.py", "test_allow_equality_matches_jax"),
    ),
    ("Config", "temp_folder"): (
        "the folder process() hands the loader: no graph value",
        ("test_torch_config_walk.py", "test_temp_folder_reaches_the_loader"),
    ),
    ("Config", "preview_size"): (_PREVIEW, ("test_torch_preview.py", "test_create_preview_matches_jax")),
    ("Config", "preview_analysis_step"): (_PREVIEW, ("test_torch_preview.py", "test_create_preview_matches_jax")),
    ("Config", "preview_fade_size"): (_PREVIEW, ("test_torch_preview.py", "test_create_preview_matches_jax")),
    ("Config", "preview_fade_coefficient"): (
        _PREVIEW, ("test_torch_config_walk.py", "test_preview_fade_coefficient_matches_jax"),
    ),
}


def _fields():
    keys = set()
    for package in (mj, mt):
        for cls in ("Config", "LimiterConfig"):
            keys |= {(cls, f.name) for f in dataclasses.fields(getattr(package, cls))}
    return keys


def test_every_field_has_one_entry():
    """Each field of either package's ``Config`` and ``LimiterConfig`` has
    a case, a held test or a host reason, and only one; no entry names a
    field the dataclasses do not have."""
    fields = _fields()
    entries = [set(CASES), set(HELD), set(HOST)]
    missing = sorted(fields - set.union(*entries))
    assert not missing, f"fields with no case, held test or host reason: {missing}"
    stale = sorted(set.union(*entries) - fields)
    assert not stale, f"entries for fields the dataclasses do not have: {stale}"
    for i, a in enumerate(entries):
        for b in entries[i + 1:]:
            assert not a & b, f"fields with two entries: {sorted(a & b)}"
    assert all(reason for reason, _ in HOST.values())


def _pointers():
    return sorted({(*HELD[k], k[1]) for k in HELD} | {(*test, k[1]) for k, (_, test) in HOST.items()})


@pytest.mark.parametrize("filename, function, field", _pointers(), ids=lambda v: str(v))
def test_pointed_tests_exist_and_name_their_field(filename, function, field):
    """The test an entry points to exists, and its file names the field
    (a keyword, an attribute or a string)."""
    tree = ast.parse((TESTS / filename).read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == function for n in ast.walk(tree)), (
        f"{filename} has no {function}")
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword):
            names.add(node.arg)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
    assert field in names, f"{filename} never names {field}"


# ---------------------------------------------------------------------------
# The cases against the JAX package


def _case_id(kwargs):
    flat = {**{k: v for k, v in kwargs.items() if k != "limiter"},
            **{f"limiter.{k}": v for k, v in kwargs.get("limiter", {}).items()}}
    return ",".join(f"{k}={v}" for k, v in flat.items())


CASE_IDS = [_case_id(kwargs) for cases in CASES.values() for kwargs in cases]
_BY_ID = {_case_id(kwargs): (field, kwargs) for field, cases in CASES.items() for kwargs in cases}


def jax_config(case):
    kwargs = dict(_BY_ID[case][1])
    limiter = kwargs.pop("limiter", {})
    return mj.Config(**{**BASE, **kwargs}, limiter=mj.LimiterConfig(**limiter))


def port_config(jconfig):
    return state.config_from_dict(dataclasses.asdict(jconfig))


def needs(case):
    cls, name = _BY_ID[case][0]
    return LIMITED if cls == "LimiterConfig" or name in LIMITER_READS else UNLIMITED


def rendered(needs_):
    return [v for v, flag in zip(VARIANTS, needs_.values()) if flag]


def jax_smooths_twice(jconfig) -> bool:
    """The JAX package's fault (ROADMAP queue 3 item 7): it folds an it=0
    LOWESS with delta > 0 into its operator pair, then reads whether a
    pair is folded from its inner dimension alone
    (``matchering_tpu/ops/smoothing.py:144``).  Where that LOWESS keeps
    every point of the log grid as an anchor, the folded pair has as
    many rows as the grid, is taken as plain, and the LOWESS runs again."""
    delta = 0.0 if jconfig.lowess_exact else jconfig.lowess_delta
    if jconfig.lowess_it != 0 or delta <= 0:
        return False
    grid = jconfig.log_grid_size
    return jlowess.plan_lowess(grid, jconfig.lowess_frac, delta).anchors.shape[0] == grid


_jax_graph = jax.jit(
    jstages.master_graph,
    static_argnames=("config", "need_default", "need_no_limiter", "need_no_limiter_normalized"),
)


def _host(out, needs_):
    return {v: np.asarray(getattr(out, v)) for v in rendered(needs_)}


@functools.lru_cache(maxsize=None)
def jax_master(case, pair="walk"):
    target, reference = PAIRS[pair]
    out = mj.master(jnp.asarray(target), jnp.asarray(reference), jax_config(case), **needs(case))
    return _host(out, needs(case))


@functools.lru_cache(maxsize=None)
def jax_plain_path(case, pair="walk"):
    """The JAX graph with the plain interpolation operators: the LOWESS
    runs once, between them, on every config."""
    jconfig = jax_config(case)
    ops = jsm.interpolation_operator_arrays(
        jconfig.internal_sample_rate, jconfig.fft_size, jconfig.lin_log_oversampling, jnp.float64
    )
    target, reference = PAIRS[pair]
    out = _jax_graph(jnp.asarray(target), jnp.asarray(reference), jconfig, interp_ops=ops, **needs(case))
    return _host(out, needs(case))


@functools.lru_cache(maxsize=None)
def port_master(case, pair="walk"):
    target, reference = PAIRS[pair]
    out = mt.master(target, reference, port_config(jax_config(case)), device="cpu", **needs(case))
    return {v: getattr(out, v).numpy() for v in rendered(needs(case))}


@functools.lru_cache(maxsize=None)
def port_base(needs_key):
    out = mt.master(PAIR[0], PAIR[1], mt.Config(**BASE), device="cpu", **dict(needs_key))
    return {v: getattr(out, v).numpy() for v in rendered(dict(needs_key))}


BROKEN = [case for case in CASE_IDS if jax_smooths_twice(jax_config(case))]


def test_the_jax_package_smooths_twice_on_the_two_configs_that_broke():
    """Of the walk's cases, JAX's ``master`` is off the reference on
    exactly the two configurations found broken: a 1025-point grid
    (``fft_size=2048, lin_log_oversampling=1``) and the default 8193-point
    grid with ``lowess_delta=1e-4``."""
    assert BROKEN == ["lin_log_oversampling=1", "lowess_delta=0.0001,fft_size=4096"]


@pytest.mark.parametrize("case", CASE_IDS)
def test_master_matches_jax(case, snr):
    """The port's ``master`` against JAX's ``master`` (>= 200 dB per
    rendered variant), or against the JAX plain-operator path where JAX's
    ``master`` smooths twice; and the case's value changes the graph: a
    rendered variant of the port's differs from that of ``BASE``."""
    want = jax_plain_path(case) if case in BROKEN else jax_master(case)
    got = port_master(case)
    base = port_base(tuple(needs(case).items()))
    for variant in rendered(needs(case)):
        measured = snr(want[variant], got[variant])
        assert measured >= GATE_DB, (variant, measured)
    assert any(got[v].shape != base[v].shape or snr(base[v], got[v]) < 150.0 for v in got), (
        f"{case} leaves every variant as BASE gives it")


@pytest.mark.parametrize("case", BROKEN)
def test_jax_master_smooths_twice_where_every_grid_point_is_an_anchor(case, snr):
    """The fault of the JAX package (ROADMAP queue 3 item 7), which the
    port does not copy: on both configs, on ``tone_pair``, JAX's
    ``master`` lies below 40 dB against its own plain-operator path
    (18.6 and 23.0 dB when written), and the port's ``master`` at 200 dB
    or above.  The walk's shapes reuse its compiled programs."""
    plain = jax_plain_path(case, "tones")
    jax_out = jax_master(case, "tones")
    got = port_master(case, "tones")
    for variant in rendered(needs(case)):
        assert snr(plain[variant], jax_out[variant]) < 40.0, variant
        assert snr(plain[variant], got[variant]) >= GATE_DB, variant


# ---------------------------------------------------------------------------
# The smoothing forms on the entry points (the port alone, no JAX compile)

CROSS = {
    "default": {},
    "lowess_delta=1e-4": dict(lowess_delta=1e-4),
    "fft_size=2048,lin_log_oversampling=1": dict(fft_size=2048, lin_log_oversampling=1),
}
FORMS = ("none", "smoothing", "port-pair", "jax-pair")
SHARDS = 4


def cross_config(name):
    return mt.Config(dtype="float64", **CROSS[name])


@functools.lru_cache(maxsize=None)
def jax_pair(name):
    """The JAX package's ``operator_arrays_for_config`` pair as numpy."""
    return tuple(np.asarray(op) for op in jsm.operator_arrays_for_config(mj.Config(dtype="float64", **CROSS[name])))


def _interp_ops(form, name):
    config = cross_config(name)
    if form == "none":
        return None
    if form == "smoothing":
        return state.operators_for_config(config, "cpu")
    if form == "port-pair":
        return smoothing.operator_arrays_for_config(config, device="cpu")
    return jax_pair(name)


def _tracks(row):
    """Row 0 is ``PAIR``; row 1 its target at 0.7 of the level."""
    target, reference = PAIR
    return (target if row == 0 else 0.7 * target), reference


@functools.lru_cache(maxsize=None)
def cross_master(name, row=0):
    target, reference = _tracks(row)
    out = mt.master(target, reference, cross_config(name), device="cpu", **LIMITED)
    return {v: getattr(out, v).numpy() for v in VARIANTS}


def _hold(want, got, snr, label):
    """``got``: a ``MasterOutput``'s variants, by name."""
    for variant in VARIANTS:
        measured = snr(want[variant], got[variant].numpy())
        assert measured >= GATE_DB, (label, variant, measured)


def _variants(out, row=None):
    return {v: getattr(out, v) if row is None else getattr(out, v)[row] for v in VARIANTS}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", CROSS)
def test_master_graph_forms_smooth_once(name, form, snr):
    """``master_graph`` with ``interp_ops`` None, a ``Smoothing``, the
    port's pair and the JAX package's pair as numpy: each the port's
    ``master`` (>= 200 dB), so the LOWESS runs once in every form."""
    target, reference = (torch.from_numpy(x) for x in PAIR)
    out = mt.master_graph(target, reference, cross_config(name), **LIMITED, interp_ops=_interp_ops(form, name))
    _hold(cross_master(name), _variants(out), snr, form)


@pytest.mark.parametrize("entry", ["master_batch", "master_pairs"])
@pytest.mark.parametrize("name", CROSS)
def test_farm_graphs_smooth_once(name, entry, snr):
    """The farm's graphs on two rows: each row the port's ``master`` of
    its pair (>= 200 dB)."""
    rows = [_tracks(row) for row in (0, 1)]
    config = cross_config(name)
    if entry == "master_batch":
        targets = torch.from_numpy(np.stack([t for t, _ in rows]))
        references = torch.from_numpy(np.stack([r for _, r in rows]))
        out = batch.master_batch(targets, references, config, **LIMITED, device="cpu")
        outs = [_variants(out, row) for row in (0, 1)]
    else:
        pairs = batch.master_pairs([t for t, _ in rows], [r for _, r in rows], config, **LIMITED, device="cpu")
        outs = [_variants(out) for out in pairs]
    for row, got in enumerate(outs):
        _hold(cross_master(name, row), got, snr, f"{entry} row {row}")


@pytest.mark.parametrize("name", CROSS)
def test_master_sharded_smooths_once(name, snr):
    """``master_sharded`` over four CPU shards: the port's ``master``
    (>= 200 dB)."""
    grid = mesh.single_axis_mesh("time", devices=["cpu"] * SHARDS)
    out = timeshard.master_sharded(*(torch.from_numpy(x) for x in PAIR), cross_config(name), mesh=grid, **LIMITED)
    _hold(cross_master(name), _variants(out), snr, "master_sharded")


@pytest.mark.parametrize("form", ["port-pair", "jax-pair"])
@pytest.mark.parametrize("name", CROSS)
def test_smooth_exponentially_pair_is_none(name, form):
    """``smooth_exponentially(operators=pair)`` within 1e-12 of
    ``operators=None`` (the plain operators, the LOWESS between them)."""
    config = cross_config(name)
    curve = torch.from_numpy(np.abs(np.random.RandomState(7).randn(2, config.fft_size // 2 + 1)) + 0.2)
    args = (config.internal_sample_rate, config.fft_size, config.lin_log_oversampling,
            *smoothing.lowess_parameters(config))
    want = smoothing.smooth_exponentially(curve, *args, operators=None)
    got = smoothing.smooth_exponentially(curve, *args, operators=_interp_ops(form, name))
    assert float((got - want).abs().max()) <= SMOOTH_TOL


# ---------------------------------------------------------------------------
# The bare pair's reading (a 513-point grid: fft_size=1024, oversampling 1)

SMALL = dict(dtype="float64", fft_size=1024, lin_log_oversampling=1)


def _small():
    config = mt.Config(**SMALL)
    return config, (config.log_grid_size, smoothing.lowess_parameters(config), torch.float64, "cpu")


@pytest.mark.parametrize("kind", ["plain", "folded", "plain-float32", "folded-float32"])
def test_a_bare_pair_of_every_anchor_is_read_by_its_values(kind):
    """Where every grid point is an anchor, a bare pair has the grid's
    rows either way: its values say whether the LOWESS is folded in."""
    config, args = _small()
    rates = smoothing.grid_rates(config)
    pair = (smoothing.host_operators(*rates) if kind.startswith("plain")
            else smoothing.host_operators(*rates, smoothing.lowess_parameters(config)))
    pair = tuple(np.array(op, dtype=np.float32 if kind.endswith("float32") else np.float64) for op in pair)
    assert pair[0].shape[0] == config.log_grid_size
    state_ = smoothing.as_smoothing(pair, *args, rates=rates)
    assert (state_.lowess is None) is kind.startswith("folded")


def test_a_bare_pair_is_decided_once(monkeypatch):
    config, args = _small()
    rates = smoothing.grid_rates(config)
    pair = tuple(np.array(op) for op in smoothing.host_operators(*rates))
    calls = []
    decide = smoothing._folded_by_value
    monkeypatch.setattr(smoothing, "_folded_by_value", lambda *a: calls.append(a) or decide(*a))
    for _ in range(3):
        assert smoothing.as_smoothing(pair, *args, rates=rates).lowess is not None
    assert len(calls) == 1


def test_an_unclear_bare_pair_raises():
    """A pair of the grid's rows that is neither the plain operators nor
    them with the LOWESS folded in, or one given without the grid's
    rates, asks for a ``Smoothing``."""
    config, args = _small()
    rates = smoothing.grid_rates(config)
    plain = smoothing.host_operators(*rates)
    noise = np.random.RandomState(3).randn(*plain[0].shape)
    with pytest.raises(ValueError, match="Smoothing"):
        smoothing.as_smoothing((plain[0] + 1e-3 * noise, plain[1]), *args, rates=rates)
    with pytest.raises(ValueError, match="Smoothing"):
        smoothing.as_smoothing(tuple(np.array(op) for op in plain), *args)


def test_the_ports_pairs_say_whether_they_are_folded():
    """``operator_arrays_for_config`` and ``interpolation_operator_arrays``
    unpack as (to_log, to_lin) and carry ``folded``; ``as_smoothing``
    trusts it, whatever the shape."""
    config, args = _small()
    pair = smoothing.operator_arrays_for_config(config, device="cpu")
    to_log, to_lin = pair
    assert pair.folded and to_log.shape[0] == config.log_grid_size
    assert smoothing.as_smoothing(pair, *args).lowess is None
    plain = smoothing.interpolation_operator_arrays(*smoothing.grid_rates(config), torch.float64, device="cpu")
    assert not plain.folded
    assert smoothing.as_smoothing(plain, *args).lowess is not None


# ---------------------------------------------------------------------------
# The host-only fields


def _events(package):
    events = []
    package.log(info_handler=events.append, warning_handler=events.append,
                debug_handler=events.append, show_codes=True)
    return events


def _pinned(peak, count, n=3 * SR):
    """A stereo track of noise below ``peak`` with ``count`` samples at it."""
    x = np.random.RandomState(count).uniform(-0.5, 0.5, (n, 2)) * peak
    x[np.arange(count) * 97, 0] = peak
    return x


CHECKER_CASES = {
    "max_length": (dict(max_length=2.0, max_piece_size=1.0), _pinned(0.5, 0)),
    "clipping_samples_threshold": (dict(clipping_samples_threshold=60), _pinned(1.0, 50)),
    "limited_samples_threshold": (dict(limited_samples_threshold=20), _pinned(0.5, 50)),
}


def _check(package, array, **config):
    events = _events(package)
    try:
        kwargs = {"device": "cpu"} if package is mt else {}
        package.check(array, SR, package.Config(**config), "target", **kwargs)
        return events
    except package.ModuleError as error:
        return events + [f"raised {error.code}"]
    finally:
        package.log()


@pytest.mark.parametrize("field", CHECKER_CASES)
def test_checker_fields_match_jax(field):
    """``check()`` on a target with a non-default checker field: the same
    coded events (or error) as the JAX package's, and not those of the
    default."""
    kwargs, array = CHECKER_CASES[field]
    got = _check(mt, array, **kwargs)
    assert got == _check(mj, array, **kwargs)
    assert got != _check(mt, array)


def _wav_pair(tmp_path):
    path = str(tmp_path / "track.wav")
    wav.write(path, make_pair()[0], SR, "PCM_16")
    return path


def test_allow_equality_matches_jax(tmp_path):
    """A track against itself: both packages refuse it with the same code
    by default; with ``allow_equality=True`` the port masters it."""
    path = _wav_pair(tmp_path)
    codes = []
    for package, kwargs in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(package.ModuleError) as error:
            package.process(path, path, [package.pcm16(str(tmp_path / "no.wav"))],
                            package.Config(fft_size=1024), **kwargs)
        codes.append(error.value.code)
    assert codes[0] == codes[1]
    out = str(tmp_path / "out.wav")
    mt.process(path, path, [mt.pcm16(out)], mt.Config(fft_size=1024, allow_equality=True), device="cpu")
    audio, rate = wav.read(out)
    assert rate == SR and audio.shape == (2 * SR, 2)


def test_temp_folder_reaches_the_loader(tmp_path, monkeypatch):
    """``Config(temp_folder=...)`` is the folder both packages' ``process``
    hand their loader for each track (the port's ``load_staged``)."""
    path = _wav_pair(tmp_path)
    folder = str(tmp_path / "staging")
    for package, core_module, name, kwargs in ((mj, jcore, "load", {}), (mt, core, "load_staged", {"device": "cpu"})):
        seen = []
        load = getattr(core_module, name)
        monkeypatch.setattr(core_module, name, lambda f, role, temp, **kw: seen.append(temp) or load(f, role, temp, **kw))
        with pytest.raises(package.ModuleError):  # the pair is one track: refused after both loads
            package.process(path, path, [package.pcm16(str(tmp_path / "no.wav"))],
                            package.Config(fft_size=1024, temp_folder=folder), **kwargs)
        assert seen == [folder, folder], package.__name__


def test_preview_fade_coefficient_matches_jax(tmp_path):
    """``create_preview`` with ``preview_fade_coefficient=3``: both
    packages write the same previews, and not those of the default."""
    rng = np.random.RandomState(5)
    n = 17 * 8000
    result = rng.randn(n, 2) * 0.3 * (0.2 + np.abs(np.sin(np.arange(n) / 8000 * 0.7))[:, None])
    target = np.clip(rng.randn(n, 2) * 0.5, -1, 1)
    base = dict(dtype="float64", internal_sample_rate=8000, preview_size=6, preview_analysis_step=2,
                preview_fade_size=3)
    previews = {}
    for label, package, extra in (("jax", mj, dict(preview_fade_coefficient=3)),
                                  ("port", mt, dict(preview_fade_coefficient=3)), ("default", mt, {})):
        paths = [str(tmp_path / f"{label}_{k}.wav") for k in ("t", "r")]
        array = jnp.asarray(result) if package is mj else torch.from_numpy(result)
        package.create_preview(target, array, package.Config(**base, **extra),
                               package.Result(paths[0], "DOUBLE"), package.Result(paths[1], "DOUBLE"))
        previews[label] = [wav.read(p)[0] for p in paths]
    for got, want, default in zip(previews["port"], previews["jax"], previews["default"]):
        assert float(np.max(np.abs(got - want))) <= 1e-12
        assert float(np.max(np.abs(got - default))) > 1e-3
