"""The PyTorch port's slice end to end against the JAX package, on the CPU.

``master`` at float64 must match the JAX ``master`` at float64 to >= 200 dB
SNR for all three variants (float64 rounding apart, the two compute the
same chain), and the port's float32 output must stay above the JAX
package's own float32 gate of 95 dB (tests/test_dtype_gates.py).
``process()`` on a WAV pair, with or without a 48 kHz input and previews,
must write PCM_16 samples within 1 LSB of ``matchering_tpu.process`` and
emit the same coded events.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.io import wav as jwav
from matchering_tpu.ops import smoothing as jsm
from matchering_tpu_torch import state
from matchering_tpu_torch.ops import smoothing

SR = 44100
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
ALL = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)


def make_pair(seconds, seed):
    r = np.random.RandomState(seed)
    n = seconds * SR
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    target = np.clip(0.3 * r.randn(n, 2) * env, -1, 1)
    reference = np.clip(0.9 * r.randn(n, 2) * env, -1, 1)
    return target, reference


@pytest.fixture(scope="module")
def pair():
    return make_pair(8, 5)


@pytest.fixture(scope="module")
def jax_f64(pair):
    config = mj.Config(dtype="float64", max_piece_size=2)  # 5 pieces per track
    out = mj.master(jnp.asarray(pair[0]), jnp.asarray(pair[1]), config, **ALL)
    return config, {k: np.asarray(getattr(out, k)) for k in VARIANTS}


@pytest.fixture(scope="module")
def port_f64(pair, jax_f64):
    config = state.config_from_dict(dataclasses.asdict(jax_f64[0]))
    out = mt.master(pair[0], pair[1], config, device="cpu", **ALL)
    return {k: getattr(out, k).numpy() for k in VARIANTS}


@pytest.fixture(scope="module")
def port_f32(pair):
    out = mt.master(pair[0], pair[1], mt.Config(max_piece_size=2), device="cpu", **ALL)
    return {k: getattr(out, k) for k in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_float64_matches_jax(jax_f64, port_f64, snr, variant):
    assert port_f64[variant].shape == jax_f64[1][variant].shape
    measured = snr(jax_f64[1][variant], port_f64[variant])
    assert measured >= 200.0, measured


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_float32_above_jax_gate(jax_f64, port_f32, snr, variant):
    assert port_f32[variant].dtype == torch.float32
    measured = snr(jax_f64[1][variant], port_f32[variant].numpy())
    assert measured > 95.0, measured


def _interp_ops(form, config, jax_config):
    """The smoothing state of ``config`` in one of master_graph's forms."""
    if form == "none":
        return None
    if form == "jax-pair":
        return tuple(np.asarray(op) for op in jsm.operator_arrays_for_config(jax_config))
    if form == "port-pair":
        return smoothing.operator_arrays_for_config(config, device="cpu")
    return state.operators_for_config(config, "cpu")


@pytest.mark.parametrize("form", ["none", "jax-pair", "port-pair", "smoothing"])
def test_master_graph_takes_the_jax_call_form(pair, jax_f64, snr, form):
    """``master_graph(target, reference, config, need_default,
    need_no_limiter, need_no_limiter_normalized, interp_ops)``, JAX's
    positional form, with ``interp_ops`` None, the JAX package's pair, the
    port's pair or its ``Smoothing``: JAX's master >= 200 dB."""
    config = state.config_from_dict(dataclasses.asdict(jax_f64[0]))
    interp_ops = _interp_ops(form, config, jax_f64[0])
    out = mt.master_graph(torch.from_numpy(pair[0]), torch.from_numpy(pair[1]), config, True, True, True, interp_ops)
    for variant in VARIANTS:
        measured = snr(jax_f64[1][variant], getattr(out, variant).numpy())
        assert measured >= 200.0, (variant, measured)


def test_bench_graph_body_runs_on_the_port():
    """``bench.py``'s graph body with only the import swapped, on a 10 s
    ``bench.make_pair``: the staged pair of ``operator_arrays_for_config``
    gives the result of ``interp_ops=None`` bit for bit."""
    import bench

    config = mt.Config()
    interp_ops = smoothing.operator_arrays_for_config(config, device="cpu")

    def graph(target, reference, ops, s):
        out = mt.master_graph(
            target * (1.0 + 1e-7 * s), reference, config,
            need_default=True, interp_ops=ops,
        )
        return out.result

    target, reference = (torch.from_numpy(x) for x in bench.make_pair(10, SR, 42))
    s = torch.tensor(1.0)
    got = graph(target, reference, interp_ops, s)
    assert got.shape == target.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, graph(target, reference, None, s))
    assert float(torch.sum(torch.abs(got))) > 0


# --- graft_entry_torch: the driver entry points on the port ---


def test_tiny_pair_is_the_jax_drivers():
    import __graft_entry__
    import graft_entry_torch

    for kwargs in ({}, dict(seconds_t=2.0, seconds_r=1.1)):
        for got, want in zip(graft_entry_torch._tiny_pair(**kwargs), __graft_entry__._tiny_pair(**kwargs)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's float64 master of the driver's pair."""
    import graft_entry_torch

    target, reference = graft_entry_torch._tiny_pair()
    out = mj.master(jnp.asarray(target), jnp.asarray(reference), mj.Config(dtype="float64"))
    return np.asarray(out.result)


def test_entry_forward_matches_jax(jax_tiny, snr):
    """``entry(device="cpu")``: the forward step on its example tensors
    (float32) above the JAX package's float32 gate of 95 dB, and
    ``master_graph`` in float64 on the same pair >= 200 dB."""
    import graft_entry_torch

    forward, (target, reference) = graft_entry_torch.entry(device="cpu")
    assert target.device.type == "cpu" and target.dtype == torch.float32
    got = forward(target, reference)
    assert got.shape == target.shape and got.dtype == torch.float32
    measured = snr(jax_tiny, got.numpy())
    assert measured > 95.0, measured
    got64 = mt.master_graph(target, reference, mt.Config(dtype="float64"), need_default=True).result
    measured = snr(jax_tiny, got64.numpy())
    assert measured >= 200.0, measured


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_dryrun_multichip_on_the_cpu(n_devices):
    import graft_entry_torch

    graft_entry_torch.dryrun_multichip(n_devices, device="cpu")


def test_entry_points_without_a_card_raise(monkeypatch):
    import graft_entry_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.dryrun_multichip(2)


def test_graft_entry_imports_no_jax():
    code = (
        "import sys, graft_entry_torch, matchering_tpu_torch.parallel.timeshard; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]; "
        "assert not bad, bad"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120)


def test_limit_matches_jax(rng):
    config = mj.Config(dtype="float64")
    loud = rng.randn(30_000, 2) * 0.8  # many samples over the threshold
    got = mt.limit(torch.from_numpy(loud), state.config_from_dict(dataclasses.asdict(config)))
    want = np.asarray(mj.limit(jnp.asarray(loud), config))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    quiet = torch.from_numpy(rng.randn(30_000, 2) * 0.1)
    assert torch.equal(mt.limit(quiet, mt.Config(dtype="float64")), quiet)


def _events(package):
    events = []
    package.log(info_handler=events.append, warning_handler=events.append, show_codes=True)
    return events


def test_process_wav_matches_jax_within_one_lsb(tmp_path):
    target, reference = make_pair(5, 9)
    jwav.write(str(tmp_path / "t.wav"), target, SR, "PCM_16")
    jwav.write(str(tmp_path / "r.wav"), reference, SR, "PCM_16")
    try:
        jax_events = _events(mj)
        mj.process(
            str(tmp_path / "t.wav"), str(tmp_path / "r.wav"),
            [mj.pcm16(str(tmp_path / "jax.wav"))], mj.Config(dtype="float64"),
        )
        port_events = _events(mt)
        mt.process(
            str(tmp_path / "t.wav"), str(tmp_path / "r.wav"),
            [mt.pcm16(str(tmp_path / "port.wav"))], mt.Config(dtype="float64"),
            device="cpu",
        )
    finally:
        mj.log()
        mt.log()
    jax_out, jax_rate = jwav.read(str(tmp_path / "jax.wav"), raw_int=True)
    port_out, port_rate = jwav.read(str(tmp_path / "port.wav"), raw_int=True)
    assert port_rate == jax_rate == SR
    assert port_out.dtype == np.int16 and port_out.shape == jax_out.shape
    assert np.max(np.abs(port_out.astype(np.int32) - jax_out)) <= 1
    assert port_events == jax_events


def _track(seconds, rate, seed, gain):
    n = seconds * rate
    env = 0.5 + 0.5 * np.sin(np.arange(n) / rate * 1.3)[:, None]
    return np.clip(gain * np.random.RandomState(seed).randn(n, 2) * env, -1, 1)


@pytest.mark.parametrize("at_48k,resampled_code", [("reference", "2202:"), ("target", "3003:")])
def test_process_resampled_input_with_previews_matches_jax(tmp_path, at_48k, resampled_code):
    """One track a 48 kHz PCM_24 file (resampled on the device) and both
    previews, cut from an 8 s track: the master and both previews within
    1 LSB of PCM_16 of ``matchering_tpu.process``, the same events."""
    rates = {"target": SR, "reference": SR, at_48k: 48000}
    for role, seed, gain in (("target", 3, 0.3), ("reference", 4, 0.9)):
        rate = rates[role]
        jwav.write(str(tmp_path / f"{role}.wav"), _track(8, rate, seed, gain), rate,
                   "PCM_24" if rate == 48000 else "PCM_16")
    config = dict(dtype="float64", preview_size=6, preview_analysis_step=2)
    files = {}
    try:
        for name, package, kwargs in (("jax", mj, {}), ("port", mt, {"device": "cpu"})):
            events = _events(package)
            paths = [str(tmp_path / f"{name}_{k}.wav") for k in ("master", "pt", "pr")]
            package.process(
                str(tmp_path / "target.wav"), str(tmp_path / "reference.wav"),
                [package.pcm16(paths[0])], package.Config(**config),
                package.pcm16(paths[1]), package.pcm16(paths[2]), **kwargs,
            )
            files[name] = (paths, events)
    finally:
        mj.log()
        mt.log()
    assert files["port"][1] == files["jax"][1]
    assert any(e.startswith(resampled_code) for e in files["port"][1])
    for jax_path, port_path, frames in zip(files["jax"][0], files["port"][0], (8 * SR, 6 * SR, 6 * SR)):
        jax_out, _ = jwav.read(jax_path, raw_int=True)
        port_out, rate = jwav.read(port_path, raw_int=True)
        assert rate == SR and port_out.shape == jax_out.shape == (frames, 2)
        assert np.max(np.abs(port_out.astype(np.int32) - jax_out)) <= 1


def test_process_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.process("t.wav", "r.wav", [mt.pcm16(str(tmp_path / "o.wav"))])
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.master(np.zeros((5000, 2)), np.zeros((5000, 2)), mt.Config())


def test_non_wav_input_raises_coded_error(tmp_path):
    """A truncated FLAC: the native codec rejects it, no ffmpeg can
    transcode it, and the role's coded error fires."""
    (tmp_path / "t.flac").write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(mt.ModuleError) as error:
        mt.load(str(tmp_path / "t.flac"), "target")
    assert error.value.code == mt.Code.ERROR_TARGET_LOADING


def test_import_loads_no_jax():
    code = (
        "import os, sys, matchering_tpu_torch, matchering_tpu_torch.farm, "
        "matchering_tpu_torch.parallel.batch, matchering_tpu_torch.parallel.launch, "
        "matchering_tpu_torch.io.native.binding, matchering_tpu_torch.io.native.build, "
        "matchering_tpu_torch.io.native.mp3, matchering_tpu_torch.io.native.opus, "
        "matchering_tpu_torch.io.native.vorbis; "
        "assert matchering_tpu_torch.io.native.binding.available(); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]; "
        "assert not bad, bad; "
        "maps = open('/proc/self/maps').read() if os.path.exists('/proc/self/maps') else ''; "
        "assert os.path.join('matchering_tpu', 'io', 'native') not in maps, 'loaded the JAX codec'; "
        "assert 'libmtpu_codec_' in maps or not maps"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120)


def test_star_import_binds_the_ports_ops_without_jax():
    """``ops`` is on the top-level surface, as in the JAX package, and is
    the port's own."""
    code = (
        "import sys\n"
        "from matchering_tpu_torch import *\n"
        "import matchering_tpu_torch.ops.iir as port_iir\n"
        "assert ops.iir.butter_lowpass is port_iir.butter_lowpass\n"
        "assert ops.__name__ == 'matchering_tpu_torch.ops'\n"
        "assert sorted(ops.__all__) == ['basics', 'blocks', 'convolve', 'fftpack', 'fir', 'iir', 'lowess', "
        "'resample', 'sliding', 'smoothing', 'spectrum']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (or without the package beside it) the smoke script
    exits non-zero and prints no result line."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "chip_smoke.py")
    lonely = tmp_path / "chip_smoke.py"
    lonely.write_bytes(open(script, "rb").read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for path, cwd in ((script, repo), (str(lonely), str(tmp_path))):
        run = subprocess.run(
            [sys.executable, path], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120,
        )
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
