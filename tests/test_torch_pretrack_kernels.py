"""The handoff search kernels (csrc/pretrack.cu) through their host build
(csrc/pretrack_host.cpp, g++) against the plain torch loops, on the CPU.

The plain versions are the loops the kernels replace:
``acquire/engine.py:squared_prompts_plain`` (the squared-prompt Doppler
search's prompts) and ``track/pretrack.py:_pretrack_power`` (the
half-chip code search's power).  Each kernel block replays the epoch
recurrences (code phase, carrier phase) from epoch 0: they must equal
the plain loop's state bit for bit at every epoch, and the replica's
chip index must equal ``ops/replica.sample_replicas``'s at samples
within an ulp of a chip edge.  The prompts and the power match the plain
loops to rtol 1e-5 of each channel's largest: the two sides add an
epoch's 2046 products in other orders (the kernels' per-thread, warp
butterfly and warp tree order against torch's sums) and take the
carrier's sin and cos by sincospif against torch's cos and sin of
-2 pi x, a few float32 ulps of the sums either way (2e-7 on these
captures).  The Doppler bins and the code search's peaks are equal.
The wrappers refuse what the kernels do not take, and CPU tensors take
the plain loops.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.acquire import engine
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as PLAN
from stm32f4_sdr_gps_torch.config import FREQ_L1_HZ, TrackConfig
from stm32f4_sdr_gps_torch.ops.kernel_lib import host_lib
from stm32f4_sdr_gps_torch.ops.replica import sample_replicas
from stm32f4_sdr_gps_torch.ops.wipeoff import carrier_wipeoff
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.track import pretrack

torch.set_num_threads(2)

S = PLAN.samples_per_epoch
K = TrackConfig().pre_track_zone_halfchips + 1
RTOL = 1e-5


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# -- the epoch recurrences and the chip index, bit for bit -------------------

def _plain_states(cp0, dop, e):
    """The code and carrier phase the plain loops hold at the start of
    each of ``e`` epochs, (E, C) each: the squared-prompt loop's code
    phase step and the carrier NCO of ops.wipeoff."""
    cp = torch.as_tensor(cp0)
    d = torch.as_tensor(dop)
    cpe = engine._code_rate(d, PLAN) * S
    ph = torch.zeros_like(d)
    zeros = torch.zeros(S, dtype=torch.complex64)
    cps, phs = [], []
    for _ in range(e):
        cps.append(cp)
        phs.append(ph)
        cp = torch.remainder(cp + cpe, 1023.0)
        _, ph = carrier_wipeoff(zeros, d, ph, PLAN.sample_rate_hz)
    return torch.stack(cps).numpy(), torch.stack(phs).numpy()


@pytest.mark.parametrize("e", [20, 32, 256, 512])
def test_epoch_states_bit_for_bit(e):
    rng = np.random.default_rng(e)
    cp0 = np.concatenate([
        np.float32([0.0, 1022.9999, np.nextafter(np.float32(1023), 0),
                    511.5, 1e-6]),
        rng.uniform(0, 1023, 11)]).astype(np.float32)
    dop = np.concatenate([
        np.float32([0.0, -5000.0, 5000.0, 0.25, -999.75]),
        rng.uniform(-7000, 7000, 11)]).astype(np.float32)
    want_cp, want_ph = _plain_states(cp0, dop, e)
    rate = engine._code_rate(torch.as_tensor(dop), PLAN).numpy()
    c = len(cp0)
    got_cp = np.empty((e, c), np.float32)
    got_ph = np.empty((e, c), np.float32)
    assert host_lib().pretrack_states_host(
        _ptr(cp0), _ptr(rate), _ptr(dop), _ptr(got_cp), _ptr(got_ph), e, c,
        S, engine._s_over_fs(S, PLAN)) == 0
    np.testing.assert_array_equal(got_cp.view(np.int32),
                                  want_cp.view(np.int32))
    np.testing.assert_array_equal(got_ph.view(np.int32),
                                  want_ph.view(np.int32))


def test_chip_index_at_chip_edges():
    """Code phases placed so that fma(rate, k, cp + lag) lands within an
    ulp of a chip edge at chosen samples, at the nominal and at
    carrier-aided rates, over every lag of the code search."""
    k0 = np.array([1, 2, 3, 700, 1000, 1501, 2045])
    rates = np.float32([0.5, 0.5 * (1 + 3000.0 / FREQ_L1_HZ),
                        0.5 * (1 - 4500.0 / FREQ_L1_HZ)])
    rate_l, cp_l = [], []
    for r in rates:
        for k in k0:
            for n in (17.0, 511.0, 1022.0):
                cp = np.float32(n - np.float64(r) * k)
                for step in (-1, 0, 1):
                    rate_l.append(r)
                    cp_l.append(cp if step == 0 else np.nextafter(
                        cp, np.float32(step * 2048)))
    rate = np.asarray(rate_l, np.float32)
    cp = np.asarray(cp_l, np.float32)
    c = len(cp)
    lags = ((np.arange(K, dtype=np.float32) - (K - 1) / 2.0) * 0.5).astype(
        np.float32)
    index_table = torch.arange(1023, dtype=torch.float32).repeat(c, 1)
    want = sample_replicas(index_table, torch.as_tensor(cp),
                           torch.as_tensor(rate), S, lags).numpy()
    base = (cp[:, None, None] + lags[None, :, None]).astype(np.float32)
    base = np.broadcast_to(base, (c, K, S)).ravel().copy()
    ks = np.broadcast_to(np.arange(S, dtype=np.int32),
                         (c, K, S)).ravel().copy()
    rr = np.broadcast_to(rate[:, None, None], (c, K, S)).ravel().copy()
    got = np.empty(base.size, np.int32)
    assert host_lib().pretrack_chip_host(_ptr(rr), _ptr(ks), _ptr(base),
                                         _ptr(got), base.size) == 0
    np.testing.assert_array_equal(got.reshape(c, K, S),
                                  want.astype(np.int32))
    # the check reached the edges: the exact position within a float32
    # ulp of a whole chip at many samples, and wrapped below chip 0
    exact = rr.astype(np.float64) * ks + base
    near = np.abs(exact - np.round(exact)) <= np.spacing(
        np.abs(exact).astype(np.float32)).astype(np.float64)
    assert near.sum() > 1000
    assert (exact < 0).any() and (got.reshape(c, K, S) == 1022).any()


# -- the prompts and the power against the plain loops -----------------------

@pytest.fixture(scope="module", params=[4, 32])
def capture(request):
    """A simulated capture of C satellites at 45 dBHz and the handoff's
    inputs: each acquired code phase within 0.3 chip and each coarse
    Doppler within 200 Hz of the planted ones."""
    c = request.param
    prns = [2, 7, 15, 24] if c == 4 else list(range(1, 33))
    rng = np.random.default_rng(100 + c)
    dop = rng.uniform(-4500, 4500, c)
    cp = rng.uniform(0, 1023, c)
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=q, cn0_dbhz=45.0)
            for p, d, q in zip(prns, dop, cp)]
    x, _ = simulate_capture(sats, 40, PLAN, seed=c)
    return {
        "epochs": torch.as_tensor(x[: 32 * S].reshape(32, S)),
        "table": torch.as_tensor(ca_table_bipolar(prns)),
        "cp": torch.as_tensor((cp + rng.uniform(-0.3, 0.3, c)) % 1023.0,
                              dtype=torch.float32),
        "dop": torch.as_tensor(dop + rng.uniform(-200, 200, c),
                               dtype=torch.float32),
    }


def _spectrum_bins(prompts):
    e = prompts.shape[0]
    return torch.argmax(torch.abs(torch.fft.fft(prompts * prompts, n=8 * e,
                                                dim=0)), dim=0)


def test_host_prompts_match_plain(capture):
    args = (capture["epochs"], capture["table"], capture["cp"],
            capture["dop"], PLAN)
    want = engine.squared_prompts_plain(*args)
    got = engine.squared_prompts_host(*args)
    assert got.shape == want.shape == (32, len(capture["cp"]))
    scale = want.abs().amax(dim=0)
    assert ((got - want).abs() <= RTOL * scale).all()
    assert torch.equal(_spectrum_bins(got), _spectrum_bins(want))


def test_host_power_matches_plain(capture):
    fine = engine.refine_doppler_device(
        capture["epochs"], capture["table"], capture["cp"], capture["dop"],
        PLAN)
    epochs = capture["epochs"][:20]
    args = (epochs, capture["table"], capture["cp"], fine, PLAN, K)
    want = pretrack._pretrack_power(*args)
    corr, got = pretrack.pretrack_power_host(*args)
    assert corr.shape == (20, len(fine), K) and got.shape == want.shape
    scale = want.amax(dim=1, keepdim=True)
    assert ((got - want).abs() <= RTOL * scale).all()
    # the power is the correlations' summed over the epochs
    torch.testing.assert_close(got, (corr.abs() ** 2).sum(0), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(got.argmax(1), want.argmax(1))
    # the signal is where the acquisition put it, within 0.3 chip
    assert ((got.argmax(1) - (K - 1) // 2).abs() <= 1).all()


# -- the wrappers --------------------------------------------------------------

def _inputs(c=3, e=4, s=S):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((e, s)) + 1j * rng.standard_normal((e, s)))
    return [torch.as_tensor(x.astype(np.complex64)),
            torch.as_tensor(ca_table_bipolar(list(range(1, c + 1)))),
            torch.as_tensor(rng.uniform(0, 1023, c), dtype=torch.float32),
            torch.as_tensor(rng.uniform(-5e3, 5e3, c), dtype=torch.float32)]


def _bad(case):
    args = _inputs()
    if case == "epochs_dtype":
        args[0] = args[0].to(torch.complex128)
    elif case == "epochs_shape":
        args[0] = args[0].reshape(-1)
    elif case == "too_many_samples":
        args = _inputs(s=2 * S)
    elif case == "no_epochs":
        args[0] = args[0][:0]
    elif case == "table_dtype":
        args[1] = args[1].to(torch.float64)
    elif case == "table_shape":
        args[1] = args[1][:, :1022]
    elif case == "phase_dtype":
        args[2] = args[2].to(torch.float64)
    elif case == "phase_shape":
        args[2] = args[2][:2]
    elif case == "doppler_dtype":
        args[3] = args[3].to(torch.int32)
    elif case == "not_contiguous":
        args[0] = torch.as_tensor(np.asfortranarray(args[0].numpy()))
    elif case == "other_device":
        args[1] = args[1].to("meta")
    return args


BAD = ["epochs_dtype", "epochs_shape", "too_many_samples", "no_epochs",
       "table_dtype", "table_shape", "phase_dtype", "phase_shape",
       "doppler_dtype", "not_contiguous", "other_device"]


@pytest.mark.parametrize("case", BAD)
@pytest.mark.parametrize("kernel", ["prompts", "power"])
def test_host_build_refuses(kernel, case):
    args = _bad(case)
    with pytest.raises(ValueError):
        if kernel == "prompts":
            engine.squared_prompts_host(*args, PLAN)
        else:
            pretrack.pretrack_power_host(*args, PLAN, K)


@pytest.mark.parametrize("k", [0, pretrack.MAX_OFFSETS + 1])
def test_power_refuses_offsets(k):
    with pytest.raises(ValueError, match="num_offsets"):
        pretrack.pretrack_power_host(*_inputs(), PLAN, k)


@pytest.mark.parametrize("kernel", ["prompts", "power"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        if kernel == "prompts":
            engine.squared_prompts_cuda(*_inputs(), PLAN)
        else:
            pretrack.pretrack_power_cuda(*_inputs(), PLAN, K)


@pytest.mark.parametrize("kernel", ["prompts", "power"])
def test_no_search_on_other_devices(kernel):
    args = [a.to("meta") for a in _inputs()]
    with pytest.raises(ValueError, match="for device meta"):
        if kernel == "prompts":
            engine.squared_prompts(*args, PLAN)
        else:
            pretrack.refine_code_phase_device(*args, PLAN, K)


def test_cpu_tensors_take_the_plain_loops():
    x, table, cp, dop = _inputs()
    calls = (engine.squared_prompts_plain.calls,
             pretrack._pretrack_power.calls)
    launches = (engine.squared_prompts_cuda.launches,
                pretrack.pretrack_power_cuda.launches)
    fine = engine.refine_doppler_device(x, table, cp, dop, PLAN)
    power = pretrack.refine_code_phase_device(x, table, cp, fine, PLAN, K)
    assert (engine.squared_prompts_plain.calls,
            pretrack._pretrack_power.calls) == (calls[0] + 1, calls[1] + 1)
    assert (engine.squared_prompts_cuda.launches,
            pretrack.pretrack_power_cuda.launches) == launches
    assert torch.equal(power, pretrack._pretrack_power(x, table, cp, fine,
                                                       PLAN, K))


def test_refine_code_phase_takes_device_inputs_in_place():
    """refine_code_phase on tensors already on the device, with the code
    phases' device copy given, equals the numpy call."""
    x, table, cp, dop = _inputs(e=20)
    cp_host = cp.numpy().astype(np.float64)
    samples = x.reshape(-1)
    want = pretrack.refine_code_phase(samples, table.numpy(), cp_host,
                                      dop.numpy().astype(np.float64), PLAN,
                                      device="cpu")
    got = pretrack.refine_code_phase(samples, table, cp_host, dop, PLAN,
                                     device="cpu", code_phase_device=cp)
    np.testing.assert_array_equal(got, want)
