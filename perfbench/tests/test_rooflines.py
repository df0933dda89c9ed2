"""The operation and byte counts behind the kernels' roofline shares, at
the benchmark's own configurations and traffic."""

import pytest

from perfbench import core
from perfbench.reference import fir as ref

B1 = core.load_module(core.HERE / "rooflines" / "b1.py")
B4 = core.load_module(core.HERE / "rooflines" / "b4.py")


def config(name):
    return core.load_json(core.HERE / "configs" / f"{name}.json")


def traffic(name):
    return core.load_json(core.HERE / "traffic" / f"{name}.json")


def test_b1_counts_the_outputs_a_steady_step_emits():
    conf, mix = config("fir-44k1-48k-s64-db90"), traffic("lockstep_4096")
    W, L, M = ref.phase_weights(conf)
    sched = ref.Schedule(L, M, conf["taps"], conf["input_capacity"], ref.out_capacity(conf))
    emitted = [int(sched.feed(mix["chunk_frames"])[1][0]) for _ in range(20)]
    assert emitted[1:] == [4320] * 19  # 27 periods of M 160, not the 4321 slots of out_capacity
    assert B1.emitted_per_step(conf, mix["chunk_frames"]) == 4320
    flop, nbytes = B1.counts(conf, mix)
    assert flop == 2 * 4320 * 128 * 2048  # taps-wide, every lane
    assert round(flop / 1e9, 3) == 2.265
    assert round(nbytes / 1e6, 1) == 69.0
    # bound by its operations at the f32 peak
    assert B1.bound_seconds(conf, mix) == pytest.approx(flop / 67e12)


def test_b4_counts_at_the_fft_config():
    conf, mix = config("fft-44k1-48k"), traffic("device_chunks")
    flop, nbytes = B4.counts(conf, mix)
    assert round(flop / 1e9, 1) == 135.6
    assert round(nbytes / 1e6, 1) == 246.3
    assert B4.bound_seconds(conf, mix) == pytest.approx(flop / 989e12)


def test_b4_band_of_every_fft_config_is_a_data_file():
    bench = core.load_benchmark()
    for c in bench["configs"]:
        conf = core.load_json(core.ROOT / c["file"])
        if conf["engine"] == "fft":
            assert set(B4.band(conf)) >= {"rows", "wc", "cols", "s"}


def test_b4_raises_for_a_config_without_a_band():
    conf = dict(config("fft-44k1-48k"), name="fft-48k-96k", fft_size_input=882, fft_size_output=640)
    with pytest.raises(FileNotFoundError, match="fft-48k-96k"):
        B4.bound_seconds(conf, traffic("device_chunks"))
