"""The readers of the program's stage spans (``harness/spans.py``) on
traces built by hand: each of the six against a count made by hand, the
entry's own time with the TTIs and the radio set-up nested in it taken
out, and silence where a trace has no kernels, no spans, or launches that
do not pair with its kernels."""
import pytest

from crrm_bench_toy import BENCH  # noqa: F401  (puts the harness on the path)
from crrm_bench.harness import manifest, spans, trace

SPAN_METRICS = ("entry_host_ms_per_tti", "radio_host_ms_per_tti",
                "radio_device_ms_per_tti", "sched_host_ms_per_tti",
                "sched_device_ms_per_tti", "host_syncs_per_tti")
CTX = {"ttis": 2, "params": {}, "fused_sinr_rows": 0.0,
       "fused_sinr_launches": 0}

#: a 2-TTI rollout: host spans and runtime calls, in us
SPANS = [("crrm.rollout", 0.0, 100.0), ("crrm.radio_init", 2.0, 12.0),
         ("crrm.tti", 20.0, 50.0), ("crrm.radio", 22.0, 30.0),
         ("crrm.sched", 32.0, 40.0), ("crrm.tti", 50.0, 90.0),
         ("crrm.radio", 52.0, 58.0), ("crrm.sched", 60.0, 70.0)]
#: launch call -> its kernel's device interval; the launches at 45 (the
#: TTI, no stage), 95 (the call) and 110 (the harness) are in no stage
LAUNCHES = [(5.0, (6.0, 8.0)), (24.0, (26.0, 29.0)), (34.0, (40.0, 50.0)),
            (36.0, (50.0, 55.0)), (45.0, (56.0, 57.0)), (55.0, (57.0, 58.0)),
            (62.0, (60.0, 64.0)), (95.0, (96.0, 98.0)),
            (110.0, (111.0, 112.0))]
#: two waits inside spans, the harness's own after the call outside
SYNCS = [("cudaStreamSynchronize", 14.0, 16.0),
         ("cudaStreamSynchronize", 38.0, 39.0),
         ("cudaDeviceSynchronize", 105.0, 115.0)]


def hand_trace(launches=LAUNCHES, host_spans=SPANS, api="cudaLaunchKernel"):
    host = list(host_spans) + SYNCS
    host += [(api, t, t + 0.5) for t, _ in launches]
    host += [("aten::mul", 23.0, 25.0), ("aten::scatter_reduce_", 33.0, 37.0)]
    dev = [(f"kernel_{i}", s, e) for i, (_, (s, e)) in enumerate(LAUNCHES)]
    dev.append(("Memcpy DtoH (Device -> Pageable)", 14.5, 15.0))
    return trace.Trace(device=dev, host=host, window_s=120e-6)


#: by hand, over 2 TTIs: radio spans 10 + 8 + 6 us, their kernels 2 + 3 +
#: 1 us; sched spans 8 + 10 us, their kernels 10 + 5 + 4 us; the rollout's
#: 100 us less radio_init 10 and the TTIs 30 + 40; 2 waits
HAND = {"entry_host_ms_per_tti": 20e-3 / 2,
        "radio_host_ms_per_tti": 24e-3 / 2,
        "radio_device_ms_per_tti": 6e-3 / 2,
        "sched_host_ms_per_tti": 18e-3 / 2,
        "sched_device_ms_per_tti": 19e-3 / 2,
        "host_syncs_per_tti": 2 / 2}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_against_a_hand_count(metric):
    read = manifest.reader(BENCH, metric)
    assert read(hand_trace(), CTX) == pytest.approx(HAND[metric])


@pytest.mark.parametrize("api", ["cudaLaunchKernelExC", "cuLaunchKernel",
                                 "cuLaunchKernelEx"])
def test_every_launch_call_pairs(api):
    read = manifest.reader(BENCH, "sched_device_ms_per_tti")
    assert read(hand_trace(api=api), CTX) == pytest.approx(19e-3 / 2)


@pytest.mark.parametrize("entry", ["env", "twin"])
def test_entry_time_leaves_out_the_ttis_and_radio_init(entry):
    outer = {"env": [("crrm.env.step", 0.0, 200.0),
                     ("crrm.env.score", 150.0, 180.0),
                     ("crrm.env.reset", 180.0, 195.0)],
             "twin": [("crrm.twin.chunk", 0.0, 200.0),
                      ("crrm.twin.summary", 150.0, 180.0),
                      ("crrm.twin.checkpoint", 180.0, 195.0)]}[entry]
    host = outer + [("crrm.rollout", 10.0, 150.0),
                    ("crrm.radio_init", 12.0, 18.0),
                    ("crrm.tti", 20.0, 60.0), ("crrm.tti", 60.0, 100.0)]
    tr = hand_trace(host_spans=host)
    # 200 us of entry spans, less 6 of radio set-up and 80 of TTIs
    assert spans.entry_ms_per_tti(tr, CTX) == pytest.approx(114e-3 / 2)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_silent_without_kernels(metric):
    tr = hand_trace()._replace(device=[])           # a CPU trace
    assert manifest.reader(BENCH, metric)(tr, CTX) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_silent_when_launches_and_kernels_do_not_pair(metric):
    tr = hand_trace(launches=LAUNCHES[:-1])
    assert manifest.reader(BENCH, metric)(tr, CTX) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_silent_on_a_program_without_spans(metric):
    tr = hand_trace(host_spans=[])
    assert manifest.reader(BENCH, metric)(tr, CTX) is None


def test_interval_algebra():
    merged = spans.union([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert merged == [[0, 3], [5, 9]]
    assert spans.length(merged) == 7
    assert spans.minus(merged, spans.union([(1, 2), (6, 7), (8, 20)])) == \
        [[0, 1], [2, 3], [5, 6], [7, 8]]
    inside = spans.within(merged)
    assert [inside(t) for t in (-1, 0, 4, 9, 10)] == [False, True, False,
                                                      True, False]
