"""The metrics read from the program's spans and counters: each file's
arithmetic over hand-made ``host_traces``, nothing where the program
reports none (a program without the spans), and all four in a traced run
of a tiny serving cell on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100_bench.lib import harness
from h100_bench.tests.helpers import cpu_run, tiny_cell

SHARES = {"fragment_share.batch": "engine.fragments", "dispatch_share.batch": "engine.dispatch",
          "device_wait_share.batch": "engine.fetch"}
NEW = (*SHARES, "pad_share.batch")


def _trace(process, fragments, dispatch, fetch, slots, valid):
    return {"total_seconds": process, "engine.process_seconds": process,
            "engine.fragments_seconds": fragments, "engine.dispatch_seconds": dispatch,
            "engine.fetch_seconds": fetch, "token_slots": slots, "valid_tokens": valid}


def test_the_span_metrics_read_the_window_calls():
    run = SimpleNamespace(host_traces=[_trace(1.0, 0.2, 0.1, 0.05, 1000, 900),
                                       _trace(3.0, 0.6, 0.5, 0.15, 3000, 2700)])
    read = {name: harness.load_metric(name).read(run) for name in NEW}
    assert read == {"fragment_share.batch": pytest.approx(20.0),
                    "dispatch_share.batch": pytest.approx(15.0),
                    "device_wait_share.batch": pytest.approx(5.0),
                    "pad_share.batch": pytest.approx(10.0)}


@pytest.mark.parametrize("traces", [[], [{"total_seconds": 1.0, "preprocess_seconds": 0.4}]],
                         ids=["no calls", "no spans"])
def test_the_span_metrics_read_nothing_where_there_is_nothing(traces):
    run = SimpleNamespace(host_traces=traces)
    assert {name: harness.load_metric(name).read(run) for name in NEW} == dict.fromkeys(NEW)


def test_a_traced_tiny_serving_run_reports_them():
    from h100_bench import run as command

    run = cpu_run(tiny_cell("gte-base.batch512"), trace=True)
    assert run.correct
    got = command.per_layer(run)
    assert set(NEW) <= set(got)
    assert all(0.0 <= got[name]["value"] <= 100.0 for name in NEW)
    # The calls' phases name what the host did in the slice.
    assert all(label.startswith("host: ") and "no torch op" not in label
               for label, _ in run.summary["idle_gaps"])
