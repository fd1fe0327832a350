"""graph_share.batch: the share of the window's forwards served by a CUDA
graph's replay, over hand-made ``host_traces``; nothing where the program
counts no replays (a program without the graph route)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100_bench.lib import harness

NAME = "graph_share.batch"


def test_the_graph_share_reads_the_window_calls():
    run = SimpleNamespace(host_traces=[{"forwards": 40, "graph_replays": 36, "graph_captures": 4},
                                       {"forwards": 60, "graph_replays": 60, "graph_captures": 0}])
    assert harness.load_metric(NAME).read(run) == pytest.approx(96.0)


@pytest.mark.parametrize("traces", [[], [{"forwards": 44, "blocks": 1282}],
                                    [{"forwards": 0, "graph_replays": 0}]],
                         ids=["no calls", "no counter", "no forwards"])
def test_the_graph_share_reads_nothing_where_there_is_nothing(traces):
    assert harness.load_metric(NAME).read(SimpleNamespace(host_traces=traces)) is None


def test_a_program_without_graphs_reads_zero():
    run = SimpleNamespace(host_traces=[{"forwards": 3, "graph_replays": 0, "graph_captures": 0}])
    assert harness.load_metric(NAME).read(run) == 0.0
