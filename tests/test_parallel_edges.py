"""removeParallelEdges operator (reference: OverlapGraph::removeParallelEdges,
src/SimplifyGraph/src/OverlapGraph.cpp:1611-1648 — present in the reference
but not invoked by its main flow, main.cpp:176)."""
from conftest import GOLDEN, PARAM_FILES
from disco_tpu.simplify.dataset import SimplifyDataset
from disco_tpu.simplify.engine import FullGraph
from disco_tpu.simplify.params import Params
from disco_tpu.simplify.pargraph import parsimplify


def _graph_from_lines(lines):
    d = GOLDEN / "mini"
    params = Params()
    params.set_parameters(PARAM_FILES[0])
    dataset = SimplifyDataset([], [], [str(d / "reads.fasta")])
    graph = FullGraph(dataset, params)
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        f.write("\n".join(lines) + "\n")
        path = f.name
    graph.read_par_edges(path)
    graph.sort_edges_by_dest()
    return graph


def test_remove_parallel_edges():
    # three parallel 1->2 edges with distinct offsets/orientations and an
    # unrelated 3->4 edge; the longest 1->2 edge (offset 150) must survive
    graph = _graph_from_lines([
        "1\t2\t0,100,0,0,0,0",
        "1\t2\t1,150,0,0,0,0",
        "1\t2\t2,120,0,0,0,0",
        "3\t4\t0,80,0,0,0,0",
    ])
    assert graph.n_edges == 8  # 4 fwd + 4 twins
    removed = graph.remove_parallel_edges()
    assert removed == 2
    assert graph.n_edges == 4
    kept = [e for e in graph.g.at(1) if e.dst == 2]
    assert len(kept) == 1 and kept[0].offset == 150
    assert len(graph.g.at(3)) == 1
    # twins of the losers are gone from node 2 as well
    assert len([e for e in graph.g.at(2) if e.dst == 1]) == 1
    # idempotent
    assert graph.remove_parallel_edges() == 0


def test_remove_parallel_edges_real_graph(tmp_path):
    """Invariant check on a real partial graph: after one pass no node
    retains two edges sharing a destination."""
    d = GOLDEN / "mini"
    params = Params()
    params.set_parameters(PARAM_FILES[0])
    dataset = SimplifyDataset([], [], [str(d / "reads.fasta")])
    dataset.store_contained_read_info(
        [str(d / "mini_0_containedReads.txt")])
    graph = FullGraph(dataset, params)
    out = str(tmp_path / "pse.txt")
    parsimplify(str(d / "mini_0_parGraph.txt"), out, params.min_ovl, 1)
    graph.read_par_edges(out)
    graph.sort_edges_by_dest()
    edges_before = graph.n_edges
    removed = graph.remove_parallel_edges()
    assert graph.n_edges == edges_before - 2 * removed
    for k in graph.g:
        dsts = [e.dst for e in graph.g.at(k)]
        assert len(dsts) == len(set(dsts)), f"node {k} kept parallel edges"
