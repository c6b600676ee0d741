"""The program's side of a run: the port's input type for the graph.  The
drivers under ``traffic/`` import the port's entry points themselves;
nothing else of the benchmark imports the port."""
from __future__ import annotations

from repro_torch.core.primitives import SparseCOO

from perfbench import graphs


def adjacency(inputs: graphs.Inputs) -> SparseCOO:
    """The normalized adjacency of ``inputs`` as the port's ``SparseCOO``."""
    rows, cols, vals = graphs.program_adjacency(inputs.n, inputs.src,
                                                inputs.dst)
    return SparseCOO((inputs.n, inputs.n), rows, cols, vals,
                     tag="adjacency")
