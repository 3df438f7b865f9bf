"""Graph-simplification layer: the re-implementation of the
reference's SimplifyGraph executables (`fullsimplify`, `parsimplify`;
reference: src/SimplifyGraph/).

Structure:
- core        Edge model, inner-read rope, deterministic ordered graph
- pargraph    parsimplify equivalent (per-partition contraction + dead ends)
- engine      fullsimplify equivalent (operators, flow, contigs, scaffolds)
- flow        min-cost-flow problem generation + native MCMF solver
- params      parameter sets mirroring the reference's cfg semantics
"""
