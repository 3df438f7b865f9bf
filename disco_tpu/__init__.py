"""disco_tpu — an overlap-layout-consensus (OLC) metagenome co-assembly
engine with the capabilities of Disco (abiswas-odu/Disco), built from
scratch on JAX/XLA.  The overlap phase runs on the accelerator (an NVIDIA
GPU); graph traversal and simplification run on the host.

Architecture:

- ``io``       host-side FASTA/FASTQ streaming, read QC, 2-bit packing.
- ``index``    sorted canonical (L-1)-mer fingerprint table (replaces the
               reference's chained prefix/suffix hash table,
               reference: src/BuildGraph/src/HashTable.cpp).
- ``overlap``  device-batched candidate generation + packed-word overlap
               verification (replaces the byte-wise substring compares in
               reference: src/BuildGraph/src/OverlapGraph.cpp:517-595).
- ``buildg``   graph-construction front end: containment marking, edge
               relation, transitive reduction, parity-exact replay of the
               reference's traversal for bit-identical outputs.
- ``simplify`` graph simplification operators, min-cost-flow pruning,
               contig emission, scaffolding (reference: src/SimplifyGraph).
- ``dist``     multi-device sharding of the overlap phase over a
               jax.sharding.Mesh (replaces MPI / MPI-3 RMA).
- ``utils``    config, logging, stats (assemblyStats parity), checkpoints.

64-bit integer support is required for fingerprint keys; we enable it once
at package import.  The persistent compilation cache is the directory
JAX_COMPILATION_CACHE_DIR names when it is set (JAX reads it itself);
otherwise a fixed `.jax_cache/` at the checkout root, so every run of one
checkout finds the programs an earlier run compiled.
"""
import os
import pathlib

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))

__version__ = "0.1.0"
