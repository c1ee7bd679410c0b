"""asgart_tpu — segmental-duplication discovery on a JAX device engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of ASGART
(delehef/asgart v2.5.1): find large approximate duplication families
(direct / reversed / complemented) within or between DNA sequences up to
whole-genome scale, and slice / extract / plot the results.

Compute-path design (data-parallel, not a port):
  * packed 3-bit genome codes live in device memory,
  * the index is a true suffix array (built natively by our own C++ SA-IS)
    exposed on device as a sorted packed-k-mer view plus a dense prefix
    bucket table, so a seed probe lookup is a vectorized binary search,
  * probe batches are data-parallel across a ``jax.sharding.Mesh``,
  * the gap-tolerant arm automaton (reference: ``src/automaton.rs``) is
    provided as an exact host oracle, a fast native C++ engine, and an
    on-device ``lax.scan`` formulation.

The JSON result schema is byte-compatible with the reference
(``src/structs.rs``, ``src/exporters.rs``).
"""

__version__ = "0.1.0"

COLLAPSED_NAME = "ASGART_COLLAPSED"
ALPHABET = b"ATGCN"
ALPHABET_MASKED = b"atgcn"
