"""K-mer models: lane arithmetic, canonicalization, minimizers.

The device-side analog of gatb kmer/impl/Model.hpp (ModelDirect /
ModelCanonical / ModelMinimizer) and tools/math/LargeInt.
"""

from bcalm_tpu.models import lanes  # noqa: F401
