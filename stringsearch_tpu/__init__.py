"""stringsearch_tpu — a suffix-array and substring-search framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
fasterthanlime/stringsearch (suffixsearch) for a GPU: exact suffix-array
construction for byte text, SA-based longest-common-substring queries,
partitioned (sharded) construction over device meshes, BWT transforms,
verification oracles, and a crosscheck/bench/run harness with a trusted
C++ host oracle.

Layer map (mirrors reference layers, re-expressed as data-parallel code):

  harness/   CLI: crosscheck | bench | run         (ref: crates/divsuftest)
  parallel/  PartitionedSuffixArray over a Mesh    (ref: crates/sacapart)
  engines/   SACA engines: doubling, dc3           (ref: crates/{divsufsort,dc3})
  oracle/    C++ host oracle (SA-IS + utils)       (ref: crates/cdivsufsort)
  transforms/ BWT / inverse BWT                    (ref: c-sources/utils.c)
  core/      SuffixArray, verify, search, compare  (ref: crates/sacabase)
"""

from stringsearch_tpu.core.types import (
    LongestCommonSubstring,
    NotSorted,
    SuffixArray,
    StringIndex,
)
from stringsearch_tpu.core.verify import verify
from stringsearch_tpu.core.compare import common_prefix_len
from stringsearch_tpu.core.search import longest_substring_match, sa_search
from stringsearch_tpu.engines import build_suffix_array, get_engine
from stringsearch_tpu.parallel.partitioned import PartitionedSuffixArray

__version__ = "0.1.0"

__all__ = [
    "LongestCommonSubstring",
    "NotSorted",
    "SuffixArray",
    "StringIndex",
    "PartitionedSuffixArray",
    "verify",
    "common_prefix_len",
    "longest_substring_match",
    "sa_search",
    "build_suffix_array",
    "get_engine",
    "__version__",
]
