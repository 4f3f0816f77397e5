"""portbench: the benchmark of sinddm_tpu_torch on the H100 (see README.md)."""
