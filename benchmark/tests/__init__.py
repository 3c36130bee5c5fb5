"""The benchmark harness's own tests (CPU; card-only cases carry the cuda marker)."""
