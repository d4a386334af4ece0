"""ingest_batch_ms_p95: `batch_ms_p95` for the cells that embed from
canvases, apart for `ingest_faces_per_s`'s reason."""

from benchmarks.harness import reader

read = reader("batch_ms_p95").read
