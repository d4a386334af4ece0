"""ingest_faces_per_s: `faces_per_s` for the cells that embed from
canvases (alignment included). Kept apart: the host's share of an ingest
call (the canvases' pageable upload, the cp2tform solve) makes its runs
spread several times wider, and one bound for both would hide a
regression of the aligned-face cells."""

from benchmarks.harness import reader

read = reader("faces_per_s").read
