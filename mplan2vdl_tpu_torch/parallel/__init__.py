"""Distribution layer.  Only the fold walker that ``engine/fuse.py``
imports exists so far; sharded execution comes with a later slice."""
