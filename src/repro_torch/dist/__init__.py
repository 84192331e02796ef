"""repro_torch.dist -- the distribution layer: FZ containers as a wire format.
The port of ``repro.dist`` over ``torch.distributed``, one module a use case:

  * ``sharding`` -- logical-axis resolution against any mesh (stand-ins too),
    with divisibility fallback to replication, and DTensor placements on a
    ``DeviceMesh`` (``ckpt/elastic.py`` builds on it);
  * ``compressed_allreduce`` -- the paper's §2.4 wire compression: the
    cross-pod gradient mean crosses the link as capacity-sized FZ containers
    instead of raw float32, with error feedback; the barrier form, kept as the
    bit-parity oracle;
  * ``bucketed_reduce`` -- the same reduce in size-targeted buckets issued in
    backward production order, and the ``grad_boundary`` taps;
  * ``flash_decode`` -- sequence-sharded decode attention: per-shard
    flash-decoding partials (K7 or the plain version) combined over a mesh
    dimension;
  * ``compat`` -- ``DeviceMesh`` construction.

Multi-rank forms need a process group (``torch.distributed.init_process_group``:
NCCL on cards, gloo on the CPU); a rank is a pod.
"""
from . import (bucketed_reduce, compat, compressed_allreduce,  # noqa: F401
               flash_decode, sharding)
