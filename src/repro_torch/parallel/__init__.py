"""The mesh context and parameter specs (port of ``repro.parallel``).  The
reference's JAX sharding machinery (``smap``, ``shard_map_compat``,
``spec_pspecs``, ``infer_shardings``, ``global_shape_dtypes``) has no
counterpart: the port runs one process per rank."""

from repro_torch.parallel.sharding import (LOGICAL_RULES, MeshCtx, ParamSpec,
                                           pad_to_multiple, padded)

__all__ = ["LOGICAL_RULES", "MeshCtx", "ParamSpec", "pad_to_multiple",
           "padded"]
