"""Mesh-axis rules of the port: logical axes to ``DeviceMesh`` dimensions."""

from repro_torch.parallel.sharding import logical_to_spec, named_sharding, shard, sharding_context
