"""The reference's three user examples on the port: ``helloworld`` (three
NodeHosts, one replicated KV shard), ``ondisk`` (a tan-backed shard that
recovers across runs) and ``multigroup_device`` (many device-resident
shards on one engine).  Each runs as ``python -m
dragonboat_tpu_torch.examples.<name>`` on the CUDA card, or with
``--device cpu`` on the CPU."""
