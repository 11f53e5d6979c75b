"""The parallel layer on ``torch.distributed``: the device mesh and its
collectives (``mesh``), ray-, scene- and z-sharded rendering and training
(``dist``), the leaf-sharded tree (``leaf_shard``), the multi-process
runtime (``multihost``), the resumable render queue (``work_queue``) and a
multi-rank dry run (``dryrun``)."""
