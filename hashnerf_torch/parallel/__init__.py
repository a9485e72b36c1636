"""Multi-device training over torch.distributed (counterpart of
hashnerf_tpu/parallel/): process groups and batch sharding (mesh.py), the
data-parallel and ZeRO-1 steps (train_sharded.py), the level-sharded table
(table_sharded.py), and the three modes' dry run (dryrun.py)."""
