"""Multi-rank layer over torch.distributed: the (dp, pt) mesh
(mesh.py), joining the process group (distributed.py) and the multi-rank
dry run (dryrun.py). Counterpart of mina_bridge_tpu/parallel/."""
