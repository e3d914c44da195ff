"""One level split along x over several ranks (torch.distributed): the
slab mesh and its exchanges (mesh.py), the rank launcher (launch.py) and
the jobs its ranks run (workers.py)."""
