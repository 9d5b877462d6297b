"""Multi-device training on torch.distributed: the ('data', 'model') mesh
(mesh.py), the mappers' tensor-parallel FFNs (tensor_parallel.py) and a
launcher of real OS processes (multiproc.py)."""
