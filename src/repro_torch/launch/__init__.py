"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun`` and ``.analyze``) and the launch tools they are
built on: the assigned input shapes (``shapes``), the roofline terms of
a step (``roofline``), the mesh over ``torch.distributed`` (``mesh``)
and the per-op cost of a step (``op_cost``)."""
