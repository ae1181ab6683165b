"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train`` and ``.dryrun``) and the launch tools the dry run is built
on: the assigned input shapes (``shapes``) and the roofline terms of a
step on one card (``roofline``)."""
