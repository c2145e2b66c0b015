"""Tensor-, expert- and pipeline-parallel serving and the training slice of
the PyTorch engine.

``shardings`` says which axis of each parameter is split over ``tp`` and
which over ``ep``; ``serve`` lays the shards on devices (by stage first,
then over tp/ep) and holds the two collectives the sharded model needs;
``pp_serve`` holds the stage checks and the two pp decode schedules.
Training: ``mesh`` lays ``dp x sp x tp x ep`` ranks on devices, ``train``
holds the AdamW step, ``ring_attention`` and ``ulysses`` the two
sequence-parallel attention hooks, ``pipeline`` the GPipe forward. One
process drives every shard.
"""
