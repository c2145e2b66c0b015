"""Tensor-, expert- and pipeline-parallel serving of the PyTorch engine.

``shardings`` says which axis of each parameter is split over ``tp`` and
which over ``ep``; ``serve`` lays the shards on devices (by stage first,
then over tp/ep) and holds the two collectives the sharded model needs;
``pp_serve`` holds the stage checks and the two pp decode schedules. One
process drives every shard.
"""
