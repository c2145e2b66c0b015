"""Tensor- and expert-parallel serving of the PyTorch engine.

``shardings`` says which axis of each parameter is split over ``tp`` and
which over ``ep``; ``serve`` lays the shards on devices and holds the two
collectives the sharded model needs. One process drives every shard.
"""
