"""Partition rules over a device mesh (``sharding``)."""
