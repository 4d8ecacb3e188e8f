"""Data generators of the traffic mixes, by the dataset format they write."""
