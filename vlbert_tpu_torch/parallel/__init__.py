"""Process groups and collectives (port of vlbert_tpu/parallel)."""
