"""Host-side data pipeline: datasets, transforms, class-uniform sampling.

The pipeline is TPU-idiomatic: per-host index sampling feeds worker-side
numpy/PIL transforms that emit fixed-shape NHWC batches; each host loads
only its shard of the global batch (replaces DataLoader+DistributedSampler,
reference: datasets/__init__.py:45-199, datasets/sampler.py).
"""
