"""The port's programs as traced graphs, and four checks over them
(counterpart: ``diff3d_tpu/analysis/``).

The JAX package reads its compiled programs' StableHLO; the port's
inspectable program is an FX graph of aten ops and the port's kernel ops,
traced with ``make_fx`` on fake tensors (:mod:`.ir`):
:meth:`~diff3d_tpu_torch.sampling.Sampler.lower_step_many` and
:meth:`~diff3d_tpu_torch.serving.cache.ProgramCache.lower` return such
programs, and the registry (:mod:`.shardcheck`) builds the JAX
registry's eight.  Four checks pin each program as JSON manifests under
``runs/torch_{shardcheck,memcheck,equivcheck,rngcheck}/``
(:mod:`.manifests`): collectives, upcasts, host syncs, kernel nodes and
placement (:mod:`.shardcheck`); peak bytes, in-place updates and
step-invariant FLOPs (:mod:`.memcheck`, :mod:`.mem`); a canonical
fingerprint, dead nodes and duplicates (:mod:`.equivcheck`,
:mod:`.equiv`); the draw stream and the sources' generator discipline
(:mod:`.rngcheck`).  ``python -m diff3d_tpu_torch.analysis --help``.
"""
