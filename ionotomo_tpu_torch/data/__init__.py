"""Host-side observation data: arrays, DataPacks, h5parm, synthetic
worlds, ionosonde probes and antenna/facet selection (port of
``ionotomo_tpu.data``)."""
