"""Host-side observation data: arrays, DataPacks, h5parm, synthetic
worlds and ionosonde probes (port of ``ionotomo_tpu.data``)."""
