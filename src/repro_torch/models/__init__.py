# Model layers of the port, mirroring `repro.models`. So far only the
# Mamba2 SSD scan (`layers.ssd_chunked`), the oracle under kernel F.
