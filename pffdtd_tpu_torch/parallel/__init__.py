"""The x-slab multi-device engine: host partition (`partition`) and the
one-process engine over a device list (`sharded_engine`)."""
