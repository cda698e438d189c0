"""RIR post-processing of the port: air absorption (`air_abs`) and the
`process` stage (`process_outputs`).  Nothing is imported here, so that
importing the package pulls in neither scipy.signal nor h5py."""
