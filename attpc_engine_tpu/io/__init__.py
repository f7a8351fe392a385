"""I/O layer (L4): HDF5 kinematics files, Spyral cloud files, converters."""

from .kinematics_file import KinematicsArrays, KinematicsWriter, KinematicsReader

__all__ = ["KinematicsWriter", "KinematicsReader", "KinematicsArrays"]
