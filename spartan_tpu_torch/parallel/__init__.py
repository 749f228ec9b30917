"""The multi-device prover: a mesh of devices in one process
(``mesh.py``), the active mesh (``context.py``) and the two-tier
(hosts × devices) collectives (``dcn.py``)."""
