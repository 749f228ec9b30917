"""The device-resident Fiat-Shamir transcript (``device.py``)."""
