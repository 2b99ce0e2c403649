"""Modular communicator layer (paper §IV-B) for stacked ranks: swappable
collective schedules behind one registry (``xla``, ``ring``, ``bruck``)."""

from .communicator import (Communicator, available_communicators,
                           get_communicator, register_communicator)
from .stacked import StackedCommunicator
from .ring import RingCommunicator
from .bruck import BruckCommunicator

__all__ = ["BruckCommunicator", "Communicator", "RingCommunicator",
           "StackedCommunicator", "available_communicators",
           "get_communicator", "register_communicator"]
