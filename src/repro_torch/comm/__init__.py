"""Modular communicator layer (paper §IV-B) for stacked ranks."""

from .communicator import Communicator
from .stacked import StackedCommunicator

__all__ = ["Communicator", "StackedCommunicator"]
