"""Observer — callback interface for inbound messages.

Mirror of fedml_core/distributed/communication/observer.py:4-7.
"""

from __future__ import annotations

import abc


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg_params) -> None:
        ...
