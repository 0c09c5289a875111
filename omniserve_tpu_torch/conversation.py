"""Conversation templates for chat-style prompting.

The port's own copy of ``omniserve_tpu/conversation.py`` (pure Python):
a fastchat-style registry and the model-path -> template mapping
(reference ``omniserve/conversation.py:12-26``), one structured formatter
per style. ``tests/test_torch_conversation.py`` holds every template and
mapping to the JAX package's exact strings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Conversation:
    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("user", "assistant")
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(
        default_factory=list
    )
    sep: str = "\n"
    sep2: Optional[str] = None
    stop_str: Optional[str] = None
    stop_token_ids: Optional[List[int]] = None
    style: str = "add_colon_single"

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))

    def set_system_message(self, message: str) -> None:
        self.system_message = message

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def update_last_message(self, message: str) -> None:
        self.messages[-1] = (self.messages[-1][0], message)

    def get_prompt(self) -> str:
        system = (
            self.system_template.format(system_message=self.system_message)
            if self.system_message
            else ""
        )
        if self.style == "llama2":
            ret = ""
            for i, (role, msg) in enumerate(self.messages):
                if role == self.roles[0]:
                    sys_part = f"<<SYS>>\n{self.system_message}\n<</SYS>>\n\n" \
                        if (i == 0 and self.system_message) else ""
                    ret += f"<s>[INST] {sys_part}{msg} [/INST]"
                elif msg is not None:
                    ret += f" {msg} </s>"
            return ret
        if self.style == "llama3":
            ret = "<|begin_of_text|>"
            if self.system_message:
                ret += (
                    "<|start_header_id|>system<|end_header_id|>\n\n"
                    f"{self.system_message}<|eot_id|>"
                )
            for role, msg in self.messages:
                ret += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                if msg is not None:
                    ret += f"{msg}<|eot_id|>"
            return ret
        if self.style == "mistral":
            ret = "<s>"
            for role, msg in self.messages:
                if role == self.roles[0]:
                    ret += f"[INST] {msg} [/INST]"
                elif msg is not None:
                    ret += f"{msg}</s>"
            return ret
        if self.style == "chatml":
            ret = (
                f"<|im_start|>system\n{self.system_message}<|im_end|>\n"
                if self.system_message
                else ""
            )
            for role, msg in self.messages:
                ret += f"<|im_start|>{role}\n"
                if msg is not None:
                    ret += f"{msg}<|im_end|>\n"
            return ret
        if self.style == "raw":
            # base (non-chat) models: message text verbatim, no role
            # wrapping — the colon format would wrap 64K-token contexts
            # in "user: ...\nassistant:" noise
            return "".join(
                msg for _, msg in self.messages if msg is not None
            )
        # add_colon_single (vicuna-style)
        ret = system + self.sep if system else ""
        for role, msg in self.messages:
            if msg is not None:
                ret += f"{role}: {msg}{self.sep}"
            else:
                ret += f"{role}:"
        return ret


_TEMPLATES: Dict[str, Conversation] = {}


def register_conv_template(template: Conversation) -> None:
    _TEMPLATES[template.name] = template


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


register_conv_template(Conversation(name="raw", style="raw"))
register_conv_template(
    Conversation(
        name="vicuna_v1.1",
        system_message=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
        roles=("USER", "ASSISTANT"),
        sep=" ",
        stop_str="</s>",
    )
)
register_conv_template(
    Conversation(
        name="llama-2",
        roles=("[INST]", "[/INST]"),
        style="llama2",
        stop_str="</s>",
    )
)
register_conv_template(
    Conversation(
        name="llama-3",
        roles=("user", "assistant"),
        style="llama3",
        stop_str="<|eot_id|>",
        stop_token_ids=[128001, 128009],
    )
)
register_conv_template(
    Conversation(
        name="mistral",
        roles=("user", "assistant"),
        style="mistral",
        stop_str="</s>",
    )
)
register_conv_template(
    Conversation(
        name="yi-chat",
        roles=("user", "assistant"),
        style="chatml",
        stop_str="<|im_end|>",
    )
)
register_conv_template(
    Conversation(
        name="qwen",
        roles=("user", "assistant"),
        style="chatml",
        stop_str="<|im_end|>",
    )
)


def get_conv_template_name(model_path: str) -> str:
    """Model path -> template name (reference conversation.py:12-26)."""
    p = model_path.lower()
    if "llama-3" in p or "llama3" in p:
        return "llama-3"
    if "llama-2" in p or "llama2" in p:
        return "llama-2"
    if "mistral" in p or "mixtral" in p:
        return "mistral"
    if "vicuna" in p:
        return "vicuna_v1.1"
    if "yi-" in p and "chat" in p:
        return "yi-chat"
    if "qwen" in p:
        return "qwen"
    return "raw"
