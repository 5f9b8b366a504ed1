"""Conversation prompt templates (the port's own copy of
``slime_tpu/conversation.py``).

Byte-identical prompt strings to the reference templates
(llava/conversation.py:9-428), so tokenization and label masking match
released checkpoints.
"""
from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()
    LLAMA_3 = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        st = self.sep_style
        if st == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
        elif st == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
        elif st == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
        elif st == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + self.sep2
            ret = ret.lstrip(self.sep)
        elif st == SeparatorStyle.LLAMA_3:
            ret = ""
            for i, (role, message) in enumerate(messages):
                hdr = f"<|start_header_id|>{self.roles[i % 2]}<|end_header_id|>\n\n"
                if i % 2 == 0:
                    ret += hdr + f"{message}<|eot_id|>"
                elif message is None:
                    ret += hdr
                else:
                    ret += hdr + f"{message}<|eot_id|>" + self.sep2
            if self.sep:
                ret = ret.lstrip(self.sep)
        elif st == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
        else:
            raise ValueError(f"Invalid style: {st}")
        return ret

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2, version=self.version)

    def dict(self) -> dict:
        return {"system": self.system, "roles": list(self.roles),
                "messages": [[r, m] for r, m in self.messages],
                "offset": self.offset, "sep": self.sep, "sep2": self.sep2}


def _conv(**kw) -> Conversation:
    kw.setdefault("messages", [])
    kw.setdefault("offset", 0)
    return Conversation(**kw)


conv_vicuna_v1 = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1",
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_vicuna_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"), sep_style=SeparatorStyle.SINGLE, sep="###")

conv_llama_2 = _conv(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"), version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_llava_llama_2 = _conv(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_llama_3 = _conv(
    system="", roles=("user", "assistant"), version="llama3",
    sep_style=SeparatorStyle.LLAMA_3, sep="", sep2="<|eot_conversation|>")

conv_mistral_instruct = _conv(
    system="", roles=("USER", "ASSISTANT"), version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2, sep="", sep2="</s>")

conv_mpt = _conv(
    system="<|im_start|>system\nA conversation between a user and an LLM-based AI "
           "assistant. The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), version="mpt",
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>")

conv_chatml_direct = _conv(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), version="mpt",
    sep_style=SeparatorStyle.MPT, sep="<|im_end|>")

conv_plain = _conv(
    system="", roles=("", ""), sep_style=SeparatorStyle.PLAIN, sep="\n")

conv_v0_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user "
           "provides, and assist the user with a variety of tasks using natural "
           "language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("Human", "Assistant"), sep_style=SeparatorStyle.SINGLE, sep="###",
    version="v0_mmtag")

conv_v1_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user "
           "provides, and assist the user with a variety of tasks using natural "
           "language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"), sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
    version="v1_mmtag")

default_conversation = conv_vicuna_v1

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "llama3": conv_llama_3,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,
    "plain": conv_plain,
    "v0_plain": conv_plain,
    "llava_v0": conv_vicuna_v0,
    "llava_v1": conv_vicuna_v1,
    "v0_mmtag": conv_v0_mmtag,
    "v1_mmtag": conv_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}


def conv_mode_from_model_name(model_name: str) -> str:
    """Infer the conversation template from a checkpoint name
    (reference: llava/serve/cli.py:34-45)."""
    name = model_name.lower()
    if "llama-3" in name or "llama3" in name or "llama_3" in name or "8b" in name:
        return "llama3"
    if "llama-2" in name:
        return "llava_llama_2"
    if "mistral" in name:
        return "mistral_instruct"
    if "v1.6-34b" in name:
        return "chatml_direct"
    if "v1" in name or "vicuna" in name or "7b" in name or "13b" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"
