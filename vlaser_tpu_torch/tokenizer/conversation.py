"""Conversation prompt templates: a copy of
vlaser_tpu/tokenizer/conversation.py (standard library only), so the port
builds the same chat prompts without importing the JAX package.

Parity surface: internvl/conversation.py -- the registry and the
chatml/MPT style used by every InternVL3/Vlaser template (roles end with
'\\n', turns joined by `sep`). Vlaser-2B/8B use 'internvl2_5'.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Conversation:
    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = "\n"
    sep2: Optional[str] = None
    sep_style: str = "mpt"  # 'mpt' (chatml family) | 'internvl_zh'
    stop_str: Optional[str] = None
    messages: List[Tuple[str, Optional[str]]] = field(default_factory=list)

    def get_prompt(self) -> str:
        if self.sep_style == "internvl_zh":
            # conversation.py:229-237: alternating seps, 'role: message'
            seps = [self.sep2, self.sep]
            ret = self.system_message + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        # MPT/chatml style: system + role-prefixed turns joined by sep
        ret = self.system_template.format(system_message=self.system_message)
        ret += self.sep
        for role, message in self.messages:
            if message is not None:
                ret += role + message + self.sep
            else:
                ret += role
        return ret

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append((role, message))

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name,
            system_template=self.system_template,
            system_message=self.system_message,
            roles=self.roles,
            sep=self.sep,
            sep2=self.sep2,
            sep_style=self.sep_style,
            stop_str=self.stop_str,
            messages=list(self.messages),
        )


_TEMPLATES = {}


def register_conv_template(conv: Conversation):
    _TEMPLATES[conv.name] = conv


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


_INTERNVL_SYSTEM = (
    "你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及多家合作单位"
    "联合开发的多模态大语言模型。"
)

register_conv_template(
    Conversation(
        name="internvl2_5",
        system_template="<|im_start|>system\n{system_message}",
        system_message=_INTERNVL_SYSTEM,
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep="<|im_end|>\n",
    )
)

register_conv_template(
    Conversation(
        name="Hermes-2",
        system_template="<|im_start|>system\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
            "是一个有用无害的人工智能助手。"
        ),
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep="<|im_end|>",
        stop_str="<|endoftext|>",
    )
)

register_conv_template(
    Conversation(
        name="internlm2-chat",
        system_template="<|im_start|>system\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
            "是一个有用无害的人工智能助手。"
        ),
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep="<|im_end|>",
    )
)

register_conv_template(
    Conversation(
        name="phi3-chat",
        system_template="<|system|>\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
            "是一个有用无害的人工智能助手。"
        ),
        roles=("<|user|>\n", "<|assistant|>\n"),
        sep="<|end|>",
    )
)

register_conv_template(
    Conversation(
        name="internvl_zh",
        system_template="",
        roles=("<human>", "<bot>"),
        sep_style="internvl_zh",
        sep="</s>",
        sep2=" ",
    )
)


IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
QUAD_START_TOKEN = "<quad>"
QUAD_END_TOKEN = "</quad>"
REF_START_TOKEN = "<ref>"
REF_END_TOKEN = "</ref>"
BOX_START_TOKEN = "<box>"
BOX_END_TOKEN = "</box>"

# 9 tokens added at SFT time (internvl_chat_finetune.py:871-875)
SPECIAL_TOKENS = [
    IMG_START_TOKEN,
    IMG_END_TOKEN,
    IMG_CONTEXT_TOKEN,
    QUAD_START_TOKEN,
    QUAD_END_TOKEN,
    REF_START_TOKEN,
    REF_END_TOKEN,
    BOX_START_TOKEN,
    BOX_END_TOKEN,
]


def build_chat_query(
    template_name: str,
    question: str,
    num_patches_list: List[int],
    num_image_token: int,
    history: Optional[List[Tuple[str, str]]] = None,
    system_message: Optional[str] = None,
) -> str:
    """Expand <image> placeholders and wrap the conversation
    (modeling_internvl_chat.py:343-376)."""
    if num_patches_list and "<image>" not in question and history is None:
        question = "<image>\n" + question
    template = get_conv_template(template_name)
    if system_message is not None:
        template.system_message = system_message
    for old_q, old_a in history or []:
        template.append_message(template.roles[0], old_q)
        template.append_message(template.roles[1], old_a)
    template.append_message(template.roles[0], question)
    template.append_message(template.roles[1], None)
    query = template.get_prompt()
    for num_patches in num_patches_list:
        image_tokens = (
            IMG_START_TOKEN
            + IMG_CONTEXT_TOKEN * num_image_token * num_patches
            + IMG_END_TOKEN
        )
        query = query.replace("<image>", image_tokens, 1)
    return query
