"""Chat template engine (the port's own copy of the torch-free, jax-free
infinitevl_tpu/data/template.py, held against it by the tests).

Minimal, tokenizer-agnostic re-design of the reference's template registry
(src/llamafactory/data/template.py:40-1575): a template renders a message
list into prompt/response strings with the family's control tokens, and
`encode_turns` produces (input_ids, labels) with non-assistant tokens masked
to IGNORE_INDEX. Registered families: qwen2_vl/qwen/chatml, llama3/llama2,
gemma, phi/phi4, mistral(+small), deepseek(+3), glm4, yi, zephyr, vicuna,
alpaca, baichuan2, default/fewshot/empty; the registry is open for more.

Tool calling follows the Qwen 2.5 convention the reference implements in
data/tool_utils.py (QwenToolUtils): tool signatures go into the system turn
inside <tools></tools>, assistant function calls render as
<tool_call>{json}</tool_call>, and tool results come back as a "tool" role
wrapped in <tool_response></tool_response>.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

IGNORE_INDEX = -100

# QWEN_TOOL_PROMPT / function format (reference tool_utils.py:52-57, 270-292)
TOOL_PROMPT = (
    "\n\n# Tools\n\nYou may call one or more functions to assist with the "
    "user query.\n\nYou are provided with function signatures within "
    "<tools></tools> XML tags:\n<tools>{tool_text}\n</tools>\n\nFor each "
    "function call, return a json object with function name and arguments "
    'within <tool_call></tool_call> XML tags:\n<tool_call>\n{{"name": '
    '<function-name>, "arguments": <args-json-object>}}\n</tool_call>'
)


def format_tools(tools: Sequence[Dict[str, Any]]) -> str:
    """System-prompt tool block (QwenToolUtils.tool_formatter)."""
    tool_text = "".join(
        "\n" + json.dumps({"type": "function", "function": t}, ensure_ascii=False)
        for t in tools
    )
    return TOOL_PROMPT.format(tool_text=tool_text)


def format_function_calls(calls: Sequence[Dict[str, Any]]) -> str:
    """Assistant-side rendering of function calls
    (QwenToolUtils.function_formatter)."""
    parts = []
    for c in calls:
        args = c.get("arguments", {})
        if not isinstance(args, str):
            args = json.dumps(args, ensure_ascii=False)
        parts.append(
            "<tool_call>\n"
            + json.dumps({"name": c["name"], "arguments": json.loads(args)},
                         ensure_ascii=False)
            + "\n</tool_call>"
        )
    return "\n".join(parts)


_TOOL_CALL_RE = re.compile(
    r"<tool_call>(.+?)</tool_call>(?=\s*<tool_call>|\s*$)", re.DOTALL
)


def extract_tool_calls(content: str):
    """Parse <tool_call> blocks out of a generated completion
    (QwenToolUtils.tool_extractor). Returns the raw string when no valid
    calls are present, else a list of {"name", "arguments"} dicts."""
    matches = _TOOL_CALL_RE.findall(content)
    if not matches:
        return content
    out = []
    for m in matches:
        try:
            d = json.loads(m.strip())
        except json.JSONDecodeError:
            return content
        if "name" not in d:
            return content
        out.append({"name": d["name"], "arguments": d.get("arguments", {})})
    return out


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    system_prefix: str  # format with {content}
    user_prefix: str
    assistant_prefix: str
    turn_suffix: str
    default_system: str = ""
    stop_words: Tuple[str, ...] = ()
    # emitted once before the first turn (reference format_prefix, e.g.
    # llama3's <|begin_of_text|>)
    prefix: str = ""
    # per-role suffix overrides; None falls back to turn_suffix. Needed for
    # the reference's slot-based templates where e.g. gemma's system turn
    # ends in "\n\n" but its chat turns end in "<end_of_turn>\n".
    system_suffix: Optional[str] = None
    user_suffix: Optional[str] = None
    # Llama2Template semantics (reference template.py:365-395): the system
    # text renders INSIDE the first user turn (prepended to its content)
    # instead of as its own turn.
    system_inline: bool = False

    def _suffix(self, role: str) -> str:
        if role == "system" and self.system_suffix is not None:
            return self.system_suffix
        if role == "user" and self.user_suffix is not None:
            return self.user_suffix
        return self.turn_suffix

    def _prepare(
        self,
        messages: Sequence[Dict[str, Any]],
        tools: Optional[Sequence[Dict[str, Any]]] = None,
    ) -> List[Dict[str, str]]:
        """Normalize roles and inject tools: tool signatures append to the
        system turn (reference ToolFormatter placement); "tool"/"observation"
        turns wrap in <tool_response> as a user-side turn (reference qwen
        format_observation, template.py:1349-1351); assistant messages with
        `tool_calls` render them as <tool_call> blocks."""
        msgs: List[Dict[str, str]] = []
        has_system = any(m["role"] == "system" for m in messages)
        if not has_system and (self.default_system or tools):
            msgs.append({"role": "system", "content": self.default_system})
        for m in messages:
            role, content = m["role"], m.get("content", "")
            if role in ("tool", "observation", "function"):
                msgs.append(
                    {
                        "role": "user",
                        "content": f"<tool_response>\n{content}\n</tool_response>",
                    }
                )
                continue
            if role == "assistant" and m.get("tool_calls"):
                rendered = format_function_calls(
                    [
                        c.get("function", c)
                        for c in m["tool_calls"]
                    ]
                )
                content = (content + "\n" + rendered).strip()
            msgs.append({"role": role, "content": content})
        if tools:
            msgs[0] = {
                "role": "system",
                "content": msgs[0]["content"] + format_tools(tools),
            }
        if self.system_inline and msgs and msgs[0]["role"] == "system":
            sys_text = self.system_prefix.format(content=msgs[0]["content"])
            msgs = msgs[1:]
            for m in msgs:
                if m["role"] == "user":
                    m["content"] = sys_text + m["content"]
                    break
        return msgs

    def render_prompt(
        self,
        messages: Sequence[Dict[str, Any]],
        add_generation_prompt: bool = True,
        tools: Optional[Sequence[Dict[str, Any]]] = None,
    ) -> str:
        """messages: [{role: system|user|assistant|tool, content: str}, ...]."""
        out = [self.prefix] if self.prefix else []
        user_idx = 0
        for m in self._prepare(messages, tools):
            role, content = m["role"], m["content"]
            if role == "system":
                out.append(self.system_prefix.format(content=content, idx=0))
            elif role == "user":
                # {idx} = 0-based user-turn ordinal (the reference's chatglm2
                # "[Round {{idx}}]" slot; template.py:138 passes idx=i//2
                # over the user/assistant alternation, so the first user
                # turn renders Round 0)
                out.append(
                    self.user_prefix.format(content=content, idx=user_idx)
                )
                user_idx += 1
            elif role == "assistant":
                out.append(self.assistant_prefix + content)
            else:
                raise ValueError(f"unknown role {role!r}")
            out.append(self._suffix(role))
        if add_generation_prompt:
            out.append(self.assistant_prefix)
        return "".join(out)

    def encode_turns(
        self,
        tokenizer,
        messages: Sequence[Dict[str, Any]],
        tools: Optional[Sequence[Dict[str, Any]]] = None,
    ) -> Tuple[List[int], List[int]]:
        """(input_ids, labels): labels = ids on assistant contents (+ the
        turn suffix), IGNORE_INDEX elsewhere — supervised SFT encoding
        (data/processor/supervised.py semantics). Tool responses encode as
        unsupervised user-side turns; assistant tool_calls are supervised."""
        ids: List[int] = []
        labels: List[int] = []
        if self.prefix:
            t = tokenizer.encode(self.prefix, add_special_tokens=False)
            ids += t
            labels += [IGNORE_INDEX] * len(t)
        user_idx = 0
        for m in self._prepare(messages, tools):
            role, content = m["role"], m["content"]
            if role == "assistant":
                prefix = tokenizer.encode(self.assistant_prefix, add_special_tokens=False)
                body = tokenizer.encode(content + self.turn_suffix, add_special_tokens=False)
                ids += prefix + body
                labels += [IGNORE_INDEX] * len(prefix) + body
            else:
                fmt = self.system_prefix if role == "system" else self.user_prefix
                seg = fmt.format(content=content, idx=user_idx) + self._suffix(role)
                if role == "user":
                    user_idx += 1
                t = tokenizer.encode(seg, add_special_tokens=False)
                ids += t
                labels += [IGNORE_INDEX] * len(t)
        return ids, labels


def get_ollama_modelfile(
    template: "Template", num_ctx: int = 4096
) -> str:
    """Ollama Modelfile for this chat template (reference
    template.py:292-307 get_ollama_modelfile): a go-template over .System /
    .Messages plus stop words. Written next to an exported checkpoint so
    `ollama create` can serve it."""
    t = template
    go = (
        "{{ if .System }}"
        + t.system_prefix.format(content="{{ .System }}", idx=0)
        + t.turn_suffix
        + "{{ end }}"
        + "{{ range .Messages }}{{ if eq .Role \"user\" }}"
        + t.user_prefix.format(content="{{ .Content }}", idx=0)
        + t.turn_suffix
        + "{{ else if eq .Role \"assistant\" }}"
        + t.assistant_prefix
        + "{{ .Content }}"
        + t.turn_suffix
        + "{{ end }}{{ end }}"
        + t.assistant_prefix
    )
    out = "# ollama modelfile auto-generated by infinitevl_tpu\n\n"
    out += f'FROM .\n\nTEMPLATE """{go}"""\n\n'
    if t.default_system:
        out += f'SYSTEM """{t.default_system}"""\n\n'
    for stop in t.stop_words:
        out += f'PARAMETER stop "{stop}"\n'
    out += f"PARAMETER num_ctx {num_ctx}\n"
    return out


_TEMPLATES: Dict[str, Template] = {}


def register_template(t: Template) -> None:
    _TEMPLATES[t.name] = t


def get_template(name: str) -> Template:
    if name not in _TEMPLATES:
        raise KeyError(
            f"unknown template {name!r}; available: {sorted(_TEMPLATES)}"
        )
    return _TEMPLATES[name]


def register_custom_template(
    spec: Mapping[str, Any], name: str = "custom"
) -> Template:
    """User-defined chat template from a yaml dict (the reference's
    `register_template(name="custom", ...)` hook, template.py:396-414 —
    there users edit source; here `custom_template:` in the run yaml maps
    straight onto Template's slot fields and `template: custom` selects it).

    Recognized keys = Template's fields except `name` (system_prefix,
    user_prefix, assistant_prefix, turn_suffix, default_system, stop_words,
    prefix, system_suffix, user_suffix, system_inline). Prefix strings use
    `{content}` for the message body. Unknown keys raise."""
    allowed = {f.name for f in dataclasses.fields(Template)} - {"name"}
    unknown = set(spec) - allowed
    if unknown:
        raise ValueError(
            f"unknown custom_template keys {sorted(unknown)}; "
            f"allowed: {sorted(allowed)}"
        )
    kwargs = dict(spec)
    if "stop_words" in kwargs:
        kwargs["stop_words"] = tuple(kwargs["stop_words"])
    t = Template(name=name, **kwargs)
    register_template(t)
    return t


register_template(
    Template(
        name="qwen2_vl",
        system_prefix="<|im_start|>system\n{content}<|im_end|>",
        user_prefix="<|im_start|>user\n{content}<|im_end|>",
        assistant_prefix="\n<|im_start|>assistant\n",
        turn_suffix="\n",
        default_system="You are a helpful assistant.",
        stop_words=("<|im_end|>",),
    )
)

register_template(
    Template(
        name="chatml",
        system_prefix="<|im_start|>system\n{content}<|im_end|>",
        user_prefix="<|im_start|>user\n{content}<|im_end|>",
        assistant_prefix="\n<|im_start|>assistant\n",
        turn_suffix="\n",
        stop_words=("<|im_end|>",),
    )
)

register_template(
    Template(
        name="empty",
        system_prefix="{content}",
        user_prefix="{content}",
        assistant_prefix="",
        turn_suffix="",
    )
)

# text-only qwen (reference template.py "qwen": identical chatml control
# tokens, same default system as qwen2_vl)
register_template(
    Template(
        name="qwen",
        system_prefix="<|im_start|>system\n{content}<|im_end|>",
        user_prefix="<|im_start|>user\n{content}<|im_end|>",
        assistant_prefix="\n<|im_start|>assistant\n",
        turn_suffix="\n",
        default_system="You are a helpful assistant.",
        stop_words=("<|im_end|>",),
    )
)

# llama3 family (reference template.py "llama3": header tokens per turn,
# <|eot_id|> terminator, <|begin_of_text|> prompt prefix)
register_template(
    Template(
        name="llama3",
        system_prefix="<|start_header_id|>system<|end_header_id|>\n\n{content}",
        user_prefix="<|start_header_id|>user<|end_header_id|>\n\n{content}",
        assistant_prefix="<|start_header_id|>assistant<|end_header_id|>\n\n",
        turn_suffix="<|eot_id|>",
        stop_words=("<|eot_id|>",),
        prefix="<|begin_of_text|>",
    )
)

# ---------------------------------------------------------------------------
# High-traffic template registrations mirroring the reference's registry
# (src/llamafactory/data/template.py, cited per entry). Token-literal slots
# are the models' published chat formats (unavoidable-similarity category).
# BOS/EOS literals are written as the models' published token strings; the
# tokenizer maps them to the special ids.
# ---------------------------------------------------------------------------

# reference template.py:819 (gemma/gemma2; :834 gemma3 is a copy)
for _name in ("gemma", "gemma3"):
    register_template(
        Template(
            name=_name,
            system_prefix="{content}",
            system_suffix="\n\n",
            user_prefix="<start_of_turn>user\n{content}",
            user_suffix="<end_of_turn>\n",
            assistant_prefix="<start_of_turn>model\n",
            turn_suffix="<end_of_turn>\n",
            prefix="<bos>",
            stop_words=("<end_of_turn>",),
        )
    )

# reference template.py:1299 (phi-3)
register_template(
    Template(
        name="phi",
        system_prefix="<|system|>\n{content}",
        user_prefix="<|user|>\n{content}",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="<|end|>\n",
        stop_words=("<|end|>",),
    )
)

# reference template.py:1318 (phi-4)
register_template(
    Template(
        name="phi4",
        system_prefix="<|im_start|>system<|im_sep|>{content}",
        user_prefix="<|im_start|>user<|im_sep|>{content}",
        assistant_prefix="<|im_start|>assistant<|im_sep|>",
        turn_suffix="<|im_end|>",
        stop_words=("<|im_end|>",),
    )
)

# reference template.py:1202 (mistral v3+, Llama2Template: system inlines
# into the first user turn)
register_template(
    Template(
        name="mistral",
        system_prefix="{content}\n\n",
        system_inline=True,
        user_prefix="[INST] {content}[/INST]",
        user_suffix="",
        assistant_prefix=" ",
        turn_suffix="</s>",
        prefix="<s>",
    )
)

# reference template.py:1216 (mistral_small / ministral tekken v7)
register_template(
    Template(
        name="mistral_small",
        system_prefix="[SYSTEM_PROMPT]{content}[/SYSTEM_PROMPT]",
        system_suffix="",
        user_prefix="[INST]{content}[/INST]",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="</s>",
        prefix="<s>",
    )
)

# reference template.py:927/:936 (llama2 family, system inside first [INST])
for _name, _sys in (
    ("llama2", ""),
    ("llama2_zh", "You are a helpful assistant. 你是一个乐于助人的助手。"),
):
    register_template(
        Template(
            name=_name,
            system_prefix="<<SYS>>\n{content}\n<</SYS>>\n\n",
            system_inline=True,
            user_prefix="<s>[INST] {content} [/INST]",
            user_suffix="",
            assistant_prefix=" ",
            turn_suffix="</s>",
            default_system=_sys,
        )
    )

# reference template.py:750 / :758
register_template(
    Template(
        name="deepseek",
        system_prefix="{content}",
        system_suffix="\n\n",
        user_prefix="User: {content}",
        user_suffix="\n\n",
        assistant_prefix="Assistant:",
        turn_suffix="<｜end▁of▁sentence｜>",
        prefix="<｜begin▁of▁sentence｜>",
    )
)
register_template(
    Template(
        name="deepseek3",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<｜User｜>{content}",
        user_suffix="",
        assistant_prefix="<｜Assistant｜>",
        turn_suffix="<｜end▁of▁sentence｜>",
        prefix="<｜begin▁of▁sentence｜>",
    )
)

# reference template.py:849 (glm4; efficient_eos — no eos between turns)
register_template(
    Template(
        name="glm4",
        system_prefix="<|system|>\n{content}",
        system_suffix="",
        user_prefix="<|user|>\n{content}",
        user_suffix="",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="",
        prefix="[gMASK]<sop>",
        stop_words=("<|user|>", "<|observation|>"),
    )
)

# reference template.py:1530 (yi: chatml control tokens, no default system)
register_template(
    Template(
        name="yi",
        system_prefix="<|im_start|>system\n{content}<|im_end|>",
        user_prefix="<|im_start|>user\n{content}<|im_end|>",
        assistant_prefix="\n<|im_start|>assistant\n",
        turn_suffix="\n",
        stop_words=("<|im_end|>",),
    )
)

# reference template.py:1564 (zephyr)
register_template(
    Template(
        name="zephyr",
        system_prefix="<|system|>\n{content}</s>",
        system_suffix="",
        user_prefix="<|user|>\n{content}</s>",
        user_suffix="",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="</s>",
        default_system="You are Zephyr, a helpful assistant.",
    )
)

# reference template.py:1470 (vicuna)
register_template(
    Template(
        name="vicuna",
        system_prefix="{content} ",
        system_suffix="",
        user_prefix="USER: {content} ",
        user_suffix="",
        assistant_prefix="ASSISTANT:",
        turn_suffix="</s>",
        default_system=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
    )
)

# reference template.py:539 (alpaca)
register_template(
    Template(
        name="alpaca",
        system_prefix="{content}",
        system_suffix="\n\n",
        user_prefix="### Instruction:\n{content}\n\n",
        user_suffix="",
        assistant_prefix="### Response:\n",
        turn_suffix="\n\n",
        default_system=(
            "Below is an instruction that describes a task. Write a response "
            "that appropriately completes the request.\n\n"
        ),
    )
)

# reference template.py:779 (default)
register_template(
    Template(
        name="default",
        system_prefix="System: {content}",
        user_prefix="Human: {content}",
        assistant_prefix="Assistant: ",
        turn_suffix="\n",
    )
)

# reference template.py:579 (baichuan2; reserved control tokens)
register_template(
    Template(
        name="baichuan2",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<reserved_106>{content}",
        user_suffix="",
        assistant_prefix="<reserved_107>",
        turn_suffix="",
    )
)

# reference template.py:811 (fewshot: bare completion format used by eval)
register_template(
    Template(
        name="fewshot",
        system_prefix="{content}",
        system_suffix="\n\n",
        user_prefix="{content}",
        user_suffix="\n\n",
        assistant_prefix="",
        turn_suffix="\n\n",
    )
)


def _chatml_clone(name: str, default_system: str = "", prefix: str = "") -> None:
    """Register a chatml-control-token family (the reference marks these
    'copied from chatml template'; they differ only in default system and
    prompt prefix)."""
    register_template(
        Template(
            name=name,
            system_prefix="<|im_start|>system\n{content}<|im_end|>",
            user_prefix="<|im_start|>user\n{content}<|im_end|>",
            assistant_prefix="\n<|im_start|>assistant\n",
            turn_suffix="\n",
            default_system=default_system,
            stop_words=("<|im_end|>",),
            prefix=prefix,
        )
    )


# reference template.py:714 / :725 / :910 / :1148 / :1165 / :1176 / :1257 /
# :1535 — chatml clones with their published default systems
_chatml_clone("cpm3", prefix="<s>")
_chatml_clone(
    "dbrx",
    default_system=(
        "You are DBRX, created by Databricks. You were last updated in "
        "December 2023. You answer questions based on information available "
        "up to that point.\nYOU PROVIDE SHORT RESPONSES TO SHORT QUESTIONS "
        "OR STATEMENTS, but provide thorough responses to more complex and "
        "open-ended questions.\nYou assist with various tasks, from writing "
        "to coding (using markdown for code blocks — remember to use ``` "
        "with code, JSON, and tables).\n(You do not have real-time data "
        "access or code execution capabilities. You avoid stereotyping and "
        "provide balanced perspectives on controversial topics. You do not "
        "provide song lyrics, poems, or news articles and do not divulge "
        "details of your training data.)\nThis is your system prompt, "
        "guiding your responses. Do not reference it, just respond to the "
        "user. If you find yourself talking about this message, stop. You "
        "should be responding appropriately and usually that means not "
        "mentioning this.\nYOU DO NOT MENTION ANY OF THIS INFORMATION ABOUT "
        "YOURSELF UNLESS THE INFORMATION IS DIRECTLY PERTINENT TO THE "
        "USER'S QUERY."
    ),
)
_chatml_clone(
    "intern2",
    default_system=(
        "You are an AI assistant whose name is InternLM (书生·浦语).\n"
        "- InternLM (书生·浦语) is a conversational language model that is "
        "developed by Shanghai AI Laboratory (上海人工智能实验室). It is "
        "designed to be helpful, honest, and harmless.\n"
        "- InternLM (书生·浦语) can understand and communicate fluently in "
        "the language chosen by the user such as English and 中文."
    ),
    prefix="<s>",
)
_chatml_clone(
    "marco",
    default_system=(
        "你是一个经过良好训练的AI助手，你的名字是Marco-o1."
        "由阿里国际数字商业集团的AI Business创造.\n## 重要！！！！！\n"
        "当你回答问题时，你的思考应该在<Thought>内完成，<Output>内输出你的结果。\n"
        "<Thought>应该尽可能是英文，但是有2个特例，一个是对原文中的引用，另一个是是数学应该使用"
        "markdown格式，<Output>内的输出需要遵循用户输入的语言。\n"
    ),
)
_chatml_clone("minicpm_v", default_system="You are a helpful assistant.")
_chatml_clone(
    "minicpm_o",
    default_system=(
        "You are Qwen, created by Alibaba Cloud. You are a helpful assistant."
    ),
)
_chatml_clone(
    "opencoder", default_system="You are OpenCoder, created by OpenCoder Team."
)

# reference template.py:550 (aquila)
register_template(
    Template(
        name="aquila",
        system_prefix="System: {content}",
        user_prefix="Human: {content}",
        user_suffix="###",
        assistant_prefix="Assistant:",
        turn_suffix="###",
        default_system=(
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."
        ),
        stop_words=("</s>",),
    )
)

# reference template.py:563 (atom; llama-style bos/eos literals)
register_template(
    Template(
        name="atom",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<s>Human: {content}\n</s>",
        user_suffix="",
        assistant_prefix="<s>Assistant:",
        turn_suffix="\n</s>",
    )
)

# reference template.py:578 (baichuan v1; reserved control tokens,
# efficient_eos)
register_template(
    Template(
        name="baichuan",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<reserved_102>{content}",
        user_suffix="",
        assistant_prefix="<reserved_103>",
        turn_suffix="",
    )
)

# reference template.py:585 (bailing)
register_template(
    Template(
        name="bailing",
        system_prefix="<role>SYSTEM</role>{content}",
        system_suffix="",
        user_prefix="<role>HUMAN</role>{content}",
        user_suffix="",
        assistant_prefix="<role>ASSISTANT</role>",
        turn_suffix="",
        stop_words=("<|endoftext|>",),
    )
)

# reference template.py:596 (belle; llama bos/eos literals)
register_template(
    Template(
        name="belle",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="Human: {content}\n\nBelle: ",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="</s>\n\n",
        prefix="<s>",
    )
)

# reference template.py:604 (bluelm)
register_template(
    Template(
        name="bluelm",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="[|Human|]:{content}",
        user_suffix="",
        assistant_prefix="[|AI|]:",
        turn_suffix="</s>",
    )
)

# reference template.py:610 (breeze; efficient_eos)
register_template(
    Template(
        name="breeze",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="[INST] {content} [/INST] ",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="",
        prefix="<s>",
    )
)

# reference template.py:626 (chatglm3; efficient_eos)
register_template(
    Template(
        name="chatglm3",
        system_prefix="<|system|>\n{content}",
        system_suffix="",
        user_prefix="<|user|>\n{content}",
        user_suffix="",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="",
        prefix="[gMASK]sop",
        stop_words=("<|user|>", "<|observation|>"),
    )
)

# reference template.py:674 (codegeex4: glm4 control flow + CodeGeeX system)
register_template(
    Template(
        name="codegeex4",
        system_prefix="<|system|>\n{content}",
        system_suffix="",
        user_prefix="<|user|>\n{content}",
        user_suffix="",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="",
        prefix="[gMASK]<sop>",
        default_system=(
            "你是一位智能编程助手，你叫CodeGeeX。你会为用户回答关于编程、代码、计算机方面的任何问题，"
            "并提供格式规范、可以执行、准确安全的代码，并在必要时提供详细的解释。"
        ),
        stop_words=("<|user|>", "<|observation|>"),
    )
)

# reference template.py:691 (cohere command-r)
register_template(
    Template(
        name="cohere",
        system_prefix=(
            "<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{content}"
            "<|END_OF_TURN_TOKEN|>"
        ),
        system_suffix="",
        user_prefix=(
            "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{content}"
            "<|END_OF_TURN_TOKEN|>"
        ),
        user_suffix="",
        assistant_prefix="<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",
        turn_suffix="<|END_OF_TURN_TOKEN|>",
        prefix="<BOS_TOKEN>",
    )
)

# reference template.py:706 (cpm / minicpm)
register_template(
    Template(
        name="cpm",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<用户>{content}",
        user_suffix="",
        assistant_prefix="<AI>",
        turn_suffix="</s>",
        prefix="<s>",
    )
)

# reference template.py:765 (deepseekcoder)
register_template(
    Template(
        name="deepseekcoder",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="### Instruction:\n{content}\n### Response:",
        user_suffix="",
        assistant_prefix="\n",
        turn_suffix="\n<|EOT|>\n",
        prefix="<｜begin▁of▁sentence｜>",
        default_system=(
            "You are an AI programming assistant, utilizing the DeepSeek "
            "Coder model, developed by DeepSeek Company, and you only answer "
            "questions related to computer science. For politically "
            "sensitive questions, security and privacy issues, and other "
            "non-computer science questions, you will refuse to answer.\n"
        ),
    )
)

# reference template.py:795 (exaone)
register_template(
    Template(
        name="exaone",
        system_prefix="[|system|]{content}[|endofturn|]",
        system_suffix="\n",
        user_prefix="[|user|]{content}",
        user_suffix="\n",
        assistant_prefix="[|assistant|]",
        turn_suffix="[|endofturn|]\n",
    )
)

# reference template.py:803 (falcon; efficient_eos)
register_template(
    Template(
        name="falcon",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="User: {content}\n",
        user_suffix="",
        assistant_prefix="Falcon:",
        turn_suffix="\n",
    )
)

# reference template.py:863 (granite3)
register_template(
    Template(
        name="granite3",
        system_prefix=(
            "<|start_of_role|>system<|end_of_role|>{content}<|end_of_text|>"
        ),
        system_suffix="\n",
        user_prefix=(
            "<|start_of_role|>user<|end_of_role|>{content}<|end_of_text|>"
        ),
        user_suffix="\n",
        assistant_prefix="<|start_of_role|>assistant<|end_of_role|>",
        turn_suffix="<|end_of_text|>\n",
    )
)

# reference template.py:875 (index; efficient_eos)
register_template(
    Template(
        name="index",
        system_prefix="<unk>{content}",
        system_suffix="",
        user_prefix="reserved_0{content}",
        user_suffix="",
        assistant_prefix="reserved_1",
        turn_suffix="",
    )
)

# reference template.py:883 (hunyuan)
register_template(
    Template(
        name="hunyuan",
        system_prefix="<|bos|>system\n{content}<|eos|>",
        system_suffix="\n",
        user_prefix="<|bos|>user\n{content}<|eos|>",
        user_suffix="\n",
        assistant_prefix="<|bos|>assistant\n",
        turn_suffix="<|eos|>\n",
        prefix="<|bos|>",
        stop_words=("<|eos|>",),
    )
)

_INTERN_SYSTEM = (
    "You are an AI assistant whose name is InternLM (书生·浦语).\n"
    "- InternLM (书生·浦语) is a conversational language model that is "
    "developed by Shanghai AI Laboratory (上海人工智能实验室). It is designed "
    "to be helpful, honest, and harmless.\n"
    "- InternLM (书生·浦语) can understand and communicate fluently in the "
    "language chosen by the user such as English and 中文."
)

# reference template.py:896 (intern v1)
register_template(
    Template(
        name="intern",
        system_prefix="<|System|>:{content}",
        system_suffix="\n",
        user_prefix="<|User|>:{content}",
        user_suffix="\n",
        assistant_prefix="<|Bot|>:",
        turn_suffix="<eoa>\n",
        prefix="<s>",
        default_system=_INTERN_SYSTEM,
        stop_words=("<eoa>",),
    )
)

# reference template.py:1001 (moonlight)
register_template(
    Template(
        name="moonlight",
        system_prefix="<|im_system|>system<|im_middle|>{content}<|im_end|>",
        system_suffix="",
        user_prefix="<|im_user|>user<|im_middle|>{content}<|im_end|>",
        user_suffix="",
        assistant_prefix="<|im_assistant|>assistant<|im_middle|>",
        turn_suffix="<|im_end|>",
        default_system="You are a helpful assistant provided by Moonshot-AI.",
        stop_words=("<|im_end|>",),
    )
)

_VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions."
)

# reference template.py:1014 / :1026 (llava / llava_next: vicuna chat format;
# the image token is handled by the processor layer, not the template)
for _name in ("llava", "llava_next"):
    register_template(
        Template(
            name=_name,
            system_prefix="{content} ",
            system_suffix="",
            user_prefix="USER: {content} ",
            user_suffix="",
            assistant_prefix="ASSISTANT:",
            turn_suffix="</s>",
            default_system=_VICUNA_SYSTEM,
        )
    )

# reference template.py:1227 (olmo; eos-token prompt prefix)
register_template(
    Template(
        name="olmo",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<|user|>\n{content}",
        user_suffix="",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="<|endoftext|>",
        prefix="<|endoftext|>",
    )
)

# reference template.py:1234 (openchat)
register_template(
    Template(
        name="openchat",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="GPT4 Correct User: {content}<|end_of_turn|>",
        user_suffix="",
        assistant_prefix="GPT4 Correct Assistant:",
        turn_suffix="<|end_of_turn|>",
        prefix="<s>",
    )
)

# reference template.py:1268 (orion; the published format emits eos after
# 'Assistant: ' before the reply)
register_template(
    Template(
        name="orion",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="Human: {content}\n\nAssistant: </s>",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="</s>",
        prefix="<s>",
    )
)

# reference template.py:1388 (sailor: chatml tokens with question/answer
# role names)
register_template(
    Template(
        name="sailor",
        system_prefix="<|im_start|>system\n{content}<|im_end|>",
        user_prefix="<|im_start|>question\n{content}<|im_end|>",
        assistant_prefix="\n<|im_start|>answer\n",
        turn_suffix="\n",
        default_system=(
            "You are an AI assistant named Sailor created by Sea AI Lab. "
            "Your answer should be friendly, unbiased, faithful, informative "
            "and detailed."
        ),
        stop_words=("<|im_end|>",),
    )
)

# reference template.py:1402 (skywork_o1: llama3 control flow + system)
register_template(
    Template(
        name="skywork_o1",
        system_prefix="<|start_header_id|>system<|end_header_id|>\n\n{content}",
        user_prefix="<|start_header_id|>user<|end_header_id|>\n\n{content}",
        assistant_prefix="<|start_header_id|>assistant<|end_header_id|>\n\n",
        turn_suffix="<|eot_id|>",
        prefix="<|begin_of_text|>",
        default_system=(
            "You are Skywork-o1, a thinking model developed by Skywork AI, "
            "specializing in solving complex problems involving mathematics, "
            "coding, and logical reasoning through deep thought. When faced "
            "with a user's request, you first engage in a lengthy and "
            "in-depth thinking process to explore possible solutions to the "
            "problem. After completing your thoughts, you then provide a "
            "detailed explanation of the solution process in your response."
        ),
        stop_words=("<|eot_id|>", "<|eom_id|>"),
    )
)

# reference template.py:1436 (solar; efficient_eos)
register_template(
    Template(
        name="solar",
        system_prefix="### System:\n{content}\n\n",
        system_suffix="",
        user_prefix="### User:\n{content}\n\n",
        user_suffix="",
        assistant_prefix="### Assistant:\n",
        turn_suffix="",
    )
)

# reference template.py:1444 (starchat)
register_template(
    Template(
        name="starchat",
        system_prefix="<|system|>\n{content}<|end|>",
        system_suffix="\n",
        user_prefix="<|user|>\n{content}<|end|>",
        user_suffix="\n",
        assistant_prefix="<|assistant|>",
        turn_suffix="<|end|>\n",
        stop_words=("<|end|>",),
    )
)

# reference template.py:1453 / :1459 (telechat / telechat2)
register_template(
    Template(
        name="telechat",
        system_prefix="<_system>{content}<_end>",
        system_suffix="",
        user_prefix="<_user>{content}",
        user_suffix="",
        assistant_prefix="<_bot>",
        turn_suffix="<_end>",
    )
)
register_template(
    Template(
        name="telechat2",
        system_prefix="<_system>{content}",
        system_suffix="",
        user_prefix="<_user>{content}",
        user_suffix="",
        assistant_prefix="<_bot>",
        turn_suffix="<_end>",
        default_system=(
            "你是中国电信星辰语义大模型，英文名是TeleChat，你是由中电信人工智能科技有限公司和"
            "中国电信人工智能研究院（TeleAI）研发的人工智能助手。"
        ),
    )
)

# reference template.py:1503 (xverse)
register_template(
    Template(
        name="xverse",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="Human: {content}\n\nAssistant: ",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="</s>",
    )
)

# reference template.py:1509 (yayi)
register_template(
    Template(
        name="yayi",
        system_prefix="<|System|>:\n{content}",
        system_suffix="\n\n",
        user_prefix="<|Human|>:\n{content}",
        user_suffix="\n\n",
        assistant_prefix="<|YaYi|>:",
        turn_suffix="\n\n",
        default_system=(
            "You are a helpful, respectful and honest assistant named YaYi "
            "developed by Beijing Wenge Technology Co.,Ltd. Always answer as "
            "helpfully as possible, while being safe.  Your answers should "
            "not include any harmful, unethical, racist, sexist, toxic, "
            "dangerous, or illegal content. Please ensure that your "
            "responses are socially unbiased and positive in nature.\n\nIf a "
            "question does not make any sense, or is not factually coherent, "
            "explain why instead of answering something not correct. If you "
            "don't know the answer to a question, please don't share false "
            "information."
        ),
        stop_words=("<|End|>",),
    )
)

# reference template.py:1541 (yi_vl; efficient_eos)
register_template(
    Template(
        name="yi_vl",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="### Human: {content}\n",
        user_suffix="",
        assistant_prefix="### Assistant:",
        turn_suffix="\n",
        default_system=(
            "This is a chat between an inquisitive human and an AI "
            "assistant. Assume the role of the AI assistant. Read all the "
            "images carefully, and respond to the human's questions with "
            "informative, helpful, detailed and polite answers. "
            "这是一个好奇的人类和一个人工智能助手之间的对话。假设你扮演这个AI助手的角色。"
            "仔细阅读所有的图像，并对人类的问题做出信息丰富、有帮助、详细的和礼貌的回答。\n\n"
        ),
        stop_words=("###",),
    )
)

# reference template.py:1556 (yuan)
register_template(
    Template(
        name="yuan",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="{content}<sep>",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="<eod>\n",
        stop_words=("<eod>",),
    )
)

# reference template.py:1572 (ziya)
register_template(
    Template(
        name="ziya",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="<human>:{content}\n",
        user_suffix="",
        assistant_prefix="<bot>:",
        turn_suffix="\n",
    )
)

# --- closing-the-registry batch: every remaining reference registration ---

# reference template.py:660 (chatml_de: chatml + German default system)
_chatml_clone(
    "chatml_de",
    default_system="Du bist ein freundlicher und hilfsbereiter KI-Assistent.",
)

# reference template.py:669 (codegeex2: prefix-only completion format)
register_template(
    Template(
        name="codegeex2",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="{content}",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="",
        prefix="[gMASK]sop",
    )
)

# reference template.py:618 (chatglm2: numbered rounds via the {idx} slot)
register_template(
    Template(
        name="chatglm2",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="[Round {idx}]\n\n问：{content}\n\n答：",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="",
        prefix="[gMASK]sop",
    )
)


def _llama3_clone(name: str, default_system: str = "") -> None:
    """llama3 header-token families (reference marks these 'copied from
    llama3 template'): mllama, llava_next_llama3, openchat-3.6 role
    variants."""
    register_template(
        Template(
            name=name,
            system_prefix=(
                "<|start_header_id|>system<|end_header_id|>\n\n{content}"
            ),
            user_prefix="<|start_header_id|>user<|end_header_id|>\n\n{content}",
            assistant_prefix=(
                "<|start_header_id|>assistant<|end_header_id|>\n\n"
            ),
            turn_suffix="<|eot_id|>",
            prefix="<|begin_of_text|>",
            default_system=default_system,
            stop_words=("<|eot_id|>", "<|eom_id|>"),
        )
    )


# reference template.py:973 (mllama) / :1037 (llava_next_llama3)
_llama3_clone("mllama")
_llama3_clone("llava_next_llama3")

# reference template.py:1240 (openchat-3.6: llama3 headers, GPT4 role names)
register_template(
    Template(
        name="openchat-3.6",
        system_prefix="{content}",
        system_suffix="",
        user_prefix=(
            "<|start_header_id|>GPT4 Correct User<|end_header_id|>\n\n"
            "{content}<|eot_id|>"
        ),
        user_suffix="",
        assistant_prefix=(
            "<|start_header_id|>GPT4 Correct Assistant<|end_header_id|>\n\n"
        ),
        turn_suffix="<|eot_id|>",
        prefix="<|begin_of_text|>",
        stop_words=("<|eot_id|>",),
    )
)


def _mistral_clone(name: str, spaced: bool) -> None:
    """[INST] families: spaced=True is the mistral-v3 spacing, False the
    tekken (ministral/pixtral) spacing; system inlines into the first user
    turn (Llama2Template semantics)."""
    register_template(
        Template(
            name=name,
            system_prefix="{content}\n\n",
            system_inline=True,
            user_prefix="[INST] {content}[/INST]" if spaced
            else "[INST]{content}[/INST]",
            user_suffix="",
            assistant_prefix=" " if spaced else "",
            turn_suffix="</s>",
            prefix="<s>",
        )
    )


# reference template.py:1189 (ministral) / :1330 (pixtral) /
# :1327 (llava_next_mistral) / :1120 (llava_next_video_mistral)
_mistral_clone("ministral", spaced=False)
_mistral_clone("pixtral", spaced=False)
_mistral_clone("llava_next_mistral", spaced=True)
_mistral_clone("llava_next_video_mistral", spaced=True)

# reference template.py:1343 (llava_next_qwen) / :1361 (llava_next_yi) /
# :1127 (llava_next_video_yi) / :1160 (qwen2_audio) — chatml families
_chatml_clone("llava_next_qwen", default_system="You are a helpful assistant.")
_chatml_clone("llava_next_yi")
_chatml_clone("llava_next_video_yi")
_chatml_clone("qwen2_audio", default_system="You are a helpful assistant.")

# reference template.py:1097 (llava_next_video) / :1478 (video_llava) —
# vicuna chat format
for _name in ("llava_next_video", "video_llava"):
    register_template(
        Template(
            name=_name,
            system_prefix="{content} ",
            system_suffix="",
            user_prefix="USER: {content} ",
            user_suffix="",
            assistant_prefix="ASSISTANT:",
            turn_suffix="</s>",
            default_system=_VICUNA_SYSTEM,
        )
    )

# reference template.py:1275 (paligemma: bare completion + bos) /
# :1283 (paligemma_chat: gemma turn format)
register_template(
    Template(
        name="paligemma",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="{content}\n",
        user_suffix="",
        assistant_prefix="",
        turn_suffix="",
        prefix="<bos>",
    )
)
register_template(
    Template(
        name="paligemma_chat",
        system_prefix="{content}",
        system_suffix="\n\n",
        user_prefix="<start_of_turn>user\n{content}",
        user_suffix="<end_of_turn>\n",
        assistant_prefix="<start_of_turn>model\n",
        turn_suffix="<end_of_turn>\n",
        prefix="<bos>",
        stop_words=("<end_of_turn>",),
    )
)

# reference template.py:1307 (phi_small: phi-3 turns + endoftext prefix)
register_template(
    Template(
        name="phi_small",
        system_prefix="<|system|>\n{content}",
        user_prefix="<|user|>\n{content}",
        assistant_prefix="<|assistant|>\n",
        turn_suffix="<|end|>\n",
        prefix="<|endoftext|>",
        stop_words=("<|end|>",),
    )
)

# reference template.py:1489 (xuanyuan)
register_template(
    Template(
        name="xuanyuan",
        system_prefix="{content}",
        system_suffix="",
        user_prefix="Human: {content} ",
        user_suffix="",
        assistant_prefix="Assistant:",
        turn_suffix="</s>",
        default_system=(
            "以下是用户和人工智能助手之间的对话。用户以Human开头，人工智能助手以Assistant开头，"
            "会对人类提出的问题给出有帮助、高质量、详细和礼貌的回答，并且总是拒绝参与与不道德、"
            "不安全、有争议、政治敏感等相关的话题、问题和指示。\n"
        ),
    )
)
