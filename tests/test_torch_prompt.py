"""The port's chat templates without jinja2 (analogs of tests/test_prompt.py):
every template renders to the text jlama_tpu's jinja2 environment renders,
or raises where it raises, on the repo's templates, on templates written as
the published chat templates of Llama 2, Llama 3.1, Qwen 2 and Gemma are,
on the one chip_smoke.py serves with on the card, and on templates generated from the supported constructs; a construct
outside the subset raises TemplateError."""

import json

import pytest
from hypothesis import given, settings, strategies as st

from jlama_tpu import prompt as jp
from jlama_tpu.tokenizers.model import TokenizerSpec as JaxSpec
from jlama_tpu_torch import prompt as tp
from jlama_tpu_torch.tokenizers.model import TokenizerSpec

from chip_smoke import FRONT_TEMPLATE
from tests.helpers import CHAT_TEMPLATE

LLAMA3_TEMPLATE = (
    "{{ bos_token }}"
    "{% for message in messages %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
)
TOOL_TEMPLATE = (
    "{% if tools %}Tools: {{ tools | tojson }}\n{% endif %}"
    "{% for m in messages %}[{{ m.role }}] {{ m.content }}\n{% endfor %}"
)
LLAMA2_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}{% else %}"
    "{% set loop_messages = messages %}{% set system_message = false %}{% endif %}"
    "{% for message in loop_messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if loop.index0 == 0 and system_message != false %}"
    "{% set content = '<<SYS>>\\n' + system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}"
    "{% else %}{% set content = message['content'] %}{% endif %}"
    "{% if message['role'] == 'user' %}{{ bos_token + '[INST] ' + content.strip() + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ ' '  + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}"
)
GEMMA_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if (message['role'] == 'assistant') %}{% set role = 'model' %}{% else %}"
    "{% set role = message['role'] %}{% endif %}"
    "{{ '<start_of_turn>' + role + '\n' + message['content'] | trim + '<end_of_turn>\n' }}"
    "{% endfor %}{% if add_generation_prompt %}{{'<start_of_turn>model\n'}}{% endif %}"
)
QWEN2_TEMPLATE = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""
LLAMA31_TEMPLATE = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = strftime_now("%d %b %Y") %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions." }}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
        {{- '{"name": "' + tool_call.name + '", ' }}
        {{- '"parameters": ' }}
        {{- tool_call.arguments | tojson }}
        {{- "}" }}
        {{- "<|eot_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""
TEMPLATES = {"tiny_chat": CHAT_TEMPLATE, "llama3": LLAMA3_TEMPLATE, "tool": TOOL_TEMPLATE,
             "llama2": LLAMA2_TEMPLATE, "gemma": GEMMA_TEMPLATE, "qwen2": QWEN2_TEMPLATE,
             "llama31": LLAMA31_TEMPLATE, "chip_smoke": FRONT_TEMPLATE}
TOOL = {"type": "function", "function": {"name": "get_weather", "description": "Get weather",
                                         "parameters": {"type": "object", "properties": {
                                             "city": {"type": "string"}},
                                             "required": ["city"]}}}
CALL = {"id": "123456789", "type": "function",
        "function": {"name": "get_weather", "arguments": '{"city": "Paris"}'}}
CONVERSATIONS = {
    "user": [{"role": "user", "content": "Hi!"}],
    "system_user": [{"role": "system", "content": "Be brief.  "},
                    {"role": "user", "content": "  Hi!\n"}],
    "turns": [{"role": "system", "content": "S"}, {"role": "user", "content": "a"},
              {"role": "assistant", "content": " b "}, {"role": "user", "content": "c"}],
    "tools": [{"role": "system", "content": "S"}, {"role": "user", "content": "Weather?"},
              {"role": "assistant", "content": "", "tool_calls": [CALL]},
              {"role": "tool", "content": '{"result": "sunny"}', "name": "get_weather"},
              {"role": "user", "content": "Thanks"}],
    "not_alternating": [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}],
    "empty": [],
}


def _both(template, messages, **kw):
    """(jlama_tpu's text or its exception type, the port's)."""
    out = []
    for mod in (jp, tp):
        try:
            out.append(mod.render_chat_template(template, messages, **kw))
        except Exception as e:  # noqa: BLE001 — compared between the two
            out.append(e)
    return out


@pytest.mark.parametrize("conv", sorted(CONVERSATIONS))
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_templates_render_as_jinja2(name, conv):
    for tools in (None, [TOOL]):
        for gen in (True, False):
            want, got = _both(TEMPLATES[name], CONVERSATIONS[conv], tools=tools,
                              add_generation_prompt=gen, bos_token="<s>", eos_token="</s>",
                              extra={"date_string": "26 Jul 2024"})
            if isinstance(want, Exception):
                assert isinstance(got, Exception), (name, conv, want, got)
                if isinstance(want, jp.TemplateError):  # raise_exception's message
                    assert isinstance(got, tp.TemplateError) and str(got) == str(want)
            else:
                assert got == want, (name, conv, tools, gen)


def test_render_llama3_style():
    out = tp.render_chat_template(
        LLAMA3_TEMPLATE,
        [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi!"}],
        bos_token="<|begin_of_text|>")
    assert out == (
        "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        "Be brief.<|eot_id|><|start_header_id|>user<|end_header_id|>\n\nHi!<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    )


def _spec(cls, template):
    s = cls(model_type="BPE", vocab={})
    s.chat_template = template
    s.bos_token = "<s>"
    s.eos_token = "</s>"
    return s


def test_prompt_builder_with_tools():
    ctxs = []
    for mod, spec in ((jp, JaxSpec), (tp, TokenizerSpec)):
        tool = mod.Tool.from_function(mod.Function(
            name="get_weather", description="Get the weather",
            parameters=mod.Parameters().add_property("city", "string", "City name")))
        ctxs.append(mod.PromptBuilder(_spec(spec, TOOL_TEMPLATE))
                    .add_system("sys").add_user("What's the weather in Paris?")
                    .add_tool_call(mod.ToolCall("get_weather", {"city": "Paris"}, "000000001"))
                    .add_tool_result(mod.ToolResult("sunny", "get_weather", "000000001"))
                    .add_tools(tool).build())
    want, got = ctxs
    assert got.prompt == want.prompt and got.has_tools
    assert "get_weather" in got.prompt
    parsed = json.loads(got.prompt.split("Tools: ")[1].split("\n")[0])
    assert parsed[0]["function"]["parameters"]["required"] == ["city"]


def test_prompt_builder_no_template_degrades():
    want = jp.PromptBuilder(None).add_system("sys").add_user("hello").build()
    got = tp.PromptBuilder(None).add_system("sys").add_user("hello").build()
    assert got.prompt == want.prompt and got.prompt.endswith("assistant: ")


def test_extract_tool_calls_dedupes():
    text = (
        'Sure: {"name": "lookup", "parameters": {"q": "x"}} and again '
        '{"name": "lookup", "parameters": {"q": "x"}} plus '
        '{"name": "lookup", "parameters": {"q": "y"}} '
        '{"name": "unknown_tool", "parameters": {}}'
    )
    got = tp.extract_tool_calls(text, [tp.Tool.from_function(tp.Function(name="lookup"))])
    want = jp.extract_tool_calls(text, [jp.Tool.from_function(jp.Function(name="lookup"))])
    assert [(c.name, c.parameters) for c in got] == [(c.name, c.parameters) for c in want]
    assert len(got) == 2 and all(len(c.id) == 9 for c in got)


def test_extract_nested_function_format():
    text = '{"function": {"name": "calc", "arguments": "{\\"a\\": 1}"}}'
    calls = tp.extract_tool_calls(text, [tp.Tool.from_function(tp.Function(name="calc"))])
    assert len(calls) == 1 and calls[0].parameters == {"a": 1}


def test_chat_loop_controls_and_exception():
    template = ("{% for m in messages %}{% if m.role == 'skip' %}{% continue %}{% endif %}"
                "{{ m.content }}{% endfor %}")
    msgs = [{"role": "skip", "content": "no"}, {"role": "user", "content": "yes"}]
    assert tp.render_chat_template(template, msgs) == \
        jp.render_chat_template(template, msgs) == "yes"
    with pytest.raises(tp.TemplateError, match="boom"):
        tp.render_chat_template("{{ raise_exception('boom') }}", msgs)


def test_strftime_now_and_tojson_indent():
    msgs = [{"role": "user", "content": "é"}]
    for t in ("{{ strftime_now('%Y') }}", "{{ messages | tojson(indent=2) }}",
              "{{ messages | tojson }}"):
        want, got = _both(t, msgs)
        assert got == want


@pytest.mark.parametrize("template", [
    "{% macro f() %}x{% endmacro %}", "{% raw %}x{% endraw %}", "{% set x %}a{% endset %}",
    "{% for m in messages recursive %}{% endfor %}", "{% include 'x' %}",
    "{% generation %}x{% endgeneration %}", "{{ x | wordcount }}", "{{ x is divisibleby 3 }}",
    "{{ lipsum() }}", "{% for m in messages %}{{ loop.changed(m) }}{% endfor %}",
    "{% break %}", "{{ f(*args) }}", "{% with %}{% endwith %}", "{% filter upper %}{% endfilter %}",
])
def test_unsupported_constructs_raise(template):
    with pytest.raises(tp.TemplateError):
        tp.render_chat_template(template, [{"role": "user", "content": "x"}])


# ---------------------------------------------------------------------------
# templates generated from the supported constructs, held against jinja2

OPEN = ["{%", "{%-", "{%+"]
CLOSE = ["%}", "-%}", "+%}"]
EXPRS = ["m.role", "m['content']", "m.content | trim", "loop.index", "loop.index0", "loop.first",
         "loop.last", "loop.length", "loop.revindex", "x", "ns.n", "'<' ~ m.role ~ '>'",
         "messages | length", "bos_token", "tools | tojson", "m.missing", "nope",
         "m.role == 'user'", "m.content + '!'", "(loop.index0 % 2 == 0)",
         "'a' if loop.last else 'b'", "m.content | length > 3", "nope is defined",
         "m is mapping", "x is none", "ns.n + 1", "messages[1:] | length", "messages[-1].role",
         "m.content.strip()", "m.nope.deeper", "'q\\n' * 2", "[1, 'a', none]", "{'k': x}",
         "m.role in ['user', 'system']", "not m.content", "m.content | upper",
         "nope | default('d')", "tools is none", "x ~ nope", "m['role'] ~ ':' ~ loop.index",
         "messages | first", "messages | last", "messages | list | length", "m.role | string",
         "messages | count", "['a', m.role] | join(',')", "m.role | lower", "x | default('d')",
         "loop.previtem", "loop.nextitem", "loop.cycle('a', 'b')", "loop.depth",
         "loop.revindex0", "loop.index * 2 - 1", "loop.length / 2", "loop.index // 2",
         "2 ** loop.index", "-loop.index", "(1, m.role)", "range(3) | list", "dict(a=1)",
         "messages[1:][0].role", "y", "x is true", "nope is undefined", "m.content[:3]"]
CONDS = ["m.role == 'user'", "loop.first", "loop.last", "x", "not x", "nope is defined",
         "m.content is string", "add_generation_prompt", "tools", "ns.n > 1",
         "m.role in ['user', 'system']", "'i' in m.content", "x and not loop.last",
         "m.role != 'system' or x", "nope", "loop.index is number", "nope is iterable",
         "m.content is sequence", "m is iterable", "x is sequence"]
TEXT = st.text(alphabet=" \t\nab", max_size=5)


def _tag(draw, body):
    return f"{draw(st.sampled_from(OPEN))} {body} {draw(st.sampled_from(CLOSE))}"


@st.composite
def _block(draw, depth=0, in_loop=False):
    kinds = ["text", "out", "set", "ns"] + (["if", "for"] if depth < 3 else []) + \
        (["ctl"] if in_loop else [])
    kind = draw(st.sampled_from(kinds))
    if kind == "text":
        return draw(TEXT)
    if kind == "out":
        o = draw(st.sampled_from(["{{", "{{-"]))
        c = draw(st.sampled_from(["}}", "-}}"]))
        return f"{o} {draw(st.sampled_from(EXPRS))} {c}"
    if kind == "set":
        if draw(st.booleans()):
            return _tag(draw, f"set x, y = {draw(st.sampled_from(EXPRS))}, loop is defined")
        return _tag(draw, f"set {draw(st.sampled_from(['x', 'y']))} = "
                          f"{draw(st.sampled_from(EXPRS))}")
    if kind == "ns":
        return _tag(draw, "set ns.n = ns.n + 1")
    if kind == "ctl":
        return _tag(draw, f"if {draw(st.sampled_from(CONDS))}") + \
            _tag(draw, draw(st.sampled_from(["break", "continue"]))) + _tag(draw, "endif")

    def body(loop):
        n = draw(st.integers(0, 3))
        return draw(TEXT) + "".join(draw(_block(depth + 1, loop)) + draw(TEXT)
                                    for _ in range(n))
    if kind == "if":
        out = _tag(draw, f"if {draw(st.sampled_from(CONDS))}") + body(in_loop)
        for _ in range(draw(st.integers(0, 2))):
            out += _tag(draw, f"elif {draw(st.sampled_from(CONDS))}") + body(in_loop)
        if draw(st.booleans()):
            out += _tag(draw, "else") + body(in_loop)
        return out + _tag(draw, "endif")
    head = "for m in messages" + draw(st.sampled_from(["", " if m.role != 'system'"]))
    out = _tag(draw, head) + body(True)
    if draw(st.booleans()):
        out += _tag(draw, "else") + body(False)
    return out + _tag(draw, "endfor")


@st.composite
def _template(draw):
    pieces = [draw(_block()) for _ in range(draw(st.integers(1, 4)))]
    return draw(TEXT) + "{% set ns = namespace(n=0) %}" + "\n".join(pieces) + draw(
        st.sampled_from(["", "\n", "\n\n"]))


@settings(max_examples=400, deadline=None)
@given(_template(), st.booleans(), st.sampled_from(["turns", "system_user", "empty"]))
def test_generated_templates_render_as_jinja2(template, with_tools, conv):
    want, got = _both(template, CONVERSATIONS[conv], tools=[TOOL] if with_tools else None,
                      bos_token="<s>", extra={"x": "X"})
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (template, want, got)
    else:
        assert got == want, template
